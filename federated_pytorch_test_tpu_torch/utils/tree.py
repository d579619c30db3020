"""Path-addressed access into nested parameter dicts of tensors.

Mirror of ``federated_pytorch_test_tpu/utils/tree.py``: a parameter is
named by a ``'/'``-joined path into the nested dict (``"conv2/kernel"``),
and every model publishes its parameter order as a list of such paths.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch


def get_by_path(tree: Mapping[str, Any], path: str) -> Any:
    node: Any = tree
    for part in path.split("/"):
        node = node[part]
    return node


def set_by_path(tree: Mapping[str, Any], path: str, value: Any) -> dict:
    """Return a copy of ``tree`` with the leaf at ``path`` replaced."""
    parts = path.split("/")

    def rec(node: Mapping[str, Any], i: int) -> dict:
        out = dict(node)
        if i == len(parts) - 1:
            out[parts[i]] = value
        else:
            out[parts[i]] = rec(node[parts[i]], i + 1)
        return out

    return rec(tree, 0)


def tree_map(fn: Callable[[Any], Any], tree: Mapping[str, Any]) -> dict:
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def tree_stack(trees) -> dict:
    """Stack the leaves of equally shaped nested dicts on a new leading
    dimension (one tree per client -> a [K, ...] tree)."""
    first = trees[0]
    return {k: tree_stack([t[k] for t in trees]) if isinstance(v, Mapping)
            else torch.stack([t[k] for t in trees])
            for k, v in first.items()}
