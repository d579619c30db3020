"""Path-addressed access into nested parameter dicts of tensors.

Mirror of ``federated_pytorch_test_tpu/utils/tree.py``: a parameter is
named by a ``'/'``-joined path into the nested dict (``"conv2/kernel"``),
and every model publishes its parameter order as a list of such paths.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping

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


def leaves(tree: Any) -> List[Any]:
    """The leaves of a state tree (nested dicts, lists, tuples and
    NamedTuples over tensors and Python numbers) in a fixed order: dict
    keys sorted, sequences in order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten_like(template: Any, values) -> Any:
    """``template`` with its leaves replaced by ``values`` (in the order of
    :func:`leaves`): a tensor value takes the template leaf's device and
    dtype, a Python-number leaf (an L-BFGS counter) its type."""
    it = iter(values)

    def rec(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            out = {k: rec(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[rec(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        v = next(it)
        if isinstance(node, torch.Tensor):
            v = torch.as_tensor(v)
            return v.to(device=node.device, dtype=node.dtype)
        return type(node)(v.item() if isinstance(v, torch.Tensor) else v)

    out = rec(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the corresponding leaves of equally structured trees."""
    return unflatten_like(tree, [fn(*xs) for xs in
                                 zip(leaves(tree), *map(leaves, rest))])
