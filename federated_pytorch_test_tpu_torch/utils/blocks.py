"""Blockwise parameter partitions as leaf masks.

Mirror of ``federated_pytorch_test_tpu/utils/blocks.py``: a training block
is the inclusive index range ``[low, high]`` of a model's
``param_order()``, realised as a nested dict of Python bools.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

from federated_pytorch_test_tpu_torch.utils.tree import set_by_path, tree_map


def block_paths(order: Sequence[str], block_ids: Sequence[int]) -> Tuple[str, ...]:
    """Paths of the leaves in the inclusive index range ``block_ids``."""
    low, high = block_ids
    return tuple(order[low: high + 1])


def build_mask(params: Mapping[str, Any], active_paths: Sequence[str]) -> dict:
    """A nested dict of bools matching ``params``: True iff the leaf trains."""
    mask = tree_map(lambda _: False, params)
    for path in active_paths:
        mask = set_by_path(mask, path, True)
    return mask
