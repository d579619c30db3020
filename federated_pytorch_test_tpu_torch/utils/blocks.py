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


def layer_paths(order: Sequence[str], layer_id: int) -> Tuple[str, ...]:
    """Paths of layer ``layer_id``: indices ``2*layer_id`` and
    ``2*layer_id + 1`` of ``order`` (reference ``unfreeze_one_layer``,
    simple_utils.py:16-22: a layer is a (weight, bias) pair)."""
    return tuple(order[i] for i in (2 * layer_id, 2 * layer_id + 1)
                 if i < len(order))


def build_mask(params: Mapping[str, Any], active_paths: Sequence[str]) -> dict:
    """A nested dict of bools matching ``params``: True iff the leaf trains."""
    mask = tree_map(lambda _: False, params)
    for path in active_paths:
        mask = set_by_path(mask, path, True)
    return mask
