"""Flat-vector codec over masked parameter dicts.

Mirror of ``federated_pytorch_test_tpu/utils/codec.py``.  The port stores
conv kernels in PyTorch's OIHW layout and dense kernels as [out, in], but
the flat vector keeps the JAX element order — HWIO within a conv kernel,
[in, out] within a dense kernel, leaves concatenated in ``param_order()`` —
so a block vector, the consensus ``z`` and the L-BFGS history stay
elementwise comparable with the JAX run.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from federated_pytorch_test_tpu_torch.utils.tree import get_by_path, set_by_path


def to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """View of a PyTorch-layout weight in the JAX layout: a conv kernel
    OIHW -> HWIO, a dense kernel [out, in] -> [in, out]; vectors (biases,
    norm scales) are unchanged."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.dim() == 2 else t


def from_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout` (HWIO -> OIHW, [in, out] ->
    [out, in])."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t.t() if t.dim() == 2 else t


def active_paths_in_order(order: Sequence[str], mask: Mapping[str, Any]) -> list:
    return [p for p in order if get_by_path(mask, p)]


def masked_size(params: Mapping[str, Any], order: Sequence[str], mask) -> int:
    """Number of scalars in the active block (``N`` in the drivers)."""
    return sum(get_by_path(params, p).numel()
               for p in active_paths_in_order(order, mask))


def get_trainable_values(params: Mapping[str, Any], order: Sequence[str],
                         mask) -> torch.Tensor:
    """Flatten the active leaves, in ``order``, into one 1-D vector in the
    JAX element order."""
    chunks = [to_jax_layout(get_by_path(params, p)).reshape(-1)
              for p in active_paths_in_order(order, mask)]
    if not chunks:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(chunks)


def put_trainable_values(params: Mapping[str, Any], order: Sequence[str],
                         mask, vec: torch.Tensor) -> dict:
    """Scatter a flat vector back into the active leaves; returns new params.

    The new leaves are views of ``vec`` (no copy), so autograd flows from a
    loss computed on the returned params back to ``vec``.
    """
    out = dict(params)
    offset = 0
    for p in active_paths_in_order(order, mask):
        leaf = get_by_path(params, p)
        jax_shape = to_jax_layout(leaf).shape
        n = leaf.numel()
        piece = vec[offset: offset + n].reshape(jax_shape)
        out = set_by_path(out, p, from_jax_layout(piece).to(leaf.dtype))
        offset += n
    return out


def get_trainable_stack(params: Mapping[str, Any], order: Sequence[str],
                        mask) -> torch.Tensor:
    """[K, N]: :func:`get_trainable_values` of every client of a stacked
    ([K, ...] leaves) parameter dict."""
    K = get_by_path(params, active_paths_in_order(order, mask)[0]).shape[0]
    return torch.stack([
        torch.cat([to_jax_layout(get_by_path(params, p)[k]).reshape(-1)
                   for p in active_paths_in_order(order, mask)])
        for k in range(K)])


def put_trainable_stack(params: Mapping[str, Any], order: Sequence[str],
                        mask, stack: torch.Tensor) -> dict:
    """Scatter the rows of ``stack`` [K, N] into the active leaves of a
    stacked parameter dict (new contiguous leaves; the rest shared)."""
    out = dict(params)
    offset = 0
    for p in active_paths_in_order(order, mask):
        leaf = get_by_path(params, p)
        K = leaf.shape[0]
        jax_shape = to_jax_layout(leaf[0]).shape
        n = leaf[0].numel()
        rows = stack[:, offset: offset + n].reshape(K, *jax_shape)
        new = torch.stack([from_jax_layout(r) for r in rows]).to(leaf.dtype)
        out = set_by_path(out, p, new.contiguous())
        offset += n
    return out
