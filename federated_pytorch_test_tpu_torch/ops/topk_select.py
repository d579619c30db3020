"""Top-|v| selection for the sparse comm path.

Port of ``federated_pytorch_test_tpu/ops/topk_select.py``: the indices of
the ``k`` largest ``|v|`` of each row, sorted by descending magnitude, ties
broken toward the lower index.  ``torch.topk`` promises no order among
ties (on the CPU or on CUDA), so the selection is a stable descending sort
of ``|v|`` cut to its first ``k``: a stable sort keeps equal magnitudes in
index order.  The JAX package's chunked two-stage selection exists only to
tile the TPU's sort and returns the same indices as its single-shot path,
so the semantics are implemented once.
"""

from __future__ import annotations

import torch


def top_k_abs_indices(vec: torch.Tensor, k: int) -> torch.Tensor:
    """int32 indices of the ``k`` largest ``|vec|`` along the last axis
    (``[n]`` or a ``[K, n]`` stack of rows), by descending magnitude, ties
    toward the lower index."""
    n = vec.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    order = torch.sort(vec.abs(), dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)
