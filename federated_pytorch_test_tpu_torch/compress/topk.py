"""Top-k magnitude sparsification with fixed-shape payloads.

Port of ``federated_pytorch_test_tpu/compress/topk.py``: keep the ``k``
largest-|v| coordinates of each client's flat block delta, ``k`` a function
of ``(frac, n)`` only, so the ``{"idx": int32 [K, k], "val": f32 [K, k]}``
payload has fixed shapes.  Biased (it drops mass every round): pair it with
``ErrorFeedback``, which carries the dropped residual into the next round.

The decode and the sparse sums add ``val`` onto zeros, as the JAX
package's ``.at[idx].add``: an index appears once in a client's row, so a
row's scatter is exact; rows that share an index are added in client order
(:func:`accumulate_rows`), the order in which the JAX scatter applies its
updates, so the sum is deterministic on the card too.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from federated_pytorch_test_tpu_torch.compress.base import Compressor
from federated_pytorch_test_tpu_torch.ops.topk_select import top_k_abs_indices


def accumulate_rows(acc: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """``acc[idx[r]] += val[r]`` for each row ``r`` of the ``[R, k]``
    payload in turn, in place on ``acc`` ``[n]``.  One ``index_add_`` a row:
    its indices are distinct, so no launch races with itself, and the
    float sum over rows runs in row order."""
    for i, v in zip(idx, val):
        acc.index_add_(0, i.long(), v)
    return acc


class TopK(Compressor):
    sparse = True
    name = "topk"

    def __init__(self, frac: float = 0.01):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac={frac} must be in (0, 1]")
        self.frac = frac

    def k_for(self, n: int) -> int:
        # Python's round: half to even, as the JAX package's
        return max(1, min(n, int(round(self.frac * n))))

    def encode(self, vecs: torch.Tensor, state) -> Tuple[Any, Any]:
        idx = top_k_abs_indices(vecs, self.k_for(vecs.shape[-1]))
        return {"idx": idx, "val": torch.gather(vecs, -1, idx.long())}, state

    def decode(self, payload, n: int) -> torch.Tensor:
        val = payload["val"]
        out = torch.zeros(val.shape[:-1] + (n,), dtype=val.dtype,
                          device=val.device)
        return out.scatter_add_(-1, payload["idx"].long(), val)

    def bytes_on_wire(self, n: int) -> int:
        return 8 * self.k_for(n)                 # int32 index + f32 value
