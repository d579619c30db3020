"""Compressor interface for lossy federated-update communication.

Port of ``federated_pytorch_test_tpu/compress/base.py``.  The server
reconstructs ``x̂_k = z + decode(encode(x_k - z))`` and runs the unchanged
global update on the reconstructions.  Where the JAX package writes the
codec for one client and ``vmap``\\ s it, the port writes the client
dimension out: every method takes the ``[K, ...]`` stack of the clients.

Contract (all implementations):

- ``encode(vecs, state) -> (payload, state)`` — ``vecs`` the float32
  ``[K, n]`` update deltas; ``payload`` a dict of ``[K, ...]`` tensors whose
  shapes depend only on ``n``; ``state`` the stacked per-client state.
- ``decode(payload, n) -> [K, n]`` — the dense float32 reconstructions.
- ``init_state(n, seeds, device) -> dict | None`` — fresh state of the
  clients whose stream seeds are ``seeds`` (numpy ``[K]`` integers).
- ``bytes_on_wire(n) -> int`` — exact payload bytes one client ships per
  round.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

#: CLI surface — ``drivers/common.py`` takes ``--compress``'s choices from
#: this, so the flag and the factory cannot drift
COMPRESS_CHOICES = ("none", "q8", "q4", "topk")


class Compressor:
    """Identity compressor — the dense path.  Base class for the rest.  The
    engine never routes ``--compress none`` through encode/decode."""

    name: str = "none"
    #: sparse payloads ({idx, val}) take the gather-then-scatter reduction
    sparse: bool = False

    def init_state(self, n: int, seeds: np.ndarray, device) -> Optional[Any]:
        return None

    def encode(self, vecs: torch.Tensor, state) -> Tuple[Any, Any]:
        return vecs, state

    def decode(self, payload, n: int) -> torch.Tensor:
        return payload

    def transport_params(self) -> Optional[Tuple[int, int]]:
        """``(bits, chunk)`` when the payload is chunk-scaled integers on a
        fixed grid that the fused collective can re-quantize hop to hop
        (``ops/packed_reduce.py``), else ``None``."""
        return None

    def reset_state(self, state):
        """Drop carried update memory (the error-feedback residual), keep
        the stream state.  Memoryless compressors return ``state``."""
        return state

    def bytes_on_wire(self, n: int) -> int:
        return 4 * n                       # dense float32


def make_compressor(name: str, *, topk_frac: float = 0.01,
                    quant_chunk: int = 256,
                    error_feedback: bool = False) -> Compressor:
    """Factory behind ``--compress {none,q8,q4,topk}``."""
    from federated_pytorch_test_tpu_torch.compress.error_feedback import (
        ErrorFeedback,
    )
    from federated_pytorch_test_tpu_torch.compress.quantize import (
        StochasticQuantizer,
    )
    from federated_pytorch_test_tpu_torch.compress.topk import TopK

    if name not in COMPRESS_CHOICES:
        raise ValueError(
            f"unknown compressor {name!r}; expected one of {COMPRESS_CHOICES}")
    if name == "none":
        if error_feedback:
            raise ValueError(
                "error_feedback requires a lossy compressor "
                "(--compress q8/q4/topk); the dense path has no residual")
        return Compressor()
    inner = (TopK(frac=topk_frac) if name == "topk" else
             StochasticQuantizer(bits=8 if name == "q8" else 4,
                                 chunk=quant_chunk))
    return ErrorFeedback(inner) if error_feedback else inner


def stacked_init(comp: Compressor, K: int, n: int, seed: int, device):
    """Fresh ``[K]``-stacked state of all clients (or ``None``).  The
    clients' stream seeds are drawn from one numpy generator seeded with
    ``seed``: a run that re-enters a block draws the same streams."""
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=K)
    return comp.init_state(n, seeds, device)
