"""Stochastic uniform quantization to int8 / int4 with per-chunk scales.

Port of ``federated_pytorch_test_tpu/compress/quantize.py``.  Each client's
flat delta is cut into ``chunk``-sized pieces, each scaled by its own
max-abs and rounded stochastically, ``floor(v / safe + U)`` with ``U``
uniform on [0, 1), which makes the quantizer unbiased.  int4 payloads are
nibble-packed two to a byte.

Random draws.  The JAX package splits a per-client ``jax.random`` key every
round.  Here the state holds, per client, a stream seed and a draw counter
(int64 CPU tensors, so a resume can save them and partial participation
can select rows); the draw of round ``count`` comes from a torch generator
on the run's device seeded from ``(seed, count)``.  :attr:`StochasticQuantizer.uniform`
makes the draw and can be replaced, so that a test hands the JAX package's
draws to :meth:`StochasticQuantizer.encode`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.compress.base import Compressor


def torch_uniform(seed: int, count: int, shape: Sequence[int],
                  device) -> torch.Tensor:
    """Draw ``count`` of the stream ``seed``: float32 uniform on [0, 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, count])
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.rand(tuple(shape), generator=g, device=device)


def fold_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] -> uint8 bytes, two to a byte along the last
    dimension (the even element in the high nibble)."""
    nib = (q + 8).to(torch.uint8)                         # [1, 15]
    return (nib[..., 0::2] << 4) | nib[..., 1::2]


def unfold_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fold_nibbles`: uint8 bytes -> int8 values."""
    hi = (q >> 4).to(torch.int8) - 8
    lo = (q & 0xF).to(torch.int8) - 8
    return torch.stack([hi, lo], dim=-1).reshape(*q.shape[:-1], -1)


class StochasticQuantizer(Compressor):
    def __init__(self, bits: int = 8, chunk: int = 256):
        if bits not in (4, 8):
            raise ValueError(f"bits={bits}; int8 and int4 only")
        if chunk < 2 or chunk % 2:
            raise ValueError(f"quant chunk={chunk} must be even and >= 2 "
                             "(int4 packs value pairs)")
        self.bits = bits
        self.chunk = chunk
        self.qmax = 2 ** (bits - 1) - 1          # 127 / 7, symmetric grid
        self.name = f"q{bits}"
        #: the draw ``(seed, count, shape, device) -> U`` of one client
        self.uniform: Callable[..., torch.Tensor] = torch_uniform

    def _chunks(self, n: int) -> int:
        return -(-n // self.chunk)

    def init_state(self, n: int, seeds: np.ndarray, device):
        seeds = torch.as_tensor(np.asarray(seeds, np.int64))
        return {"seed": seeds, "count": torch.zeros_like(seeds)}

    def encode(self, vecs: torch.Tensor, state) -> Tuple[Any, Any]:
        K, n = vecs.shape
        c = self._chunks(n)
        v = torch.nn.functional.pad(vecs, (0, c * self.chunk - n)).reshape(
            K, c, self.chunk)
        qm = torch.full((), float(self.qmax), dtype=v.dtype, device=v.device)
        scale = v.abs().amax(dim=2) / qm
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        u = torch.stack([
            self.uniform(int(s), int(t), (c, self.chunk), v.device)
            for s, t in zip(state["seed"].tolist(), state["count"].tolist())])
        q = torch.clamp(torch.floor(v / safe[..., None] + u),
                        -self.qmax, self.qmax).to(torch.int8)
        if self.bits == 4:
            q = fold_nibbles(q)
        return ({"q": q, "scale": safe},
                {"seed": state["seed"], "count": state["count"] + 1})

    def decode(self, payload, n: int) -> torch.Tensor:
        q = payload["q"]
        if self.bits == 4:
            q = unfold_nibbles(q)
        v = q.to(torch.float32) * payload["scale"][..., None]
        return v.reshape(v.shape[0], -1)[:, :n]

    def transport_params(self):
        # the payload grid (per-chunk max-abs scale, symmetric +/-qmax
        # integers) is what the fused collective's hop codec speaks
        return self.bits, self.chunk

    def bytes_on_wire(self, n: int) -> int:
        c = self._chunks(n)
        return c * self.chunk * self.bits // 8 + 4 * c
