"""The block vector's wire order and the exchange's codecs, in plain
PyTorch.

A trained block travels as one float32 vector: its leaves in the source's
parameter order, each convolution kernel in HWIO element order and the
linear kernel as [in, out] (the layout of the configuration's wire format,
whose quantization chunks cut that vector into runs of ``chunk`` values).

The codecs: the clients' stochastic quantizer (per-chunk max-abs scale,
``floor(v / scale + U)`` clipped to the symmetric int grid, ``U`` uniform
on [0, 1)), and the packed collective's deterministic transport codec
(the same scale, round half to even).  Every division is by a tensor,
every dequantize a multiply and then an add.

Imports torch only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def to_wire(t: torch.Tensor) -> torch.Tensor:
    """A PyTorch-layout leaf in wire layout (OIHW -> HWIO, [out, in] ->
    [in, out])."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.dim() == 2 else t


def from_wire(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_wire`."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t.t() if t.dim() == 2 else t


def wire_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return (shape[1], shape[0]) if len(shape) == 2 else tuple(shape)


def flatten(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The block vector of ``leaves`` (PyTorch layout, wire order)."""
    return torch.cat([to_wire(t).reshape(-1) for t in leaves])


def unflatten(vec: torch.Tensor, names: Sequence[str],
              shapes: Sequence[Sequence[int]]) -> Dict[str, torch.Tensor]:
    """Named PyTorch-layout views of the block vector ``vec``."""
    out, i = {}, 0
    for name, shape in zip(names, shapes):
        n = 1
        for d in shape:
            n *= d
        out[name] = from_wire(vec[i:i + n].reshape(wire_shape(shape)))
        i += n
    return out


def leaf_sizes(shapes: Sequence[Sequence[int]]) -> List[int]:
    out = []
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(n)
    return out


def _safe(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def stochastic_quantize(u: torch.Tensor, draws: torch.Tensor, qmax: int,
                        chunk: int) -> torch.Tensor:
    """The dense reconstruction [K, n] of the clients' quantized ``u``
    [K, n], with the uniform ``draws`` [K, chunks, chunk]."""
    K, n = u.shape
    c = -(-n // chunk)
    v = torch.nn.functional.pad(u, (0, c * chunk - n)).reshape(K, c, chunk)
    qm = torch.full((), float(qmax), dtype=v.dtype, device=v.device)
    safe = _safe(v.abs().amax(dim=2) / qm)
    q = torch.clamp(torch.floor(v / safe[..., None] + draws), -qmax, qmax)
    return (q * safe[..., None]).reshape(K, -1)[:, :n]


def pack(v: torch.Tensor, qmax: int, chunk: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transport codec of ``v`` [m] (m a multiple of ``chunk``):
    (integer values as float32 [m / chunk, chunk], scales)."""
    rows = v.reshape(-1, chunk)
    qm = torch.full((), float(qmax), dtype=v.dtype, device=v.device)
    scale = rows.abs().amax(dim=1) / qm
    q = torch.clamp(torch.round(rows / _safe(scale)[:, None]), -qmax, qmax)
    return q, scale


def unpack(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q * _safe(scale)[:, None]).reshape(-1)


def packed_mean(partials: Sequence[torch.Tensor], K: int, qmax: int,
                chunk: int) -> torch.Tensor:
    """The mean over clients of the D devices' partial sums, as the packed
    collective computes it: a reduce-scatter whose every hop ships the
    transport codec of a segment and adds its reconstruction (recursive
    halving for a power-of-2 D, else a ring), each device's owned segment
    divided by K and packed once more, and the packed segments gathered
    and reconstructed."""
    D = len(partials)
    n = partials[0].shape[0]
    div = torch.full((), float(K), dtype=partials[0].dtype,
                     device=partials[0].device)
    if D == 1:
        return partials[0] / div
    seg = -(-n // (D * chunk)) * chunk
    bufs = [torch.nn.functional.pad(p, (0, D * seg - n)) for p in partials]

    def add(me: int, lo: int, width: int, sent) -> None:
        q, scale = sent
        acc = bufs[me][lo:lo + width]
        bufs[me][lo:lo + width] = acc + (q * _safe(scale)[:, None]).reshape(-1)

    if D & (D - 1) == 0:
        lo, half = [0] * D, D // 2
        while half >= 1:
            width = half * seg
            keep, sends = [], []
            for me in range(D):
                bit = (me & half) > 0
                keep.append(lo[me] + (width if bit else 0))
                start = lo[me] + (0 if bit else width)
                sends.append(pack(bufs[me][start:start + width], qmax, chunk))
            for me in range(D):
                add(me, keep[me], width, sends[me ^ half])
            lo, half = keep, half // 2
        owned = lo
    else:
        for t in range(D - 1):
            sends = [pack(bufs[me][((me - t) % D) * seg:
                                   ((me - t) % D) * seg + seg], qmax, chunk)
                     for me in range(D)]
            for me in range(D):
                add(me, ((me - 1 - t) % D) * seg, seg, sends[(me - 1) % D])
        owned = [((me + 1) % D) * seg for me in range(D)]
    segments = {o // seg: unpack(*pack(bufs[me][o:o + seg] / div, qmax, chunk))
                for me, o in enumerate(owned)}
    return torch.cat([segments[j] for j in range(D)])[:n]
