"""The fused quantized collective: payloads stay packed across the wire.

Port of the dense part of ``federated_pytorch_test_tpu/ops/packed_reduce.py``
(``--compress q8|q4 --fused-collective``).  The mean over clients runs as a
quantized allreduce over the client mesh:

- power-of-2 D: a recursive-halving (butterfly) reduce-scatter, each of the
  ``log2(D)`` steps sending a packed half-buffer (int8 or nibble-packed int4
  plus one float32 scale per chunk) instead of dense float32;
- other D: a ``D-1``-step quantized ring reduce-scatter;
- then each device divides its owned segment, packs it once more, and the
  packed segments are all-gathered and decoded.

The devices are the logical shards of :class:`ClientMesh`: each step runs
the D per-device programs in index order, so the arithmetic is that of the
JAX program at that D, hop by hop.  Every hop quantizes with
:func:`~federated_pytorch_test_tpu_torch.ops.quant.quantize_chunks` (kernel
B1) and accumulates with
:func:`~federated_pytorch_test_tpu_torch.ops.quant.dequant_add` (kernel B2)
in place on the device's buffer;
``impl=quant.PLAIN`` runs the plain versions instead, for comparison.  The
transport is deterministic round-to-nearest, so a fused round is
replayable.

Sparse (top-k) payloads take :func:`make_sparse_fused_mean` instead: the
``{idx, val}`` payloads are all-gathered as they are and scatter-added into
one accumulator in client order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from federated_pytorch_test_tpu_torch.compress.quantize import (
    fold_nibbles,
    unfold_nibbles,
)
from federated_pytorch_test_tpu_torch.compress.topk import accumulate_rows
from federated_pytorch_test_tpu_torch.ops.quant import KERNELS, QuantImpl
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh


def transport_params(compressor) -> Optional[Tuple[int, int]]:
    """``(bits, chunk)`` of the wire codec matching ``compressor``, or
    ``None`` when it has no dense quantized transport."""
    tp = compressor.transport_params()
    return None if tp is None else (int(tp[0]), int(tp[1]))


def pack_chunks(v: torch.Tensor, chunk: int, bits: int,
                impl: QuantImpl = KERNELS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic per-chunk transport encode of ``v`` (``[m]`` float32,
    ``m % chunk == 0``): ``(q, scale)``, scale = max|chunk| / qmax, int4
    payloads nibble-packed two to a byte.  Scale and round/clip are one
    kernel launch (B1)."""
    qmax = 2 ** (bits - 1) - 1
    q, scale = impl.quantize(v.reshape(-1, chunk), qmax)
    if bits == 4:
        q = fold_nibbles(q)
    return q, scale


def _unfold_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Nibble-unfold q4 payload rows back to int8 rows (q8: unchanged)."""
    return unfold_nibbles(q) if bits == 4 else q


def unpack_chunks(q: torch.Tensor, scale: torch.Tensor, chunk: int,
                  bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_chunks` -> flat ``[c*chunk]`` float32."""
    q = _unfold_rows(q, bits)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (q.to(torch.float32) * safe[:, None]).reshape(-1)


def _hop_accumulate(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    chunk: int, bits: int, impl: QuantImpl = KERNELS) -> None:
    """The hop's ``acc += decode(q, scale)``, in place on ``acc`` (a
    contiguous slice of a device's buffer) as one dequantize-accumulate
    launch (B2) on ``[c, chunk]`` rows."""
    rows = acc.view(-1, chunk)
    impl.dequant_add(rows, _unfold_rows(q, bits), scale, out=rows)


def _seg_elems(n: int, D: int, chunk: int) -> int:
    """Per-device segment length: N split D ways, rounded up to a whole
    number of codec chunks so per-chunk scales align at every level."""
    return -(-n // (D * chunk)) * chunk


def _butterfly_reduce_scatter(bufs: List[torch.Tensor], mesh: ClientMesh,
                              seg: int, chunk: int, bits: int,
                              impl: QuantImpl) -> List[int]:
    """Recursive-halving reduce-scatter over packed payloads (power-of-2 D),
    in place on the devices' ``bufs``.  Returns each device's ``lo``:
    ``bufs[me][lo:lo+seg]`` is its fully reduced segment (``lo == me*seg``)."""
    D = mesh.size
    lo = [0] * D
    half = D // 2
    while half >= 1:
        width = half * seg
        keep, sends = [], []
        for me in mesh.indices():
            bit = (me & half) > 0                 # my side of this exchange
            keep.append(lo[me] + (width if bit else 0))
            send_lo = lo[me] + (0 if bit else width)
            sends.append(pack_chunks(bufs[me][send_lo: send_lo + width],
                                     chunk, bits, impl))
        recv = mesh.ppermute(sends, [(i, i ^ half) for i in range(D)])
        for me in mesh.indices():
            k = keep[me]
            q, s = recv[me]
            _hop_accumulate(bufs[me][k: k + width], q, s, chunk, bits, impl)
        lo = keep
        half //= 2
    return lo


def _ring_reduce_scatter(bufs: List[torch.Tensor], mesh: ClientMesh, seg: int,
                         chunk: int, bits: int, impl: QuantImpl) -> List[int]:
    """Quantized ring reduce-scatter for non-power-of-2 D: ``D-1`` neighbour
    exchanges, in place on ``bufs``; device ``me`` ends owning segment
    ``(me+1) % D``.  Returns each device's owned offset."""
    D = mesh.size
    perm = [(i, (i + 1) % D) for i in range(D)]
    for t in range(D - 1):
        sends = []
        for me in mesh.indices():
            send_lo = ((me - t) % D) * seg
            sends.append(pack_chunks(bufs[me][send_lo: send_lo + seg], chunk,
                                     bits, impl))
        recv = mesh.ppermute(sends, perm)
        for me in mesh.indices():
            r = ((me - 1 - t) % D) * seg
            q, s = recv[me]
            _hop_accumulate(bufs[me][r: r + seg], q, s, chunk, bits, impl)
    return [((me + 1) % D) * seg for me in mesh.indices()]


def packed_fused_mean(local: Sequence[torch.Tensor], div: torch.Tensor,
                      mesh: ClientMesh, bits: int, chunk: int,
                      impl: QuantImpl = KERNELS) -> torch.Tensor:
    """Quantized allreduce-mean of the devices' partial sums.

    ``local``: one ``[N]`` float32 partial sum per device; ``div``: the
    divisor, a 0-d tensor on the same device (already guarded against
    zero).  The reduce-scatter ships packed payloads, each device divides
    its owned ``[seg]`` segment and packs it once, and the packed segments
    are gathered and decoded.  Every device would decode the same bytes, so
    they are decoded once.
    """
    D = mesh.size
    n = local[0].shape[-1]
    if D == 1:
        return local[0] / div
    seg = _seg_elems(n, D, chunk)
    bufs = [torch.nn.functional.pad(x, (0, D * seg - n)) for x in local]
    if D & (D - 1) == 0:
        lo = _butterfly_reduce_scatter(bufs, mesh, seg, chunk, bits, impl)
    else:
        lo = _ring_reduce_scatter(bufs, mesh, seg, chunk, bits, impl)
    packed = [pack_chunks(bufs[me][lo[me]: lo[me] + seg] / div, chunk, bits,
                          impl) for me in mesh.indices()]
    qs = [q for q, _ in packed]
    ss = [s for _, s in packed]
    if D & (D - 1) == 0:
        # the butterfly leaves device i owning segment i: the tiled gather
        # is already in segment order
        qg, sg = mesh.all_gather(qs), mesh.all_gather(ss)
    else:
        # the ring leaves device i owning segment (i+1) % D: gather untiled
        # and roll one slot so row j holds segment j
        c_seg = seg // chunk
        qg = torch.roll(mesh.all_gather(qs, tiled=False), 1, dims=0)
        sg = torch.roll(mesh.all_gather(ss, tiled=False), 1, dims=0)
        qg = qg.reshape((D * c_seg,) + tuple(qs[0].shape[1:]))
        sg = sg.reshape(D * c_seg)
    return unpack_chunks(qg, sg, chunk, bits)[:n]


def _weighted_local_sum(stack: torch.Tensor, w: Optional[torch.Tensor], K: int,
                        mesh: ClientMesh) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Each device's local numerator and the replicated divisor, as
    ``algorithms._active_mean``: ``sum / K`` when ``w`` is None, else
    ``sum(w*x) / max(psum(sum(w)), 1)`` (an all-excluded round gives 0)."""
    f32 = dict(dtype=torch.float32, device=stack.device)
    if w is None:
        return ([s.sum(dim=0) for s in mesh.shards(stack)],
                torch.full((), float(K), **f32))
    shards, ws = mesh.shards(stack), mesh.shards(w)
    local = [(wd[:, None] * s).sum(dim=0) for s, wd in zip(shards, ws)]
    n_act = mesh.psum([wd.sum() for wd in ws])
    return local, torch.where(n_act > 0, n_act, torch.ones((), **f32))


def make_fused_mean(compressor, mesh: ClientMesh, K: int,
                    impl: QuantImpl = KERNELS) -> Callable:
    """``mean_fn(stack, w)`` for ``Algorithm._agg`` that runs the whole
    aggregation as the quantized fused collective (dense q8/q4 codecs)."""
    tp = transport_params(compressor)
    if tp is None:
        raise ValueError(
            f"fused collective needs a dense quantized codec; "
            f"{compressor.name!r} has no (bits, chunk) transport")
    bits, chunk = tp

    def mean_fn(stack, w=None):
        local, div = _weighted_local_sum(stack, w, K, mesh)
        return packed_fused_mean(local, div, mesh, bits, chunk, impl)

    return mean_fn


def make_sparse_fused_mean(payload, z: torch.Tensor, K: int,
                           mesh: ClientMesh) -> Callable:
    """Per-round ``mean_fn(stack, w)`` for sparse top-k payloads.

    Valid only when the aggregated stack is ``x = z + decode(payload)``
    (FedAvg, FedProx: the engine falls back to the unfused path for
    dual-state algorithms).  The closure ignores ``stack`` and rebuilds the
    mean from the all-gathered ``{idx, val}`` pairs, one scatter-add into a
    dense accumulator in client order.  Excluded rows (``w == 0``) are
    where-selected out, never multiplied by 0, so a NaN payload row of an
    excluded client stays out; an all-excluded round gives zeros.  Every
    device would compute the same sum, so it is computed once.
    """
    idx, val = payload["idx"], payload["val"]
    n = z.shape[0]

    def mean_fn(stack, w=None):
        del stack                              # x is implied by (z, payload)
        ig = mesh.all_gather(mesh.shards(idx))
        vg = mesh.all_gather(mesh.shards(val))
        acc = torch.zeros(n, dtype=vg.dtype, device=vg.device)
        if w is None:
            # a tensor divisor: CUDA divides by a Python number as a
            # multiplication by its reciprocal, which rounds apart from the
            # IEEE division of the CPU and of the JAX package
            div = torch.full((), float(K), dtype=vg.dtype, device=vg.device)
            return z + accumulate_rows(acc, ig, vg) / div
        wg = mesh.all_gather(mesh.shards(w))
        zero = torch.zeros((), dtype=vg.dtype, device=vg.device)
        vw = torch.where(wg[:, None] > 0, vg * wg[:, None], zero)
        accumulate_rows(acc, ig, vw)
        total = wg.sum()
        return torch.where(total > 0,
                           z + acc / torch.where(total > 0, total,
                                                 torch.ones_like(total)),
                           zero)

    return mean_fn


def fused_bytes_on_wire(compressor, n: int, D: int, K: int) -> int:
    """Estimated total wire bytes of one fused aggregation round.  Dense:
    the reduce-scatter moves ``(D-1)*seg`` packed elements per device and
    the all-gather the same again, ``2*D*(D-1)*(seg*bits/8 + 4*seg/chunk)``.
    Sparse: the all-gather sends each client's ``8k``-byte payload to the
    other ``D-1`` devices.  ``D == 1`` moves nothing."""
    if D <= 1:
        return 0
    if compressor.sparse:
        # the top-k codec, behind the error-feedback wrapper if any
        k = getattr(compressor, "inner", compressor).k_for(n)
        return (D - 1) * K * 8 * k
    tp = transport_params(compressor)
    if tp is None:
        return 0
    bits, chunk = tp
    seg = _seg_elems(n, D, chunk)
    per_seg = seg * bits // 8 + 4 * (seg // chunk)
    return 2 * D * (D - 1) * per_seg
