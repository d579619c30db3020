"""Client aggregation over a stacked client dimension.

Port of ``federated_pytorch_test_tpu/parallel/comm.py``: the plain FedAvg
mean and the Byzantine-robust estimators behind ``--robust-agg``.  On one
card the K clients are the leading dimension of one tensor; the JAX
package's collectives over the client mesh become the fixed-order tensor
operations of :class:`~federated_pytorch_test_tpu_torch.parallel.mesh.ClientMesh`.

Every estimator here takes the whole ``[K, N]`` client stack (what the JAX
dense path ``all_gather``\\ s onto every device) and returns the ``[N]``
aggregate.  The chunked estimators run the JAX segment-owned program once
per shard: shard d owns the column slab d of the ``all_to_all``, its
per-client partial sums are ``psum``\\ ed over the shards in order, and the
per-shard results are concatenated.  Krum's chunked distance pass calls the
Gram kernel (``ops/gram.py``, kernel B3) once per shard.

The compressed exchange's mean (:func:`compressed_federated_mean`) decodes
dense (q8/q4) payloads before each shard's sum; sparse (top-k) payloads
are scatter-added into one dense accumulator per shard, in client order.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from federated_pytorch_test_tpu_torch.ops.gram import gram
from federated_pytorch_test_tpu_torch.compress.topk import accumulate_rows
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

#: CLI surface — ``drivers/common.py`` derives ``--robust-agg`` from this
ROBUST_AGG_CHOICES = ("none", "trim", "median", "clip", "krum", "geomed")

#: Weiszfeld iterations for kind="geomed" (fixed, as in the JAX package)
GEOMED_ITERS = 16


def federated_sum(stack: torch.Tensor, mesh: Optional[ClientMesh] = None
                  ) -> torch.Tensor:
    """Sum over all clients of [K, ...]: local sums per shard, then psum."""
    return (mesh or ClientMesh(1)).federated_sum(stack)


def federated_mean(stack: torch.Tensor, K: int,
                   mesh: Optional[ClientMesh] = None) -> torch.Tensor:
    """``z = sum_k x_k / K`` over the leading [K, ...] client dimension —
    the FedAvg global update (reference federated_multi.py:208-211)."""
    return federated_sum(stack, mesh) / K


def decode_stack(payloads, compressor, n: int) -> torch.Tensor:
    """Dense reconstructions [K, n] of a client-stacked payload (the
    compressors decode the whole stack at once; top-k scatters each row
    into zeros)."""
    return compressor.decode(payloads, n)


def compressed_federated_mean(payloads, compressor, n: int, K: int,
                              mesh: Optional[ClientMesh] = None,
                              w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over clients of the decoded payloads -> dense [n]: each shard's
    partial sum (``w`` [K] masks clients out of the sum and the divisor),
    then the psum.  Dense payloads are decoded before the sum; sparse
    ``{idx, val}`` payloads are scatter-added into one accumulator per
    shard (the wire stays k-sized, the psum one dense vector)."""
    mesh = mesh or ClientMesh(1)
    if compressor.sparse:
        val = payloads["val"]
        if w is not None:
            val = val * w[:, None]
        total = mesh.psum([
            accumulate_rows(torch.zeros(n, dtype=val.dtype, device=val.device),
                            i, v)
            for i, v in zip(mesh.shards(payloads["idx"]), mesh.shards(val))])
    else:
        d = decode_stack(payloads, compressor, n)
        if w is not None:
            d = d * w[:, None]
        total = mesh.federated_sum(d)
    if w is None:
        return total / K
    return total / mesh.psum([s.sum() for s in mesh.shards(w)])


def _where0(cond: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _nz(d: torch.Tensor) -> torch.Tensor:
    """``where(d > 0, d, 1)`` — the all-rejected round divides by 1."""
    return torch.where(d > 0, d, torch.ones((), dtype=d.dtype, device=d.device))


def _screen(w, K: int, finite: torch.Tensor, like: torch.Tensor):
    """(wg, act, m, wsum): the activity weights with non-finite clients
    folded out, the active mask, the active count and the active weight."""
    wg = (torch.ones(K, dtype=like.dtype, device=like.device) if w is None
          else w.to(like.dtype))
    wg = wg * finite.to(like.dtype)
    act = wg > 0
    return wg, act, act.to(like.dtype).sum(), wg.sum()


def _masked_median(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Median of ``v`` [K] over entries with ``w > 0``."""
    m = w.sum()
    s = torch.sort(torch.where(w > 0, v, torch.full_like(v, float("inf")))).values
    pos = torch.arange(v.shape[0], dtype=v.dtype, device=v.device)
    lo = torch.floor((m - 1.0) / 2.0)
    hi = torch.floor(m / 2.0)
    inc = ((pos == lo) | (pos == hi)) & (pos < m)
    return _where0(inc, s).sum() / torch.clamp(inc.to(v.dtype).sum(), min=1.0)


def _clip_scale(nrm, wg, clip_mult):
    c = clip_mult * _masked_median(nrm, wg)
    return torch.where(nrm > c, c / torch.clamp(nrm, min=1e-30),
                       torch.ones_like(nrm))


def krum_scores(g, act, m, trim_frac):
    """Krum's scores from the Gram matrix ``g`` [K, K] of the screened
    stack: each active client's summed squared distance to its
    ``m - f - 2`` nearest active neighbours (``f = floor(trim_frac * m)``),
    +inf for inactive clients.  Returns (scores [K], f)."""
    K = g.shape[0]
    dt, dev = g.dtype, g.device
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    sq = torch.diagonal(g)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * g, min=0.0)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    d2 = torch.where(eye | ~act[None, :], inf, d2)
    f = torch.floor(trim_frac * m)
    n_nb = torch.clamp(m - f - 2.0, min=1.0)
    posr = torch.arange(K, dtype=dt, device=dev)[None, :]
    ds = torch.sort(d2, dim=1).values
    score = _where0(posr < n_nb, ds).sum(dim=1)
    # m == 1 leaves a lone client with no finite neighbour: clamp its +inf
    # score so the selection below still picks it
    return torch.where(act, torch.clamp(score, max=1e30), inf), f


def krum_select(g, act, m, trim_frac):
    """Krum's selection: the ``m - f`` best-scored active clients (ties to
    the lower index)."""
    score, f = krum_scores(g, act, m, trim_frac)
    idx = torch.arange(g.shape[0], device=g.device)
    better = ((score[None, :] < score[:, None])
              | ((score[None, :] == score[:, None])
                 & (idx[None, :] < idx[:, None])))
    rank = better.to(g.dtype).sum(dim=1)
    return (rank < torch.clamp(m - f, min=1.0)) & act


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (client) dimension, one row after another —
    the order of the JAX package's reduction, so trim stays bitwise."""
    out = t[0]
    for row in t[1:]:
        out = out + row
    return out


def _sorted_window_mean(key, wg, m, kind, trim_frac):
    """trim / median per coordinate of ``key`` [K, n] (inactive rows keyed
    to +inf, so the active values take the first m sorted positions)."""
    K = key.shape[0]
    s, order = torch.sort(key, dim=0, stable=True)
    sw = torch.gather(wg[:, None].expand(key.shape), 0, order)
    pos = torch.arange(K, dtype=key.dtype, device=key.device)[:, None]
    if kind == "median":
        lo = torch.floor((m - 1.0) / 2.0)
        hi = torch.floor(m / 2.0)
        # & (pos < m): at m == 0 the window would otherwise pick a +inf key
        inc = ((pos == lo) | (pos == hi)) & (pos < m)
    else:                                                    # trim
        t = torch.floor(trim_frac * m)
        inc = (pos >= t) & (pos < m - t)
    den = _row_sum(_where0(inc, sw))
    return _row_sum(_where0(inc, sw * s)) / _nz(den)


def robust_federated_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None,
                          *, kind: str, trim_frac: float = 0.1,
                          clip_mult: float = 3.0) -> torch.Tensor:
    """Byzantine-robust drop-in for the plain mean (the JAX package's dense
    ``robust_federated_mean``): ``x`` is the whole [K, N] client stack,
    ``w`` the [K] activity weights (``None`` = every client).

    ``trim`` (coordinate-wise trimmed mean), ``median``, ``clip``
    (norm-clipped mean at ``clip_mult`` x the median active norm), ``krum``
    (multi-Krum, ``f = floor(trim_frac * m)``) and ``geomed`` (geometric
    median, ``GEOMED_ITERS`` Weiszfeld steps).  A client row with any
    non-finite value is folded out of the weights; inactive rows are keyed
    to +inf and never multiplied; an all-rejected round returns zeros.
    """
    if kind not in ROBUST_AGG_CHOICES[1:]:
        raise ValueError(f"unknown robust aggregation {kind!r}; expected "
                         f"one of {ROBUST_AGG_CHOICES[1:]}")
    K = x.shape[0]
    finite = torch.isfinite(x).all(dim=1)
    wg, act, m, wsum = _screen(w, K, finite, x)

    if kind == "clip":
        safe = _where0(finite[:, None], x)
        nrm = torch.linalg.vector_norm(safe, dim=1)
        scl = _clip_scale(nrm, wg, clip_mult)
        clipped = _where0(act[:, None], wg[:, None] * safe * scl[:, None])
        return clipped.sum(dim=0) / _nz(wsum)

    if kind == "krum":
        safe = _where0(act[:, None], x)
        sel = krum_select(safe @ safe.t(), act, m, trim_frac)
        num = _where0(sel[:, None], wg[:, None] * safe).sum(dim=0)
        return num / _nz(_where0(sel, wg).sum())

    if kind == "geomed":
        safe = _where0(act[:, None], x)
        v = (safe * wg[:, None]).sum(dim=0) / _nz(wsum)
        for _ in range(GEOMED_ITERS):
            r = torch.sqrt(((safe - v[None, :]) ** 2).sum(dim=1))
            inv = wg / torch.clamp(r, min=1e-8)
            v = (safe * inv[:, None]).sum(dim=0) / _nz(inv.sum())
        return v

    key = torch.where(act[:, None], x, torch.full_like(x, float("inf")))
    return _sorted_window_mean(key, wg, m, kind, trim_frac)


def robust_federated_mean_chunked(x: torch.Tensor,
                                  w: Optional[torch.Tensor] = None, *,
                                  kind: str, trim_frac: float = 0.1,
                                  clip_mult: float = 3.0,
                                  mesh: ClientMesh) -> torch.Tensor:
    """Segment-owned robust aggregation: the ``--robust-chunked`` path.

    Shard d owns column slab d of the ``all_to_all`` ([K, ceil(N/D)]) and
    computes the estimate for its own coordinates; what the estimators need
    across coordinates (the non-finite screen, per-client norms, krum's Gram
    matrix) is a per-shard partial summed over the shards in order.
    ``trim``/``median`` are coordinate-wise and give the dense result bit for
    bit; ``clip``/``geomed``/``krum`` re-associate the per-client sums
    (allclose).  Krum's Gram partials come from the Gram kernel, once per
    shard.  At D = 1 this is the dense estimator.
    """
    if kind not in ROBUST_AGG_CHOICES[1:]:
        raise ValueError(f"unknown robust aggregation {kind!r}; expected "
                         f"one of {ROBUST_AGG_CHOICES[1:]}")
    if mesh.size <= 1:
        return robust_federated_mean(x, w, kind=kind, trim_frac=trim_frac,
                                     clip_mult=clip_mult)
    K, n = x.shape
    slabs = mesh.all_to_all(x)
    nonfinite = mesh.psum([(~torch.isfinite(s)).to(x.dtype).sum(dim=1)
                           for s in slabs])
    finite = nonfinite == 0
    wg, act, m, wsum = _screen(w, K, finite, x)

    def replicate(parts):
        return mesh.all_gather(parts)[:n]

    if kind == "clip":
        safe = [_where0(finite[:, None], s) for s in slabs]
        nrm = torch.sqrt(mesh.psum([(s * s).sum(dim=1) for s in safe]))
        scl = _clip_scale(nrm, wg, clip_mult)
        return replicate([
            _where0(act[:, None], wg[:, None] * s * scl[:, None]).sum(dim=0)
            / _nz(wsum) for s in safe])

    if kind == "krum":
        safe = [_where0(act[:, None], s) for s in slabs]
        sel = krum_select(mesh.psum([gram(s) for s in safe]), act, m,
                          trim_frac)
        den = _nz(_where0(sel, wg).sum())
        return replicate([_where0(sel[:, None], wg[:, None] * s).sum(dim=0)
                          / den for s in safe])

    if kind == "geomed":
        safe = [_where0(act[:, None], s) for s in slabs]
        v = [(s * wg[:, None]).sum(dim=0) / _nz(wsum) for s in safe]
        for _ in range(GEOMED_ITERS):
            r = torch.sqrt(mesh.psum([((s - vd[None, :]) ** 2).sum(dim=1)
                                      for s, vd in zip(safe, v)]))
            inv = wg / torch.clamp(r, min=1e-8)
            den = _nz(inv.sum())
            v = [(s * inv[:, None]).sum(dim=0) / den for s in safe]
        return replicate(v)

    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    return replicate([
        _sorted_window_mean(torch.where(act[:, None], s, inf), wg, m, kind,
                            trim_frac) for s in slabs])


def make_robust_mean(kind: str, *, trim_frac: float = 0.1,
                     clip_mult: float = 3.0, chunked: bool = False,
                     mesh: Optional[ClientMesh] = None):
    """Factory behind ``--robust-agg``: ``None`` for ``"none"`` (the
    algorithms keep their plain mean), else a ``(stack, w) -> aggregate``
    callable.  ``chunked`` selects the segment-owned estimator over
    ``mesh``.  Validated here, so a bad flag fails at construction."""
    if kind not in ROBUST_AGG_CHOICES:
        raise ValueError(f"unknown robust aggregation {kind!r}; expected "
                         f"one of {ROBUST_AGG_CHOICES}")
    if kind == "none":
        if chunked:
            raise ValueError(
                "--robust-chunked needs a robust estimator; it re-shapes "
                "robust aggregation and has no effect on the plain mean "
                "(use --robust-agg trim/median/clip/krum/geomed)")
        return None
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac={trim_frac} must be in [0, 0.5) "
                         "(trimming half or more leaves nothing to average)")
    if clip_mult <= 0.0:
        raise ValueError(f"clip_mult={clip_mult} must be positive")
    if chunked:
        return functools.partial(robust_federated_mean_chunked, kind=kind,
                                 trim_frac=trim_frac, clip_mult=clip_mult,
                                 mesh=mesh or ClientMesh(1))
    return functools.partial(robust_federated_mean, kind=kind,
                             trim_frac=trim_frac, clip_mult=clip_mult)
