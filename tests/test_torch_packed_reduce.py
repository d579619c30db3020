"""The port's fused quantized collective (``ops/packed_reduce.py`` over the
logical ``ClientMesh``) against the JAX package's ``make_fused_mean`` under
``shard_map`` on the virtual CPU devices, with the JAX comm kernels forced
to Pallas interpret mode.

D = 2, 4, 8 take the butterfly, D = 3, 5, 6 the ring; q8 and q4;
unweighted, weighted, and all clients excluded (the mean is then zero on
both sides).  Tolerances:

- Port vs JAX: within one transport grid step of the output chunk
  (``2 * max|chunk| / (2^bits - 2)``) at every element, and equal to
  float32 rounding (4 ulps of the element) everywhere but a few elements.
  The JAX program runs under ``jit``, where XLA computes a scale as
  ``max * (1/qmax)`` (one ulp off IEEE on some rows) and contracts the
  hop's ``acc + q * safe`` into a fused multiply-add; the port divides and
  adds as IEEE does.  A rounding that lands on the other side of a
  half-integer moves one q by one, which is one grid step of that hop.
  Measured: no element of any case off by more than rounding (the largest
  difference 2.7e-5 of a grid step); up to 3 are allowed per case.
- Port vs the dense mean: within ``(log2 D + 1)`` grid steps of the dense
  mean's chunk (PARITY.md), for the ring too.  Measured: at most 0.94
  steps at D = 2, 1.63 at D = 8, 1.95 at D = 6.

The reduce-scatter's hops accumulate in place: every accumulate writes
into the device's own buffer (``out`` is ``acc``, a slice of it), the
buffers keep their storage, and the result is bit for bit that of an
accumulate into a new tensor copied back.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.compress import make_compressor as j_make
from federated_pytorch_test_tpu.ops import packed_reduce as jpr
from federated_pytorch_test_tpu.ops.comm_kernels import force_comm_kernels_impl
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu_torch.compress.base import make_compressor
from federated_pytorch_test_tpu_torch.ops import packed_reduce as tpr
from federated_pytorch_test_tpu_torch.ops import quant
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

N = 1000


def _jax_fused_mean(name, chunk, D, stack, w):
    comp = j_make(name, quant_chunk=chunk)
    K = stack.shape[0]
    mesh = client_mesh(D)
    csh = client_sharding(mesh)
    mean_fn = jpr.make_fused_mean(comp, D, K)
    fn = shard_map(lambda s, ww: mean_fn(s, None if w is None else ww),
                   mesh=mesh, in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS)),
                   out_specs=P(), check_vma=False)
    ww = np.ones(K, np.float32) if w is None else w
    with force_comm_kernels_impl("pallas_interpret"):
        out = jax.jit(fn)(jax.device_put(jnp.asarray(stack), csh),
                          jax.device_put(jnp.asarray(ww), csh))
    return np.asarray(out)


def _dense_mean(stack, w):
    if w is None:
        return stack.mean(axis=0)
    tot = w.sum()
    return (w[:, None] * stack).sum(axis=0) / (tot if tot > 0 else 1.0)


def _grid_steps(ref, chunk, bits):
    """Per element: the transport grid step of its chunk of ``ref``."""
    pad = -len(ref) % chunk
    r = np.abs(np.pad(ref, (0, pad))).reshape(-1, chunk).max(axis=1)
    step = 2.0 * r / (2 ** bits - 2)
    return np.repeat(step, chunk)[: len(ref)]


WEIGHTS = {
    None: None,
    "weighted": lambda K: np.where(np.arange(K) % 3 == 1, 0.0, 1.0)
    .astype(np.float32),
}


@pytest.mark.parametrize("weights", [None, "weighted"])
@pytest.mark.parametrize("name,chunk", [("q8", 64), ("q4", 256)])
@pytest.mark.parametrize("D", [2, 4, 8, 3, 5, 6])
def test_fused_mean_matches_jax(D, name, chunk, weights):
    K = 2 * D
    stack = np.random.default_rng(D * 10 + chunk).normal(
        size=(K, N)).astype(np.float32)
    w = None if weights is None else WEIGHTS[weights](K)
    want = _jax_fused_mean(name, chunk, D, stack, w)
    comp = make_compressor(name, quant_chunk=chunk)
    launches = dict(quant.LAUNCHES)
    got = tpr.make_fused_mean(comp, ClientMesh(D), K)(
        torch.from_numpy(stack), None if w is None else torch.from_numpy(w))
    assert quant.LAUNCHES == launches                    # CPU: plain versions
    got = got.numpy()
    assert got.shape == (N,) and got.dtype == np.float32
    bits = comp.bits
    diff = np.abs(got - want)
    step = _grid_steps(want, chunk, bits)
    assert (diff <= step * (1 + 1e-6)).all()
    off = diff > 4 * np.spacing(np.abs(want))
    assert int(off.sum()) <= 3, f"{int(off.sum())} elements off"
    # the PARITY.md contract against the dense mean
    dense = _dense_mean(stack, w)
    dstep = _grid_steps(dense, chunk, bits)
    assert (np.abs(got - dense) <= (math.log2(D) + 1) * dstep).all()


@pytest.mark.parametrize("D", [2, 3])
def test_all_excluded_round_is_zero(D):
    K = 2 * D
    stack = np.random.default_rng(D).normal(size=(K, N)).astype(np.float32)
    w = np.zeros(K, np.float32)
    want = _jax_fused_mean("q8", 64, D, stack, w)
    got = tpr.make_fused_mean(make_compressor("q8", quant_chunk=64),
                              ClientMesh(D), K)(torch.from_numpy(stack),
                                                torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_single_device_is_the_plain_divide():
    stack = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 300)).astype(np.float32))
    got = tpr.make_fused_mean(make_compressor("q8"), ClientMesh(1), 4)(stack)
    torch.testing.assert_close(got, stack.sum(dim=0) / 4, rtol=0, atol=0)


def test_packed_fused_mean_kernel_and_plain_sets_agree_on_the_cpu():
    D, K = 4, 8
    stack = torch.from_numpy(np.random.default_rng(1).normal(
        size=(K, 700)).astype(np.float32))
    mesh = ClientMesh(D)
    local = [s.sum(dim=0) for s in mesh.shards(stack)]
    div = torch.tensor(float(K))
    a = tpr.packed_fused_mean(local, div, mesh, 8, 64, quant.KERNELS)
    b = tpr.packed_fused_mean(local, div, mesh, 8, 64, quant.PLAIN)
    assert torch.equal(a, b)


def test_make_fused_mean_refuses_what_is_not_ported():
    """The dense fused mean refuses a codec with no (bits, chunk) transport
    (the identity, top-k) with the JAX message; top-k takes
    ``make_sparse_fused_mean`` instead, and its byte model is JAX's
    (``tests/test_torch_topk.py`` holds the sparse mean against JAX)."""
    for name in ("none", "topk"):
        with pytest.raises(ValueError, match="no \\(bits, chunk\\) "
                                             "transport") as terr:
            tpr.make_fused_mean(make_compressor(name), ClientMesh(2), 4)
        with pytest.raises(ValueError) as jerr:
            jpr.make_fused_mean(j_make(name), 2, 4)
        assert str(terr.value) == str(jerr.value)
    for n in (100, 4_720_640):
        assert (tpr.fused_bytes_on_wire(make_compressor("topk"), n, 2, 4)
                == jpr.fused_bytes_on_wire(j_make("topk"), n, 2, 4))


@pytest.mark.parametrize("name", ["none", "q8", "q4"])
def test_fused_bytes_on_wire_matches_jax(name):
    for chunk in (2, 64, 256):
        t = make_compressor(name, quant_chunk=chunk)
        j = j_make(name, quant_chunk=chunk)
        for n in (1, 1000, 1856, 4_720_640):
            for D in (1, 2, 3, 4, 5, 8):
                assert (tpr.fused_bytes_on_wire(t, n, D, 8)
                        == jpr.fused_bytes_on_wire(j, n, D, 8))
    # the path's largest block at D = 2 (chip_smoke.py checks this figure)
    assert tpr.fused_bytes_on_wire(make_compressor("q8"), 4_720_640, 2,
                                   10) == 9_588_800


def test_mesh_ppermute_and_gathers():
    mesh = ClientMesh(3)
    parts = [torch.full((2,), float(i)) for i in range(3)]
    out = mesh.ppermute(parts, [(0, 1), (1, 2), (2, 0)])
    assert [float(t[0]) for t in out] == [2.0, 0.0, 1.0]
    with pytest.raises(ValueError, match="permutation"):
        mesh.ppermute(parts, [(0, 1), (1, 1), (2, 0)])
    assert mesh.all_gather(parts).shape == (6,)
    assert mesh.all_gather(parts, tiled=False).shape == (3, 2)
    assert list(mesh.indices()) == [0, 1, 2]


@pytest.mark.parametrize("D", [2, 5])
def test_hops_accumulate_in_place_on_the_buffers(D):
    """Butterfly (D = 2) and ring (D = 5) reduce-scatter: each hop's
    accumulate writes into ``bufs`` itself, whose storage does not move,
    with the values of an out-of-place accumulate copied back."""
    K, chunk, bits = 2 * D, 64, 8
    stack = torch.from_numpy(np.random.default_rng(D).normal(
        size=(K, N)).astype(np.float32))
    mesh = ClientMesh(D)
    seg = tpr._seg_elems(N, D, chunk)
    local = [s.sum(dim=0) for s in mesh.shards(stack)]
    bufs = [torch.nn.functional.pad(x, (0, D * seg - N)) for x in local]
    ref = [b.clone() for b in bufs]
    spans = [(b.data_ptr(), b.data_ptr() + b.numel() * 4) for b in bufs]
    seen = []

    def in_place(acc, q, scale, out=None):
        assert out is acc
        seen.append(any(lo <= out.data_ptr() < hi for lo, hi in spans))
        return quant.dequant_add_plain(acc, q, scale, out)

    def copied_back(acc, q, scale, out=None):
        out.copy_(quant.dequant_add_plain(acc, q, scale))
        return out

    run = (tpr._butterfly_reduce_scatter if D & (D - 1) == 0
           else tpr._ring_reduce_scatter)
    lo = run(bufs, mesh, seg, chunk, bits,
             quant.QuantImpl(quant.quantize_plain, in_place))
    lo_ref = run(ref, mesh, seg, chunk, bits,
                 quant.QuantImpl(quant.quantize_plain, copied_back))
    hops = 1 if D == 2 else D - 1
    assert seen == [True] * (D * hops)
    assert [b.data_ptr() for b in bufs] == [lo for lo, _ in spans]
    assert lo == lo_ref
    for b, r in zip(bufs, ref):
        assert torch.equal(b, r)
