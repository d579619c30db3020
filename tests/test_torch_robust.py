"""The port's Gram kernel wrapper and robust estimators
(``ops/gram.py``, ``parallel/comm.py``, ``parallel/mesh.py``) against the
JAX package.

- ``gram_plain`` (what the CUDA kernel is held against on the card) vs the
  Pallas ``_gram_pallas`` in interpret mode: allclose at atol 1e-4 (the
  Pallas contract against the one-shot matmul) for entries up to 100, and
  1e-6 of the largest entry above that (float32 keeps about 7 digits; the
  two sum the slab products in different orders).
- The five estimators, dense at D=1 and chunked at D=2 and D=4, vs the JAX
  functions under ``shard_map`` on the virtual CPU mesh, with the Pallas
  Gram forced in interpret mode (PARITY.md v0.16): trim and median bitwise,
  clip, krum and geomed at rtol 1e-4 (atol 1e-6), the non-finite screen
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.ops.comm_kernels import (
    _gram_pallas,
    force_comm_kernels_impl,
)
from federated_pytorch_test_tpu.parallel.comm import (
    robust_federated_mean as j_dense,
    robust_federated_mean_chunked as j_chunked,
)
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu_torch.ops import gram as tgram
from federated_pytorch_test_tpu_torch.parallel import comm as tcomm
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    ClientMesh,
    usable_device_count,
)

KINDS = ["trim", "median", "clip", "krum", "geomed"]


def _gram_atol(want):
    return 1e-4 * max(1.0, float(np.abs(want).max()) / 100)
BITWISE = {"trim", "median"}


# ---------------------------------------------------------------------------
# Gram


@pytest.mark.parametrize("K", [1, 3, 10, 16])
@pytest.mark.parametrize("n", [1, 511, 512, 1000, 5000])
def test_gram_plain_matches_pallas_interpret(K, n):
    a = np.random.default_rng(K * 7919 + n).normal(size=(K, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: _gram_pallas(x, interpret=True))(
        jnp.asarray(a)))
    got = tgram.gram(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_gram_atol(want))
    np.testing.assert_array_equal(got, got.T)


def test_gram_plain_zero_row():
    a = np.random.default_rng(1).normal(size=(10, 1000)).astype(np.float32)
    a[4] = 0.0
    want = np.asarray(_gram_pallas(jnp.asarray(a), interpret=True))
    got = tgram.gram(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got[4], 0.0)
    np.testing.assert_array_equal(got[:, 4], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=_gram_atol(want))


def test_gram_cpu_tensor_takes_plain_version_without_launch():
    before = tgram.LAUNCHES["gram"]
    a = torch.randn(3, 700)
    torch.testing.assert_close(tgram.gram(a), tgram.gram_plain(a))
    assert tgram.LAUNCHES["gram"] == before


def test_gram_other_device_raises():
    with pytest.raises(ValueError):
        tgram.gram(torch.empty(3, 5, device="meta"))


@pytest.mark.parametrize("K,n", [(10, 928), (10, 2_360_320), (1, 1),
                                 (16, 100_003), (17, 1000), (128, 4096)])
def test_gram_plan_covers_columns(K, n):
    chunk, nchunks = tgram.plan(K, n)
    assert chunk % 128 == 0 and nchunks >= 1
    assert (nchunks - 1) * chunk < n <= nchunks * chunk
    tiles = -(-K // 8)
    pairs = 1 if K <= 16 else tiles * (tiles + 1) // 2
    assert nchunks * pairs <= max(tgram.MAX_BLOCKS, pairs)
    assert chunk % tgram.STAGE_COLS == 0


def test_gram_plan_is_a_pure_function_of_K_and_n():
    """The split, and so the order of the sums, depends on (K, n) alone:
    the same after other calls, and the same as computed afresh."""
    shapes = [(10, 928), (10, 2_360_320), (17, 60_000), (128, 4096), (3, 1)]
    first = [tgram.plan(K, n) for K, n in shapes]
    fresh = [tgram.plan.__wrapped__(K, n) for K, n in shapes]
    again = [tgram.plan(K, n) for K, n in reversed(shapes)][::-1]
    assert first == fresh == again
    # the path's two shards: the stem is one chunk (G written directly),
    # the largest shard one chunk of 18 stages on each of 129 SMs
    assert tgram.plan(10, 928) == (1024, 1)
    assert tgram.plan(10, 2_360_320) == (18 * 1024, 129)
    # the workspace holds the partials of every plan
    for K in range(1, tgram.MAX_K + 1):
        _, nchunks = tgram.plan(K, 10 ** 7)
        assert nchunks * K * K <= tgram.WORK_FLOATS


@pytest.mark.parametrize("addr,lda,n,vec", [
    (0x7F0000000000, 928, 928, True),            # a whole aligned matrix
    (0x7F0000000000 + 12, 936, 928, False),      # w[:, 3:3+n]: base off 16 B
    (0x7F0000000000, 1001, 1000, False),         # lda % 4 != 0
    (0x7F0000000000 + 16, 100_012, 100_003, True),  # aligned slab, lda % 4 == 0
    (0x7F0000000000, 0, 2_360_320, True),        # one row: no stride
    (0x7F0000000000, 4, 3, False),               # a row under one vector
])
def test_gram_vector_path_choice(addr, lda, n, vec):
    assert tgram.vector_path(addr, lda, n) is vec


# ---------------------------------------------------------------------------
# robust estimators


def _jax_run(fn, x, w, D):
    mesh = client_mesh(D)
    csh = client_sharding(mesh)
    f = shard_map(fn, mesh=mesh, in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS)),
                  out_specs=P(), check_vma=False)
    with force_comm_kernels_impl("pallas_interpret"):
        return np.asarray(jax.jit(f)(
            jax.device_put(jnp.asarray(x), csh),
            jax.device_put(jnp.asarray(w, jnp.float32), csh)))


def _pair(x, w, kind, D, **kw):
    """(JAX, port) for the dense estimator at D=1, the chunked one above."""
    if D == 1:
        want = _jax_run(lambda xs, ws: j_dense(xs, ws, kind=kind, **kw),
                        x, w, 1)
        got = tcomm.robust_federated_mean(
            torch.from_numpy(x), torch.from_numpy(w), kind=kind, **kw)
    else:
        want = _jax_run(lambda xs, ws: j_chunked(xs, ws, kind=kind, D=D, **kw),
                        x, w, D)
        got = tcomm.robust_federated_mean_chunked(
            torch.from_numpy(x), torch.from_numpy(w), kind=kind,
            mesh=ClientMesh(D), **kw)
    return want, got.numpy()


def _check(want, got, kind):
    assert got.shape == want.shape
    if kind in BITWISE:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(8)
    return rng.normal(size=(8, 1001)).astype(np.float32)   # n % D != 0


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_estimator_matches_jax(stack, kind, D):
    w = np.ones(8, np.float32)
    _check(*_pair(stack, w, kind, D, trim_frac=0.2), kind)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_nonfinite_client_screened_exactly(stack, kind, D):
    x = stack.copy()
    x[3, 1000] = np.nan          # the last shard's slab only
    x[6, 5] = np.inf
    want, got = _pair(x, np.ones(8, np.float32), kind, D, trim_frac=0.2)
    assert np.isfinite(got).all()
    _check(want, got, kind)
    # the screened result is the estimate over the six finite clients
    keep = [0, 1, 2, 4, 5, 7]
    ref = tcomm.robust_federated_mean(
        torch.from_numpy(stack[keep]), kind=kind, trim_frac=0.2).numpy()
    if kind in BITWISE:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["trim", "krum", "geomed"])
def test_partial_weights_match_jax(stack, kind):
    w = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    _check(*_pair(stack, w, kind, 2, trim_frac=0.2), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_all_rejected_round_yields_zero(stack, kind):
    w = np.zeros(8, np.float32)
    got = tcomm.robust_federated_mean_chunked(
        torch.from_numpy(stack), torch.from_numpy(w), kind=kind,
        mesh=ClientMesh(2))
    np.testing.assert_array_equal(got.numpy(), np.zeros(1001, np.float32))


def test_krum_tie_breaks_to_lower_index():
    # clients 0 and 1 identical, 2 and 3 identical: equal scores pairwise;
    # with f=1 of m=4, m - f = 3 clients are kept — 0, 1 and the LOWER of
    # the tied pair (2, 3), i.e. 2
    base = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)
    x = np.stack([base[0], base[0], base[1], base[1]])
    w = np.ones(4, np.float32)
    want, got = _pair(x, w, "krum", 2, trim_frac=0.25)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, (2 * base[0] + base[1]) / 3, rtol=1e-6)


def test_unweighted_call_is_full_participation(stack):
    x = torch.from_numpy(stack)
    a = tcomm.robust_federated_mean_chunked(x, None, kind="median",
                                            mesh=ClientMesh(2))
    b = tcomm.robust_federated_mean_chunked(x, torch.ones(8), kind="median",
                                            mesh=ClientMesh(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_make_robust_mean_validates():
    assert tcomm.make_robust_mean("none") is None
    with pytest.raises(ValueError, match="robust-chunked"):
        tcomm.make_robust_mean("none", chunked=True)
    with pytest.raises(ValueError):
        tcomm.make_robust_mean("trim", trim_frac=0.5)
    with pytest.raises(ValueError):
        tcomm.make_robust_mean("clip", clip_mult=0.0)
    with pytest.raises(ValueError):
        tcomm.make_robust_mean("bogus")
    assert tcomm.ROBUST_AGG_CHOICES == ("none", "trim", "median", "clip",
                                        "krum", "geomed")


def test_mesh_collectives():
    mesh = ClientMesh(2)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    slabs = mesh.all_to_all(x)
    assert [s.shape for s in slabs] == [(4, 2), (4, 2)]
    torch.testing.assert_close(torch.cat(slabs, dim=1)[:, :3], x)
    torch.testing.assert_close(mesh.all_gather([x[0], x[1]]), x[:2].reshape(-1))
    torch.testing.assert_close(mesh.federated_sum(x), x.sum(0))
    with pytest.raises(ValueError, match="not divisible"):
        ClientMesh(3).shards(x)
    with pytest.raises(ValueError):
        ClientMesh(0)
    assert usable_device_count(10) == 1
    assert usable_device_count(10, 4) == 2
    assert usable_device_count(13, 8) == 1
