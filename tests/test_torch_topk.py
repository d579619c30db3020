"""Top-k on the port (``ops/topk_select.py``, ``compress/topk.py``, the
sparse branches of ``parallel/comm.py`` and ``ops/packed_reduce.py``)
against the JAX package.

- The selection: the same int32 indices in the same order as JAX's
  ``top_k_abs_indices`` (its single-shot and its chunked path), on vectors
  with ties of magnitude (``v`` and ``-v``, repeated values, runs of zeros,
  ties across a 2,048-wide chunk boundary), an all-zero vector, ``k = n``
  and ``k = 1``.  Exactly.
- ``TopK``: ``k_for`` at every half-way ``frac * n`` (Python's round, half
  to even), ``bytes_on_wire``, the payload, ``decode`` and the
  error-feedback residual: bitwise.
- The sparse means: ``compressed_federated_mean`` and
  ``make_sparse_fused_mean`` at D = 1 and D = 2, unweighted and weighted,
  on payloads whose index sets overlap (every client's top coordinates
  collide on 8 shared indices), against the JAX functions under
  ``shard_map`` on the virtual CPU devices.  The weighted case excludes a
  client (``w = 0``) whose payload values are NaN: the fused mean
  where-selects it out (no NaN on either side), the unfused mean
  multiplies it by 0 (NaN at its indices on both sides, as in JAX).  All
  bitwise: both sides add the clients' values in client order (the JAX
  CPU scatter applies its updates in order; the port makes one
  ``index_add_`` a client), and the divisors are exact.
- The sparse byte model of the fused collective equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.compress import make_compressor as j_make
from federated_pytorch_test_tpu.compress.topk import TopK as JTopK
from federated_pytorch_test_tpu.ops import packed_reduce as jpr
from federated_pytorch_test_tpu.ops.topk_select import (
    force_topk_impl,
    top_k_abs_indices as j_topk,
)
from federated_pytorch_test_tpu.parallel.comm import (
    compressed_federated_mean as j_mean,
)
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu_torch.compress.base import make_compressor
from federated_pytorch_test_tpu_torch.compress.topk import TopK, accumulate_rows
from federated_pytorch_test_tpu_torch.ops import packed_reduce as tpr
from federated_pytorch_test_tpu_torch.ops.topk_select import top_k_abs_indices
from federated_pytorch_test_tpu_torch.parallel.comm import (
    compressed_federated_mean as t_mean,
    decode_stack,
)
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh


def _tied(n: int, seed: int) -> np.ndarray:
    """A vector whose magnitudes tie everywhere: values from a grid of 5
    magnitudes with random signs, and a run of zeros."""
    rng = np.random.default_rng(seed)
    v = rng.choice(np.float32([0.5, 1.0, 2.0, 3.0, 0.25]), size=n)
    v = v * rng.choice(np.float32([-1.0, 1.0]), size=n)
    v[n // 3: n // 3 + n // 10] = 0.0
    return v.astype(np.float32)


VECTORS = {
    "ties": _tied(300, 1),
    "ties_across_chunks": _tied(5_000, 2),
    "zeros": np.zeros(64, np.float32),
    "signed_zeros": np.where(np.arange(64) % 2, -0.0, 0.0).astype(np.float32),
    "normal": np.random.default_rng(3).normal(size=1000).astype(np.float32),
}


@pytest.mark.parametrize("name", list(VECTORS))
@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_selection_matches_jax(name, impl):
    v = VECTORS[name]
    n = v.shape[0]
    for k in sorted({1, 2, 7, n // 4, n // 2 + 1, n - 1, n}):
        with force_topk_impl(impl):
            want = np.asarray(j_topk(jnp.asarray(v), k))
        got = top_k_abs_indices(torch.from_numpy(v), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_selection_of_a_stack_is_row_by_row():
    rows = np.stack([VECTORS["ties"], -VECTORS["ties"][::-1],
                     _tied(300, 9)])
    got = top_k_abs_indices(torch.from_numpy(rows), 40)
    for r, row in enumerate(rows):
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(j_topk(jnp.asarray(row), 40)))
    with pytest.raises(ValueError):
        top_k_abs_indices(torch.from_numpy(rows), 301)


@pytest.mark.parametrize("frac", [0.5, 0.25, 0.125, 0.01, 0.3, 1.0])
def test_k_for_and_bytes_match_jax(frac):
    """Every n in 1..400 (for 0.5, 0.25 and 0.125 that includes every
    half-way ``frac * n``), and the ResNet18 blocks' sizes."""
    t, j = TopK(frac), JTopK(frac)
    for n in list(range(1, 401)) + [1_856, 73_984, 4_720_640]:
        assert t.k_for(n) == j.k_for(n)
        assert t.bytes_on_wire(n) == j.bytes_on_wire(n) == 8 * t.k_for(n)
    assert TopK(0.5).k_for(5) == 2 and TopK(0.5).k_for(7) == 4
    assert TopK(0.01).k_for(4_720_640) == 47_206


@pytest.mark.parametrize("frac", [0.0, -0.1, 1.5])
def test_frac_validation_matches_jax(frac):
    with pytest.raises(ValueError) as jerr:
        JTopK(frac)
    with pytest.raises(ValueError) as terr:
        TopK(frac)
    assert str(terr.value) == str(jerr.value)


def _stack(K: int, n: int, seed: int) -> np.ndarray:
    rows = [_tied(n, seed + k) * (k + 1) for k in range(K)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("ef", [False, True])
def test_encode_decode_and_residual_bitwise(ef):
    """Two rounds of the codec on a [4, 300] stack with ties: the payload,
    the reconstruction and the carried residual bitwise equal to JAX's
    (its codec ``vmap``\\ ped over the clients)."""
    K, n = 4, 300
    j = j_make("topk", topk_frac=0.1, error_feedback=ef)
    t = make_compressor("topk", topk_frac=0.1, error_feedback=ef)
    assert t.name == j.name and t.sparse
    jstate = jax.vmap(lambda _: j.init_state(n, None))(jnp.arange(K)) \
        if ef else None
    tstate = t.init_state(n, np.arange(K), "cpu")
    for rnd in range(2):
        x = _stack(K, n, 10 * rnd)
        jpay, jstate = jax.vmap(j.encode)(jnp.asarray(x), jstate)
        tpay, tstate = t.encode(torch.from_numpy(x), tstate)
        np.testing.assert_array_equal(tpay["idx"].numpy(),
                                      np.asarray(jpay["idx"]))
        np.testing.assert_array_equal(tpay["val"].numpy(),
                                      np.asarray(jpay["val"]))
        assert tpay["idx"].dtype == torch.int32
        want = np.asarray(jax.vmap(lambda p: j.decode(p, n))(jpay))
        got = decode_stack(tpay, t, n).numpy()
        assert got.tobytes() == want.tobytes()
        if ef:
            assert (tstate["resid"].numpy().tobytes()
                    == np.asarray(jstate["resid"]).tobytes())
    if ef:
        # the residual is the delta with its selected coordinates removed
        assert (tstate["resid"] != 0).sum() <= K * (n - t.inner.k_for(n))


def _payload(K: int, n: int, k: int, seed: int):
    """K clients' {idx, val}: each client's k indices hold 8 shared
    coordinates (collisions) and k - 8 of its own draw."""
    rng = np.random.default_rng(seed)
    shared = rng.choice(n, size=8, replace=False)
    idx = []
    for _ in range(K):
        rest = rng.choice(np.setdiff1d(np.arange(n), shared), size=k - 8,
                          replace=False)
        row = np.concatenate([shared, rest])
        idx.append(rng.permutation(row))
    idx = np.stack(idx).astype(np.int32)
    val = rng.normal(size=(K, k)).astype(np.float32)
    return idx, val


def _jax_sparse(fn, D, idx, val, w, z):
    """``fn(idx, val, w, z)`` under ``shard_map`` over D virtual devices."""
    mesh = client_mesh(D)
    csh = client_sharding(mesh)
    f = shard_map(fn, mesh=mesh,
                  in_specs=(P(CLIENT_AXIS),) * 3 + (P(),), out_specs=P(),
                  check_vma=False)
    args = [jax.device_put(jnp.asarray(a), csh) for a in (idx, val, w)]
    return np.asarray(jax.jit(f)(*args, jnp.asarray(z)))


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_sparse_means_match_jax_bitwise(D, weighted, fused):
    K, n, k = 4, 300, 30
    idx, val = _payload(K, n, k, seed=20 + D)
    z = np.random.default_rng(5).normal(size=n).astype(np.float32)
    w = np.array([1, 0, 1, 1], np.float32) if weighted else np.ones(K,
                                                                   np.float32)
    if weighted:
        val[1] = np.nan                     # the excluded client's payload
    comp = make_compressor("topk", topk_frac=k / n)
    jcomp = j_make("topk", topk_frac=k / n)
    if fused:
        want = _jax_sparse(
            lambda i, v, ww, zz: jpr.make_sparse_fused_mean(
                {"idx": i, "val": v}, zz, K)(None, ww if weighted else None),
            D, idx, val, w, z)
        got = tpr.make_sparse_fused_mean(
            {"idx": torch.from_numpy(idx), "val": torch.from_numpy(val)},
            torch.from_numpy(z), K, ClientMesh(D))(
                None, torch.from_numpy(w) if weighted else None)
        assert np.isfinite(got.numpy()).all()
    else:
        want = _jax_sparse(
            lambda i, v, ww, zz: j_mean({"idx": i, "val": v}, jcomp, n, K,
                                        w=ww if weighted else None),
            D, idx, val, w, z)
        got = t_mean({"idx": torch.from_numpy(idx),
                      "val": torch.from_numpy(val)}, comp, n, K,
                     ClientMesh(D), torch.from_numpy(w) if weighted else None)
        assert np.isnan(got.numpy()).any() == weighted
    assert got.numpy().tobytes() == want.tobytes()


def test_sparse_fused_mean_all_excluded_is_zero():
    K, n, k = 4, 50, 10
    idx, val = _payload(K, n, k, seed=3)
    z = np.ones(n, np.float32)
    w = np.zeros(K, np.float32)
    want = _jax_sparse(lambda i, v, ww, zz: jpr.make_sparse_fused_mean(
        {"idx": i, "val": v}, zz, K)(None, ww), 2, idx, val, w, z)
    got = tpr.make_sparse_fused_mean(
        {"idx": torch.from_numpy(idx), "val": torch.from_numpy(val)},
        torch.from_numpy(z), K, ClientMesh(2))(None, torch.from_numpy(w))
    assert (want == 0).all() and got.numpy().tobytes() == want.tobytes()


def test_accumulate_rows_adds_in_row_order():
    """Three rows on one index: ((0 + a) + b) + c, not another order (the
    values are chosen so that the orders round differently)."""
    a, b, c = np.float32(1.0), np.float32(1e8), np.float32(-1e8)
    acc = accumulate_rows(torch.zeros(2), torch.tensor([[1], [1], [1]]),
                          torch.tensor([[a], [b], [c]]))
    assert float(acc[1]) == float((a + b) + c) == 0.0
    assert float((c + b) + a) == 1.0


@pytest.mark.parametrize("ef", [False, True])
def test_sparse_fused_bytes_match_jax(ef):
    for frac in (0.01, 0.1, 0.5):
        t = make_compressor("topk", topk_frac=frac, error_feedback=ef)
        j = j_make("topk", topk_frac=frac, error_feedback=ef)
        for n in (1, 300, 1_856, 4_720_640):
            for D in (1, 2, 3, 4, 8):
                assert (tpr.fused_bytes_on_wire(t, n, D, 8)
                        == jpr.fused_bytes_on_wire(j, n, D, 8))
    # the path's largest block at D = 2, K = 10 (chip_smoke.py checks it)
    t = make_compressor("topk", error_feedback=True)
    assert tpr.fused_bytes_on_wire(t, 4_720_640, 2, 10) == 3_776_480
    assert 10 * t.bytes_on_wire(4_720_640) == 3_776_480
