"""Port InfoNCE (``federated_pytorch_test_tpu_torch/ops/infonce.py``) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor the port's wrappers run the plain versions of its CUDA
kernels (``log_p_flat`` and ``grads_plain``), so these tests hold the
algebra the kernels implement against ``_log_p_kernel`` and
``_grad_kernel``.  The kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.

Tolerances: float32 throughout; the two sides sum the D-long dot products
in different orders, so values agree to a few ulps of their magnitude —
log_p and the loss at rtol 1e-5 / atol 1e-5, gradients at rtol 1e-4 /
atol 1e-6 (the JAX package's own kernel-vs-XLA gradient tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from federated_pytorch_test_tpu.ops import infonce as jinfonce
from federated_pytorch_test_tpu.ops.infonce import force_infonce_impl
from federated_pytorch_test_tpu_torch.ops import infonce as tinfonce
from federated_pytorch_test_tpu_torch.ops.infonce_core import (
    flat_patch_matrix,
    info_nce,
)

# (B, R, px, py): D = B*R rows, P = px*py score columns
SHAPES = [
    (2, 4, 1, 1),        # P = 1
    (4, 8, 3, 3),        # P = 9
    (128, 32, 3, 3),     # the CPC path: D = 4096, P = 9
    (3, 5, 10, 13),      # P = 130: more than one 128-column Pallas tile
    (4099, 1, 3, 3),     # ragged D
]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape).astype(np.float32)
    zh = rng.standard_normal(shape).astype(np.float32)
    return z, zh


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _flat(a):
    B, R, px, py = a.shape
    return a.reshape(B * R, px * py)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_log_p(shape):
    z, zh = _pair(shape, 0)
    Z, Zh = _flat(z), _flat(zh)
    want = np.asarray(jinfonce._log_p_pallas(jnp.asarray(Z), jnp.asarray(Zh),
                                             interpret=True))
    got = tinfonce.infonce_fwd(torch.from_numpy(Z), torch.from_numpy(Zh))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_pallas_grads(shape):
    z, zh = _pair(shape, 1)
    Z, Zh = _flat(z), _flat(zh)
    P = Z.shape[1]
    rng = np.random.default_rng(2)
    log_p = np.array(jinfonce._log_p_pallas(jnp.asarray(Z), jnp.asarray(Zh),
                                            interpret=True))
    ghat = rng.standard_normal(P).astype(np.float32)
    wz, wzh = jinfonce._grads_pallas(jnp.asarray(Z), jnp.asarray(Zh),
                                     jnp.asarray(log_p), jnp.asarray(ghat),
                                     interpret=True)
    gz, gzh = tinfonce.infonce_bwd(torch.from_numpy(Z), torch.from_numpy(Zh),
                                   torch.from_numpy(log_p),
                                   torch.from_numpy(ghat))
    np.testing.assert_allclose(gz.numpy(), np.asarray(wz), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gzh.numpy(), np.asarray(wzh), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_loss_and_grads_match_fused_op(shape):
    """The whole op: value and gradients of the JAX ``info_nce_fused``
    (custom_vjp over the interpret-mode kernels) against the port's
    autograd Function."""
    z, zh = _pair(shape, 3)
    with force_infonce_impl("pallas_interpret"):
        wv, (wgz, wgzh) = jax.value_and_grad(jinfonce.info_nce_fused,
                                             argnums=(0, 1))(_nhwc(z),
                                                             _nhwc(zh))
    tz = torch.from_numpy(z).requires_grad_(True)
    tzh = torch.from_numpy(zh).requires_grad_(True)
    v = tinfonce.info_nce_fused(tz, tzh)
    v.backward()
    np.testing.assert_allclose(v.item(), float(wv), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(),
                               np.asarray(wgz).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tzh.grad.numpy(),
                               np.asarray(wgzh).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-6)


def test_zero_norm_columns_stay_finite_and_match():
    """An all-zero column in Z and another in Zhat: the guarded norm keeps
    value and gradients finite on both sides, and they agree."""
    z, zh = _pair((4, 8, 3, 3), 4)
    z[:, :, 0, 1] = 0.0          # column p = 1 of Z
    zh[:, :, 2, 2] = 0.0         # column p = 8 of Zhat
    with force_infonce_impl("pallas_interpret"):
        wv, (wgz, wgzh) = jax.value_and_grad(jinfonce.info_nce_fused,
                                             argnums=(0, 1))(_nhwc(z),
                                                             _nhwc(zh))
    tz = torch.from_numpy(z).requires_grad_(True)
    tzh = torch.from_numpy(zh).requires_grad_(True)
    v = tinfonce.info_nce_fused(tz, tzh)
    v.backward()
    assert np.isfinite(v.item())
    assert torch.isfinite(tz.grad).all() and torch.isfinite(tzh.grad).all()
    np.testing.assert_allclose(v.item(), float(wv), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(),
                               np.asarray(wgz).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tzh.grad.numpy(),
                               np.asarray(wgzh).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-6)


def test_hand_backward_matches_autograd_of_plain_loss():
    """The hand-derived backward (what the CUDA kernel computes) equals
    autograd through the plain forward ops."""
    z, zh = _pair((4, 8, 3, 3), 5)
    a = torch.from_numpy(z).requires_grad_(True)
    b = torch.from_numpy(zh).requires_grad_(True)
    tinfonce.info_nce_fused(a, b, tinfonce.PLAIN).backward()
    c = torch.from_numpy(z).requires_grad_(True)
    d = torch.from_numpy(zh).requires_grad_(True)
    info_nce(c, d).backward()
    np.testing.assert_allclose(a.grad.numpy(), c.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), d.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_flat_patch_matrix_matches_jax_layout():
    """NCHW [B, R, px, py] -> [B*R, P] gives the JAX NHWC matrix exactly."""
    from federated_pytorch_test_tpu.ops.infonce_core import (
        flat_patch_matrix as jflat,
    )

    z, _ = _pair((3, 5, 2, 4), 6)
    np.testing.assert_array_equal(
        flat_patch_matrix(torch.from_numpy(z)).numpy(),
        np.asarray(jflat(_nhwc(z))))


def test_wrappers_refuse_a_device_that_is_not_cpu_or_cuda():
    """Dispatch is by device: a tensor off the CPU that is not a CUDA
    tensor raises instead of running the plain version."""
    Z = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tinfonce.infonce_fwd(Z, Z)
    with pytest.raises(ValueError, match="CUDA device"):
        tinfonce.infonce_bwd(Z, Z, torch.empty(3, device="meta"),
                             torch.empty(3, device="meta"))


# ---------------------------------------------------------------------------
# The cluster kernels' plan and order of summation
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 9), (8, 1), (4096, 9), (4099, 9), (100_003, 9), (4096, 32),
               (4096, 33), (256, 1000)]


def _warps_per_tile(P):
    """Warps of a column tile in the kernels' partial sums (``csrc/infonce.cu``
    ``block_partials``): 16 warps over ceil(P / TI) tiles of TI = 3 columns
    (2 above P = 16), at most 2 a tile."""
    tile_cols = 3 if P <= 16 else 2
    return min(16 // -(-P // tile_cols), 2)


def _rows_of(pl, D, P, rank, it_warp):
    """(rows, lanes): the rows of D one warp of a column tile takes, in the
    kernels' order, and the lane that takes each: block ``rank`` owns
    ``[rank R, (rank + 1) R)``; each staged tile of it gives lane s of warp
    w the rows 32 w + s + 32 WT k of the tile."""
    R, step = pl.rows_per_block, 32 * _warps_per_tile(P)
    lo, hi = min(D, rank * R), min(D, (rank + 1) * R)
    rows, lanes = [], []
    for t0 in range(lo, hi, pl.tile_rows):
        t1 = min(hi, t0 + pl.tile_rows)
        for k in range(t0 + 32 * it_warp, t1, step):
            n = min(k + 32, t1) - k
            rows.extend(range(k, k + n))
            lanes.extend(range(n))
    return (np.asarray(rows, dtype=np.int64),
            np.asarray(lanes, dtype=np.int64))


def test_plan_is_a_pure_function_of_D_and_P():
    """The same plan afresh, after other calls, and asked in reverse order:
    the order of every sum in the kernels depends on (D, P) only."""
    first = [tinfonce.plan(D, P) for D, P in PLAN_SHAPES]
    fresh = [tinfonce.plan.__wrapped__(D, P) for D, P in PLAN_SHAPES]
    tinfonce.plan(7, 3), tinfonce.plan(10 ** 6, 17)
    again = [tinfonce.plan(D, P) for D, P in reversed(PLAN_SHAPES)][::-1]
    assert first == fresh == again


@pytest.mark.parametrize("D", [1, 8, 4096, 4099, 100_003])
def test_plan_row_split_covers_D_exactly_once(D):
    """Every row of D goes to exactly one lane of each column tile, across
    the blocks of the cluster, and every block's tiles fit its staging."""
    pl = tinfonce.plan(D, 9)
    assert pl.branch == "cluster" and pl.rows_per_block % 4 == 0
    assert pl.rows_per_block * pl.cluster >= D
    assert 16 * 9 * pl.tile_rows <= tinfonce.STAGE_BYTES
    seen = []
    for rank in range(pl.cluster):
        for w in range(_warps_per_tile(9)):
            rows, lanes = _rows_of(pl, D, 9, rank, w)
            seen.extend(rows.tolist())
            if len(lanes):
                assert lanes.max() < 32
    assert sorted(seen) == list(range(D))


def _backward_rows_written(n, rows_per_thread):
    """How often the backward's output loop (``infonce_bwd_cluster``) forms
    each row of a staged tile of n rows: T = min(whole warps of
    ceil(n / RB), 512) threads; thread t forms the RB rows r0 + k T,
    r0 = t, t + RB T, ...  Also returns T."""
    RB = rows_per_thread
    T = min(-(-(-(-n // RB)) // 32) * 32, tinfonce.THREADS)
    count = np.zeros(n, np.int64)
    for t in range(T):
        for r0 in range(t, n, RB * T):
            for k in range(RB):
                if r0 + k * T < n:
                    count[r0 + k * T] += 1
    return count, T


# D, P whose backward tiles hold more rows than 512 threads x RB: (20000, 4)
# and (10000, 13) take tiles of 1252 and 628 rows
BACKWARD_TILE_SHAPES = [(20_000, 4), (10_000, 13), (4096, 9), (100_003, 9),
                        (4096, 32), (1, 1), (4099, 12), (65_536, 16),
                        (40_000, 7), (7, 3)]


@pytest.mark.parametrize("D,P", BACKWARD_TILE_SHAPES)
def test_backward_writes_every_row_of_a_tile_once(D, P):
    """Each block's output loop forms every row of each of its tiles exactly
    once, also where a tile holds more rows than its threads form at once,
    and never uses more threads than a block has."""
    pl = tinfonce.plan(D, P)
    assert pl.rows_per_thread == (2 if P <= 12 else 1)
    sizes = set()
    for rank in range(pl.cluster):
        lo, hi = min(D, rank * pl.rows_per_block), min(D, (rank + 1) * pl.rows_per_block)
        sizes.update(min(pl.tile_rows, hi - t0) for t0 in range(lo, hi, pl.tile_rows))
    for n in sorted(sizes):
        count, T = _backward_rows_written(n, pl.rows_per_thread)
        assert T <= tinfonce.THREADS
        assert (count == 1).all(), (n, np.flatnonzero(count != 1)[:5])


@pytest.mark.parametrize("P", range(1, tinfonce.CLUSTER_MAX_P + 1))
def test_plan_shared_memory_fits_the_card(P):
    """On the cluster branch a block's shared memory stays within the 227 KB
    the H100 gives a block, at the path's D and at a D that needs tiles."""
    for D in (4096, 10 ** 6):
        pl = tinfonce.plan(D, P)
        assert pl.branch == "cluster"
        assert pl.smem_bytes == tinfonce.cluster_smem_bytes(P, pl.tile_rows)
        assert 0 < pl.smem_bytes <= tinfonce.SMEM_LIMIT


def test_plan_branches_at_the_threshold():
    """The path's shape takes the cluster branch; above CLUSTER_MAX_P the
    rows branch (no cluster, no staging)."""
    assert tinfonce.plan(4096, 9).branch == "cluster"
    assert tinfonce.plan(4096, 9).cluster == tinfonce.CLUSTER
    assert tinfonce.plan(4096, tinfonce.CLUSTER_MAX_P).branch == "cluster"
    for P in (tinfonce.CLUSTER_MAX_P + 1, 130, tinfonce.MAX_P):
        assert tinfonce.plan(4096, P) == ("rows", 0, 4096, 0, 0, 0)


def _kernel_order_totals(Z, Zh):
    """[P, P + 2] totals (cross sums, |z_i|^2, |zhat_i|^2) summed as the
    cluster kernels sum them, in float32: each lane over its rows in order,
    the warp's lanes by the reduce-scatter's pairwise tree (offsets 16, 8,
    4, 2, 1), a tile's warps in order, then the blocks in rank order."""
    D, P = Z.shape
    pl = tinfonce.plan(D, P)
    tot = np.zeros((P, P + 2), np.float32)
    for rank in range(pl.cluster):
        part = np.zeros((P, P + 2), np.float32)
        for w in range(_warps_per_tile(P)):
            acc = np.zeros((32, P, P + 2), np.float32)
            rows, lane_of = _rows_of(pl, D, P, rank, w)
            for k in range(0, len(rows), 32):       # one row a lane at a time
                r, lanes = rows[k: k + 32], lane_of[k: k + 32]
                z, h = Z[r], Zh[r]
                acc[lanes, :, :P] += z[:, :, None] * h[:, None, :]
                acc[lanes, :, P] += z * z
                acc[lanes, :, P + 1] += h * h
            for o in (16, 8, 4, 2, 1):
                acc = acc[:o] + acc[o: 2 * o]
            part = part + acc[0]
        tot = tot + part
    return tot


def _kernel_order_log_p_and_grads(Z, Zh, log_p, ghat):
    """log_p and (dZ, dZhat) from the kernel-order totals, with the
    kernels' formulas."""
    P = Z.shape[1]
    tot = _kernel_order_totals(Z, Zh)
    sq_z, sq_h = tot[:, P], tot[:, P + 1]
    zn = np.sqrt(np.where(sq_z == 0, np.float32(1), sq_z))
    hn = np.sqrt(np.where(sq_h == 0, np.float32(1), sq_h))
    den = zn[:, None] * hn[None, :]
    zz = tot[:, :P] / den
    mx = zz.max(axis=1)
    lp = np.diagonal(zz) - (mx + np.log(np.exp(zz - mx[:, None]).sum(axis=1)))
    lse = np.diagonal(zz) - log_p
    G = ghat[:, None] * (np.eye(P, dtype=np.float32)
                         - np.exp(zz - lse[:, None]))
    Gn = G / den
    rowterm = -(G * zz).sum(axis=1) / (zn * zn)
    colterm = -(G * zz).sum(axis=0) / (hn * hn)
    dZ = Zh @ Gn.T + Z * rowterm[None, :]
    dZh = Z @ Gn + Zh * colterm[None, :]
    return lp.astype(np.float32), dZ, dZh


@pytest.mark.parametrize("shape", [(128, 32, 3, 3), (4099, 1, 3, 3)])
def test_kernel_order_of_sums_matches_pallas(shape):
    """Summed in the cluster kernels' order (lanes, warps, then ranks), the
    forward and the backward stay within the file's tolerances of the
    Pallas kernels in interpret mode: the new order keeps the port within
    tolerance of the JAX package at D = 4096 (the path) and 4099."""
    z, zh = _pair(shape, 7)
    Z, Zh = _flat(z), _flat(zh)
    P = Z.shape[1]
    want_lp = np.asarray(jinfonce._log_p_pallas(jnp.asarray(Z), jnp.asarray(Zh),
                                                interpret=True))
    ghat = np.random.default_rng(8).standard_normal(P).astype(np.float32)
    wz, wzh = jinfonce._grads_pallas(jnp.asarray(Z), jnp.asarray(Zh),
                                     jnp.asarray(want_lp), jnp.asarray(ghat),
                                     interpret=True)
    lp, dZ, dZh = _kernel_order_log_p_and_grads(Z, Zh, want_lp, ghat)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dZ, np.asarray(wz), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dZh, np.asarray(wzh), rtol=1e-4, atol=1e-6)


def test_branch_argument_is_checked():
    """A launch takes plan's branch unless told otherwise; the cluster
    branch refuses a P above CLUSTER_MAX_P, and an unknown branch raises."""
    assert tinfonce._branch(4096, 9, None) == "cluster"
    assert tinfonce._branch(4096, 33, None) == "rows"
    assert tinfonce._branch(4096, 9, "rows") == "rows"
    assert tinfonce._branch(4096, 32, "cluster") == "cluster"
    with pytest.raises(ValueError, match="cluster branch"):
        tinfonce._branch(4096, 33, "cluster")
    with pytest.raises(ValueError, match="does not take"):
        tinfonce._branch(4096, 9, "tiles")
