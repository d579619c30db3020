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
