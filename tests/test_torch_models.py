"""The port's CPC models (``models/cpc.py``) against the JAX package's, at
weights carried across with ``bridge.py``, and ``nn.Conv2d(dilation=d)``
against the JAX ``dilated_conv_taps`` the encoder stem uses.

Tolerance: float32 convolutions whose sums run in different orders on the
two sides: rtol 1e-4, atol 1e-5 on activations of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from federated_pytorch_test_tpu.models import cpc as jcpc
from federated_pytorch_test_tpu.ops.dilated_conv import dilated_conv_taps
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.models import cpc as tcpc

TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("L", [8, 16])
def test_encoder_matches_jax(L):
    rng = np.random.default_rng(L)
    x = rng.standard_normal((5, 32, 32, 8)).astype(np.float32)
    jm = jcpc.EncoderCNN(latent_dim=L)
    jp, _ = jm.init_variables(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    tm = bridge.load_module(tcpc.EncoderCNN(L), jax.tree.map(np.asarray, jp))
    got = tm(_nchw(x)).detach().numpy()
    assert got.shape == want.shape == (5, L)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("px,py", [(3, 3), (2, 4)])
def test_contextgen_matches_jax(px, py):
    L = 16
    rng = np.random.default_rng(px * 10 + py)
    x = rng.standard_normal((4, px, py, L)).astype(np.float32)
    jm = jcpc.ContextgenCNN(latent_dim=L)
    jp, _ = jm.init_variables(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    tm = bridge.load_module(tcpc.ContextgenCNN(L), jax.tree.map(np.asarray, jp))
    got = _to_nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_predictor_matches_jax():
    L, R = 16, 4
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((4, 3, 3, L)).astype(np.float32)
    ctx = rng.standard_normal((4, 3, 3, L)).astype(np.float32)
    jm = jcpc.PredictorCNN(latent_dim=L, reduced_dim=R)
    jp, _ = jm.init_variables(jax.random.PRNGKey(3), jnp.asarray(lat),
                              jnp.asarray(ctx))
    wr, wp = jm.apply({"params": jp}, jnp.asarray(lat), jnp.asarray(ctx))
    tm = bridge.load_module(tcpc.PredictorCNN(L, R), jax.tree.map(np.asarray, jp))
    gr, gp = tm(_nchw(lat), _nchw(ctx))
    np.testing.assert_allclose(_to_nhwc(gr), np.asarray(wr), **TOL)
    np.testing.assert_allclose(_to_nhwc(gp), np.asarray(wp), **TOL)


@pytest.mark.parametrize("d,p", list(tcpc.STEM))
def test_dilated_conv2d_matches_taps(d, p):
    """The encoder stem's nn.Conv2d(dilation=d) against the tap-gather
    lowering the JAX encoder runs (4x4, stride 2, 32x32 input)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((3, 32, 32, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4, 8, 8)).astype(np.float32) * 0.1   # HWIO
    b = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(dilated_conv_taps(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides=(2, 2),
        dilation=(d, d), padding=((p, p), (p, p))))
    got = F.conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                   torch.from_numpy(b), stride=2, padding=p, dilation=d)
    assert _to_nhwc(got).shape == want.shape == (3, 16, 16, 8)
    np.testing.assert_allclose(_to_nhwc(got), want, **TOL)


def test_param_tree_names_and_layout():
    tm = tcpc.EncoderCNN(16)
    tree = tm.param_tree()
    assert sorted(tree) == sorted({p.split("/")[0] for p in tm.param_order()})
    assert tree["conv1_16"]["kernel"].shape == (8, 8, 4, 4)       # OIHW
    assert tree["conv2"]["bias"].shape == (4,)
