"""The port's VAE models (``models/vae.py``, ``models/vae_cl.py``), their
transposed convolution and ``bridge.py`` against the JAX package.

- ``conv_transpose`` against flax ``nn.ConvTranspose((4, 4), strides 2,
  "SAME")`` at the decoders' shapes: max abs difference at most 1e-5 x the
  largest |flax value|.  The same kernel without the flip must miss by
  more than 10% of it (flax does not flip the kernel; torch does).
- Parameter order, training blocks, layer paths and leaf shapes equal.
- Both models' forward at bridged seeded weights (no bias zero) with the JAX noise injected: every output within
  1e-5 x its largest |JAX value| (float32 convolutions summed in other
  orders).  VAE-CL at Kc=3, Lc=5 and at the reference Kc=10, Lc=32.
- The gradients of each model's loss in every leaf within 1e-4 x the
  leaf's largest |JAX gradient| (sums over batch and pixels; measured at
  most 2.9e-5), except VAE-CL's cluster head fc11-fc13 at 1e-3: its
  gradient is a difference of per-cluster costs of about 1e4 through the
  softmax (measured 1.1e-4 to 1.4e-4).
- The bridge's round trip of a stacked VAE tree is exact.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models.vae import AutoEncoderCNN as JVAE
from federated_pytorch_test_tpu.models.vae_cl import AutoEncoderCNNCL as JVAECL
from federated_pytorch_test_tpu.train import vae_losses as jloss
from federated_pytorch_test_tpu.utils import blocks as jblocks
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.models.base import conv_transpose
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.models.vae_cl import AutoEncoderCNNCL
from federated_pytorch_test_tpu_torch.train import vae_losses as tloss
from federated_pytorch_test_tpu_torch.utils import blocks
from federated_pytorch_test_tpu_torch.utils.codec import from_jax_layout

FWD_REL = 1e-5
GRAD_REL = 1e-4
HEAD_REL = 1e-3
B = 4


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nchw(a):
    """JAX NHWC [..., H, W, C] -> the port's [..., C, H, W]."""
    return np.moveaxis(np.asarray(a), -1, -3)


def _jax_shapes(jm):
    key = jax.random.PRNGKey(0)
    v = jax.eval_shape(lambda: jm.init(key, jnp.zeros((1, 32, 32, 3)), key))
    return jax.tree.map(lambda a: a.shape, v["params"])


def _jax_params(jm, seed: int):
    """Seeded weights of the JAX tree's shapes: kernels of variance
    1/fan_in, biases 0.05 x a standard normal (none zero)."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        scale = (1.0 / np.sqrt(np.prod(shape[:-1])) if len(shape) > 1
                 else 0.05)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree.map(draw, _jax_shapes(jm),
                        is_leaf=lambda a: isinstance(a, tuple))


def _port_params(jp):
    return bridge.tree_from_jax(jp)


def _images(seed: int, n: int = B):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("cin,cout,hw", [(96, 48, 2), (48, 24, 4),
                                         (24, 12, 8), (12, 3, 16)])
def test_conv_transpose_matches_flax(cin, cout, hw):
    rng = np.random.default_rng(cin)
    m = nn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    k = rng.standard_normal((4, 4, cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = np.asarray(m.apply({"params": {"kernel": k, "bias": b}}, x))
    p = {"kernel": from_jax_layout(torch.from_numpy(k)),
         "bias": torch.from_numpy(b)}
    got = conv_transpose(torch.from_numpy(x).permute(0, 3, 1, 2), p)
    assert tuple(got.shape) == (2, cout, 2 * hw, 2 * hw)
    assert _rel_err(got.numpy(), _nchw(want)) <= FWD_REL
    # the flip is what makes them agree
    unflipped = dict(p, kernel=p["kernel"].flip(2, 3))
    miss = conv_transpose(torch.from_numpy(x).permute(0, 3, 1, 2), unflipped)
    assert _rel_err(miss.numpy(), _nchw(want)) > 0.1


@pytest.mark.parametrize("jcls,tcls,kw", [
    (JVAE, AutoEncoderCNN, {}), (JVAECL, AutoEncoderCNNCL, {"K": 3, "L": 5}),
    (JVAECL, AutoEncoderCNNCL, {})])
def test_orders_blocks_layers_and_shapes_equal(jcls, tcls, kw):
    jm, tm = jcls(**kw), tcls(**kw)
    order = tm.param_order()
    assert order == jm.param_order()
    assert tm.train_order_block_ids() == jm.train_order_block_ids()
    for i in range((len(order) + 1) // 2 + 1):
        assert blocks.layer_paths(order, i) == jblocks.layer_paths(order, i)
    tp, _ = tm.init_variables(torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, bridge.tree_to_jax(tp))
    assert got == _jax_shapes(jm)


def _vae_pair(seed):
    jm, tm = JVAE(), AutoEncoderCNN()
    jp = _jax_params(jm, seed)
    x = _images(seed)
    key = jax.random.PRNGKey(seed + 1)
    eps = np.array(jax.random.normal(key, (B, 10)))
    return jm, tm, jp, x, key, eps


def test_vae_forward_matches_jax():
    jm, tm, jp, x, key, eps = _vae_pair(3)
    want = jax.jit(jm.apply)({"params": jp}, x, key)
    got = tm.apply(_port_params(jp), torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(eps))
    assert _rel_err(got[0].numpy(), _nchw(want[0])) <= FWD_REL
    for g, w in zip(got[1:], want[1:]):
        assert _rel_err(g.numpy(), w) <= FWD_REL


def test_vae_gradients_match_jax():
    jm, tm, jp, x, key, eps = _vae_pair(4)
    w = np.array([1, 1, 1, 0], np.float32)

    def jfn(p):
        recon, mu, logvar = jm.apply({"params": p}, x, key)
        return jloss.vae_loss(recon, x, mu, logvar, w)

    jl, jg = jax.jit(jax.value_and_grad(jfn))(jp)
    tp = _port_params(jp)
    leaves = [t.requires_grad_(True) for m in tp.values() for t in m.values()]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    recon, mu, logvar = tm.apply(tp, xt, torch.from_numpy(eps))
    tl = tloss.vae_loss(recon, xt, mu, logvar, torch.from_numpy(w))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= FWD_REL * abs(float(jl))
    tg = bridge.tree_to_jax({m: {n: t.grad for n, t in leaves_.items()}
                             for m, leaves_ in tp.items()})
    for path in jm.param_order():
        mod, leaf = path.split("/")
        assert _rel_err(tg[mod][leaf], jg[mod][leaf]) <= GRAD_REL, path
    assert len(leaves) == 24


def _cl_pair(seed, K, L):
    jm, tm = JVAECL(K=K, L=L), AutoEncoderCNNCL(K=K, L=L)
    jp = _jax_params(jm, seed)
    x = _images(seed)
    key = jax.random.PRNGKey(seed + 1)
    eps = np.stack([np.array(jax.random.normal(k, (B, L)))
                    for k in jax.random.split(key, K)])
    return jm, tm, jp, x, key, eps


@pytest.mark.parametrize("K,L", [(3, 5), (10, 32)])
def test_vae_cl_forward_matches_jax(K, L):
    jm, tm, jp, x, key, eps = _cl_pair(5, K, L)
    fwd = jax.jit(jm.apply, static_argnames="reparam")
    want = fwd({"params": jp}, x, key, reparam=True)
    got = tm.apply(_port_params(jp), torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(eps))
    assert len(got) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        w = _nchw(w) if i >= 5 else np.asarray(w)
        assert _rel_err(g.detach().numpy(), w) <= FWD_REL, i


def test_vae_cl_gradients_match_jax():
    jm, tm, jp, x, key, eps = _cl_pair(6, 3, 5)
    w = np.array([1, 0, 1, 1], np.float32)

    def jfn(p):
        out = jm.apply({"params": p}, x, key, reparam=True)
        return jloss.vae_cl_loss(*out, x, w=w)

    jl, jg = jax.jit(jax.value_and_grad(jfn))(jp)
    tp = _port_params(jp)
    for m in tp.values():
        for t in m.values():
            t.requires_grad_(True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tl = tloss.vae_cl_loss(*tm.apply(tp, xt, torch.from_numpy(eps)), xt,
                           w=torch.from_numpy(w))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= FWD_REL * abs(float(jl))
    tg = bridge.tree_to_jax({m: {n: t.grad for n, t in leaves.items()}
                             for m, leaves in tp.items()})
    for path in jm.param_order():
        mod, leaf = path.split("/")
        rel = HEAD_REL if mod in ("fc11", "fc12", "fc13") else GRAD_REL
        assert _rel_err(tg[mod][leaf], jg[mod][leaf]) <= rel, path


@pytest.mark.parametrize("jcls,kw", [(JVAE, {}), (JVAECL, {"K": 3, "L": 5})])
def test_bridge_round_trip_is_exact(jcls, kw):
    jp = _jax_params(jcls(**kw), 7)
    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a, -a]), jp)
    tp = bridge.tree_from_jax(stacked, stacked=True)
    assert tuple(tp["tconv1"]["kernel"].shape[:2]) == (3, 48)
    back = bridge.tree_to_jax(tp, stacked=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(stacked)):
        assert a.shape == b.shape and np.array_equal(a, b)
