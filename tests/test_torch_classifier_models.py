"""The port's classifier models (``models/simple.py``, ``models/resnet.py``),
their flat codec and ``bridge.py`` against the JAX package.

- Block ids and sizes equal for Net, Net1, Net2, ResNet9 and ResNet18
  (ResNet18's largest block [54,59] is N = 4,720,640).
- ``get_trainable_values`` equal elementwise to the JAX one at bridged
  weights (the flat vector keeps the JAX order: HWIO conv kernels,
  [in, out] dense kernels).
- Logits and BatchNorm running statistics at bridged weights, in train and
  eval mode, with and without pad rows: rtol 1e-4, atol 1e-5 (float32
  convolutions summed in other orders on the two sides; the running
  statistics are means over the batch, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models.resnet import ResNet9 as JResNet9
from federated_pytorch_test_tpu.models.resnet import ResNet18 as JResNet18
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.models.simple import Net1 as JNet1
from federated_pytorch_test_tpu.models.simple import Net2 as JNet2
from federated_pytorch_test_tpu.utils import blocks as jblocks
from federated_pytorch_test_tpu.utils import codec as jcodec
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.models.resnet import ResNet9, ResNet18
from federated_pytorch_test_tpu_torch.models.simple import Net, Net1, Net2
from federated_pytorch_test_tpu_torch.utils import blocks, codec
from federated_pytorch_test_tpu_torch.utils.tree import tree_map

PAIRS = {"net": (JNet, Net), "net1": (JNet1, Net1), "net2": (JNet2, Net2),
         "resnet9": (JResNet9, ResNet9), "resnet18": (JResNet18, ResNet18)}
X0 = jnp.zeros((1, 32, 32, 3), jnp.float32)


def _jax_shapes(jm):
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), X0, train=False))
    return v["params"]


def _jax_vars(jm, seed=0):
    p, bs = jm.init_variables(jax.random.PRNGKey(seed), X0, train=False)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, bs)


@pytest.mark.parametrize("name", list(PAIRS))
def test_blocks_and_sizes_equal(name):
    jcls, tcls = PAIRS[name]
    jm, tm = jcls(), tcls()
    assert tm.param_order() == jm.param_order()
    assert tm.train_order_block_ids() == jm.train_order_block_ids()
    assert tm.linear_layer_ids() == jm.linear_layer_ids()
    jp = _jax_shapes(jm)
    tp, _ = tm.init_variables(torch.Generator().manual_seed(0))
    order = tm.param_order()
    for ids in tm.train_order_block_ids():
        jmask = jblocks.build_mask(jax.tree.map(lambda _: 0, jp),
                                   jblocks.block_paths(order, ids))
        tmask = blocks.build_mask(tp, blocks.block_paths(order, ids))
        jn = sum(int(np.prod(jcodec.get_by_path(jp, q).shape))
                 for q in jcodec.active_paths_in_order(order, jmask))
        assert codec.masked_size(tp, order, tmask) == jn
    if name == "resnet18":
        big = blocks.build_mask(tp, blocks.block_paths(order, [54, 59]))
        assert codec.masked_size(tp, order, big) == 4_720_640


@pytest.mark.parametrize("name", ["net", "net1", "resnet9"])
def test_trainable_values_equal_at_bridged_weights(name):
    jcls, tcls = PAIRS[name]
    jm, tm = jcls(), tcls()
    jp, _ = _jax_vars(jm)
    tp = bridge.tree_from_jax(jp)
    order = tm.param_order()
    for ids in tm.train_order_block_ids():
        paths = blocks.block_paths(order, ids)
        want = np.asarray(jcodec.get_trainable_values(
            jp, order, jblocks.build_mask(jax.tree.map(lambda _: 0, jp), paths)))
        mask = blocks.build_mask(tp, paths)
        got = codec.get_trainable_values(tp, order, mask)
        np.testing.assert_array_equal(got.numpy(), want)
        # and back: put then get is the identity, leaves in torch layout
        back = codec.put_trainable_values(tp, order, mask, got)
        for p in paths:
            torch.testing.assert_close(codec.get_by_path(back, p),
                                       codec.get_by_path(tp, p), rtol=0, atol=0)


def test_stacked_codec_roundtrip():
    tm = Net1()
    tp, _ = tm.init_variables(torch.Generator().manual_seed(1))
    stacked = tree_map(lambda t: torch.stack([t, 2 * t, -t]), tp)
    order = tm.param_order()
    mask = blocks.build_mask(tp, blocks.block_paths(order, [8, 9]))
    X = codec.get_trainable_stack(stacked, order, mask)
    assert X.shape == (3, 1600 * 512 + 512)
    torch.testing.assert_close(X[1], 2 * codec.get_trainable_values(tp, order, mask))
    back = codec.put_trainable_stack(stacked, order, mask, X + 1)
    torch.testing.assert_close(codec.get_trainable_stack(back, order, mask), X + 1)


def _images(B, seed=0):
    return np.random.default_rng(seed).normal(size=(B, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["net", "net1", "net2"])
def test_simple_logits_match(name):
    jcls, tcls = PAIRS[name]
    jm, tm = jcls(), tcls()
    jp, _ = _jax_vars(jm, seed=2)
    x = _images(5)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), train=True))
    got, _ = tm.apply(bridge.tree_from_jax(jp), {},
                      torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("pad", [False, True])
def test_resnet_logits_and_stats_match(norm, pad):
    jm, tm = JResNet9(norm=norm), ResNet9(norm=norm)
    jp, jbs = _jax_vars(jm, seed=3)
    # non-trivial running statistics, so eval mode reads them
    rng = np.random.default_rng(4)
    jbs = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape))
                       .astype(np.float32), jbs)
    x = _images(6, seed=5)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if pad else None
    variables = {"params": jp, "batch_stats": jbs} if jbs else {"params": jp}
    tp, tbs = bridge.tree_from_jax(jp), bridge.tree_from_jax(jbs)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = None if w is None else torch.from_numpy(w)

    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         sample_weight=None if w is None else jnp.asarray(w),
                         mutable=["batch_stats"])
    got, new_bs = tm.apply(tp, tbs, xt, train=True, sample_weight=wt)
    rows = slice(None) if w is None else slice(0, 4)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=1e-4, atol=1e-5)
    jax.tree.map(lambda g, e: np.testing.assert_allclose(
        g, np.asarray(e), rtol=1e-4, atol=1e-6),
        bridge.tree_to_jax(new_bs), mut.get("batch_stats", {}))

    want = jm.apply(variables, jnp.asarray(x), train=False)
    got, same = tm.apply(tp, tbs, xt, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert (norm == "group") == (same == {})


def test_bf16_compute_stays_close():
    jm, tm = JNet(dtype=jnp.bfloat16), Net(dtype=torch.bfloat16)
    jp, _ = _jax_vars(jm, seed=6)
    x = _images(4, seed=7)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    got, _ = tm.apply(bridge.tree_from_jax(jp), {},
                      torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    # bfloat16 keeps about 3 significant digits; rounding points differ
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


def test_bridge_roundtrip_stacked_state():
    jm = JResNet9()
    jp, jbs = _jax_vars(jm)
    stack = lambda t: jax.tree.map(lambda a: np.stack([a, a * 2]), t)
    p, bs = bridge.classifier_state_from_jax(stack(jp), stack(jbs))
    assert p["linear"]["kernel"].shape == (2, 10, 512)
    assert p["conv1"]["kernel"].shape == (2, 64, 3, 3, 3)
    assert bs["layer1_0"]["bn1"]["var"].shape == (2, 64)
    bp, bbs = bridge.classifier_state_to_jax(p, bs)
    jax.tree.map(np.testing.assert_array_equal, bp, stack(jp))
    jax.tree.map(np.testing.assert_array_equal, bbs, stack(jbs))
