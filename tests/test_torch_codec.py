"""The port's blocks and flat codec (``utils/blocks.py``, ``utils/codec.py``)
against the JAX package's.  Block sizes and flat vectors are compared
exactly: the codec only reorders elements, so no rounding can enter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import cpc as jcpc
from federated_pytorch_test_tpu.utils import blocks as jblocks
from federated_pytorch_test_tpu.utils import codec as jcodec
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.models import cpc as tcpc
from federated_pytorch_test_tpu_torch.utils import blocks as tblocks
from federated_pytorch_test_tpu_torch.utils import codec as tcodec


def _models(L, R):
    return {
        "encoder": (jcpc.EncoderCNN(latent_dim=L), tcpc.EncoderCNN(L),
                    (jnp.zeros((1, 32, 32, 8)),)),
        "contextgen": (jcpc.ContextgenCNN(latent_dim=L), tcpc.ContextgenCNN(L),
                       (jnp.zeros((1, 2, 2, L)),)),
        "predictor": (jcpc.PredictorCNN(latent_dim=L, reduced_dim=R),
                      tcpc.PredictorCNN(L, R),
                      (jnp.zeros((1, 2, 2, L)), jnp.zeros((1, 2, 2, L)))),
    }


def _jax_params(jm, args, seed=0):
    return jm.init_variables(jax.random.PRNGKey(seed), *args)[0]


BLOCKS = [("encoder", 0), ("encoder", 1), ("contextgen", 0), ("predictor", 0)]


@pytest.mark.parametrize("mdl,ci", BLOCKS)
def test_block_sizes_match_jax_at_reference_width(mdl, ci):
    """N of every CPC block at Lc=256, Rc=32 (the driver defaults)."""
    jm, tm, args = _models(256, 32)[mdl]
    jshapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    jp = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                      dict(jshapes["params"]))
    order = jm.param_order()
    assert tm.param_order() == order
    assert tm.train_order_block_ids() == jm.train_order_block_ids()
    paths = jblocks.block_paths(order, jm.train_order_block_ids()[ci])
    assert tblocks.block_paths(order, tm.train_order_block_ids()[ci]) == paths
    want = jcodec.masked_size(jp, order, jblocks.build_mask(jp, paths))
    tp = tm.param_tree()
    got = tcodec.masked_size(tp, order, tblocks.build_mask(tp, paths))
    assert got == want


@pytest.mark.parametrize("mdl,ci", BLOCKS)
def test_flat_vector_of_bridged_weights_equals_jax(mdl, ci):
    jm, tm, args = _models(16, 8)[mdl]
    jp = _jax_params(jm, args, seed=ci + 1)
    order = jm.param_order()
    paths = jblocks.block_paths(order, jm.train_order_block_ids()[ci])
    want = np.asarray(jcodec.get_trainable_values(
        jp, order, jblocks.build_mask(jp, paths)))
    tp = bridge.tree_from_jax(jax.tree.map(np.asarray, jp))
    got = tcodec.get_trainable_values(tp, order, tblocks.build_mask(tp, paths))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mdl,ci", BLOCKS)
def test_put_matches_jax_and_roundtrips(mdl, ci):
    """put(v) writes the same leaves as the JAX codec, and get(put(v)) == v."""
    jm, tm, args = _models(16, 8)[mdl]
    jp = _jax_params(jm, args)
    order = jm.param_order()
    paths = jblocks.block_paths(order, jm.train_order_block_ids()[ci])
    jmask = jblocks.build_mask(jp, paths)
    n = jcodec.masked_size(jp, order, jmask)
    v = np.random.default_rng(ci).standard_normal(n).astype(np.float32)
    want = jax.tree.map(np.asarray,
                        jcodec.put_trainable_values(jp, order, jmask,
                                                    jnp.asarray(v)))
    tp = bridge.tree_from_jax(jax.tree.map(np.asarray, jp))
    tmask = tblocks.build_mask(tp, paths)
    put = tcodec.put_trainable_values(tp, order, tmask, torch.from_numpy(v))
    got = bridge.tree_to_jax(put)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    np.testing.assert_array_equal(
        tcodec.get_trainable_values(put, order, tmask).numpy(), v)


def test_put_keeps_autograd_to_the_flat_vector():
    tm = tcpc.PredictorCNN(8, 4)
    tp = tm.param_tree()
    order = tm.param_order()
    mask = tblocks.build_mask(tp, order)
    v = tcodec.get_trainable_values(tp, order, mask).clone().requires_grad_(True)
    put = tcodec.put_trainable_values(tp, order, mask, v)
    (put["conv1"]["kernel"].sum() + 2 * put["conv2"]["kernel"].sum()).backward()
    half = v.numel() // 2
    assert torch.equal(v.grad[:half], torch.ones(half))
    assert torch.equal(v.grad[half:], torch.full((half,), 2.0))


def test_stacked_state_bridge_roundtrip():
    rng = np.random.default_rng(0)
    tree = {"conv": {"kernel": rng.standard_normal((3, 2, 2, 4, 5)).astype(np.float32),
                     "bias": rng.standard_normal((3, 5)).astype(np.float32)}}
    t = bridge.tree_from_jax(tree, stacked=True)
    assert t["conv"]["kernel"].shape == (3, 5, 4, 2, 2)       # [K, O, I, H, W]
    back = bridge.tree_to_jax(t, stacked=True)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
