"""The port's ``VAETrainer`` (``train/vae_engine.py``) against the JAX
package's, from the same weights and the same reparametrisation draws
(``tests/_torch_vae_pair.py``): K=2 clients, 40 images each in batches of
16 (3 steps an epoch, the last with 8 pad rows), 32 test images, FedAvg,
Nloop 1, Nadmm 1, every round evaluated, over the full layer sweep (12
layers of ``AutoEncoderCNN``, Adam lr 1e-3, no regulariser):

- each round's layer size equal, its loss at rtol 1e-5 (measured 1.3e-7),
  its dual residual at rtol 1e-5, each client's test ELBO at rtol 1e-5;
- the final parameters within 1e-5 (measured 3.4e-6), and z written back
  to both clients;
- the port's own draw: a pure function of (seed, epoch counter, client,
  step), and the evaluation's fixed draw;
- the driver ``federated_vae`` through its ``main`` (its DEFAULTS, the JAX
  driver's, cut to the sizes above) from the same start: the same rounds
  and parameters as the trainer built here, bit for bit, and so JAX's
  within the tolerances above.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from _torch_vae_pair import (
    K, driver_argv, max_diff, run_both, run_port_driver, same_rounds)
from federated_pytorch_test_tpu.models.vae import AutoEncoderCNN as JVAE
from federated_pytorch_test_tpu.train.vae_engine import VAETrainer as JTrainer
from federated_pytorch_test_tpu_torch.drivers import federated_vae
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.train.engine import EVAL_NOISE_WORDS, torch_normal
from federated_pytorch_test_tpu_torch.train.vae_engine import VAETrainer


@pytest.fixture(scope="module")
def vae():
    return run_both(JTrainer, VAETrainer, JVAE(), AutoEncoderCNN(),
                    dict(Nadmm=1, check_results=True))


def test_vae_sweeps_every_layer(vae):
    jh, th = vae["jhist"], vae["thist"]
    assert len(th) == len(jh) == 12
    assert [r["block"] for r in th] == list(range(12))
    assert [r["N"] for r in th] == [r["N"] for r in jh]
    assert [r["host_dispatches"] for r in th] == \
        [r["host_dispatches"] for r in jh] == [1] * 12
    assert sum(r["N"] for r in th) == sum(
        np.asarray(a[0]).size for a in jax.tree.leaves(vae["p0"]))


def test_vae_rounds_match_jax(vae):
    for j, t in zip(vae["jhist"], vae["thist"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["dual_residual"], j["dual_residual"],
                                   rtol=1e-5)
        np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=1e-5)
        assert t["kernel_launches"] == {k: 0 for k in t["kernel_launches"]}


def test_vae_final_params_match_jax_and_z_is_written_back(vae):
    assert max_diff(vae["tparams"], vae["jparams"]) <= 1e-5
    for a in jax.tree.leaves(vae["tparams"]):
        assert np.array_equal(a[0], a[1])
    assert vae["tt"].reg_for_block(4) == (0.0, 0.0)


def test_noise_is_a_pure_function_of_seed_epoch_client_and_step(vae):
    tt = vae["tt"]
    tt.normal = torch_normal
    seed = tt.cfg.seed
    a = tt.noise((seed, 3, 1, 2), 16)
    assert tuple(a.shape) == (16, 10) and a.dtype == torch.float32
    assert torch.equal(a, tt.noise((seed, 3, 1, 2), 16))
    for other in ((seed + 1, 3, 1, 2), (seed, 4, 1, 2), (seed, 3, 0, 2),
                  (seed, 3, 1, 1), EVAL_NOISE_WORDS):
        assert not torch.equal(a, tt.noise(other, 16))
    assert torch.equal(a, torch_normal((seed, 3, 1, 2), (16, 10), "cpu"))


def test_federated_vae_matches_the_jax_engine(vae, monkeypatch):
    hist, params = run_port_driver(monkeypatch, federated_vae, vae["p0"],
                                   driver_argv(K))
    assert same_rounds(hist, vae["thist"])
    assert max_diff(params, vae["tparams"]) == 0.0
    for j, t in zip(vae["jhist"], hist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    assert max_diff(params, vae["jparams"]) <= 1e-5
