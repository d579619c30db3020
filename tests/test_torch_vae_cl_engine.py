"""The port's ``VAECLTrainer`` (``train/vae_engine.py``) against the JAX
package's, from the same weights and the same reparametrisation draws
(``tests/_torch_vae_pair.py``): K=2 clients, 40 images each in batches of
16 (3 steps an epoch, the last with 8 pad rows), 32 test images, FedAvg,
Nloop 1, Nadmm 1, every round evaluated, over its three blocks (Kc=3,
Lc=4, lambda2 1e-3; L-BFGS history 10, 4 iterations on the encoder and
decoder, Adam lr 1e-4 on the latent block).

- On the first L-BFGS block (the encoder), each client's closure-evaluation
  count (``func_evals``) and iteration count equal JAX's.
- Over the three blocks, held looser as the classifier's L-BFGS parity is
  (the line search's decisions may part once the iterates differ by
  rounding): losses and test ELBOs at rtol 1e-4 (measured 8e-7), final
  parameters within 1e-3 (measured 1.0e-4).
- The optimizer switches per block, and the latent block's Adam count
  starts afresh at that block.
- Every closure evaluation of a step's line search sees that step's one
  noise draw.
- The driver ``federated_vae_cl`` through its ``main`` (its DEFAULTS, the
  JAX driver's, at K=2, Kc=3, Lc=4 and the sizes above) from the same
  start: the same rounds and parameters as the trainer built here, bit for
  bit, and so JAX's within the tolerances above.
"""

import numpy as np
import pytest
import torch

from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from _torch_vae_pair import (
    K, driver_argv, max_diff, run_both, run_port_driver, same_rounds)
from federated_pytorch_test_tpu.models.vae_cl import AutoEncoderCNNCL as JVAECL
from federated_pytorch_test_tpu.train.vae_engine import VAECLTrainer as JCLTrainer
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import federated_vae_cl
from federated_pytorch_test_tpu_torch.models.vae_cl import AutoEncoderCNNCL
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSState
from federated_pytorch_test_tpu_torch.train.algorithms import FedAvg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import AdamState
from federated_pytorch_test_tpu_torch.train.vae_engine import VAECLTrainer


def _capture_block0(trainer, store: dict, key: str):
    """Wrap ``trainer``'s per-block train function so that the optimizer
    state after each epoch of block 0 lands in ``store[key]``."""
    if hasattr(trainer, "_build_fns"):                 # the JAX engine
        build = trainer._build_fns

        def wrapped(ci):
            fns = build(ci)
            if ci != 0:
                return fns

            def epoch(state, *args):
                out = fns[0](state, *args)
                store[key] = out[0].opt_state
                return out

            return (epoch,) + tuple(fns[1:])

        trainer._build_fns = wrapped
    else:
        train_epoch = trainer.train_epoch

        def epoch(state, ci, *args, **kw):
            out = train_epoch(state, ci, *args, **kw)
            if ci == 0:
                store[key] = out[0].opt_state
            return out

        trainer.train_epoch = epoch


@pytest.fixture(scope="module")
def vae_cl():
    store = {}
    out = run_both(JCLTrainer, VAECLTrainer, JVAECL(K=3, L=4),
                   AutoEncoderCNNCL(K=3, L=4),
                   dict(Nadmm=1, lambda2=1e-3, check_results=True),
                   biased_input=False,
                   prepare=lambda jt, tt: (_capture_block0(jt, store, "j"),
                                           _capture_block0(tt, store, "t")))
    out["block0"] = store
    return out


def test_vae_cl_first_lbfgs_block_evaluations_equal(vae_cl):
    js, ts = vae_cl["block0"]["j"], vae_cl["block0"]["t"]
    assert len(ts) == K and all(isinstance(s, LBFGSState) for s in ts)
    for f in ("func_evals", "n_iter_total"):
        assert [getattr(s, f) for s in ts] == np.asarray(
            getattr(js, f)).tolist(), f
    assert all(s.func_evals > s.n_iter_total for s in ts)


def test_vae_cl_three_blocks_track_jax(vae_cl):
    jh, th = vae_cl["jhist"], vae_cl["thist"]
    assert [r["block"] for r in th] == [0, 1, 2]
    assert [r["N"] for r in th] == [r["N"] for r in jh]
    assert [r["host_dispatches"] for r in th] == \
        [r["host_dispatches"] for r in jh]
    for j, t in zip(jh, th):
        assert np.isfinite(t["loss"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=1e-4)
    assert max_diff(vae_cl["tparams"], vae_cl["jparams"]) <= 1e-3


def test_vae_cl_switches_optimizer_per_block(vae_cl):
    tt = vae_cl["tt"]
    assert [tt.optimizer_for_block(ci) for ci in range(3)] == [
        "lbfgs", "lbfgs", "adam"]
    assert [tt.reg_for_block(ci) for ci in range(3)] == [(0.0, 1e-3)] * 3
    assert tt.lr_for_block(2) == 1e-4 and tt.lbfgs.lr == 1.0
    # the latent block ran Adam from a fresh count: one epoch of 3 steps,
    # counted per client
    opt = vae_cl["tstate"].opt_state
    assert isinstance(opt, AdamState) and opt.count.tolist() == [3, 3]


def test_lbfgs_line_search_reuses_the_step_draw():
    """Every closure evaluation of one step's L-BFGS sees the step's one
    draw (the JAX engine fixes fold_in(key, step) for the whole step)."""
    tt = VAECLTrainer(AutoEncoderCNNCL(K=2, L=3),
                      TConfig(K=1, default_batch=8, device="cpu"),
                      TData(K=1, batch=8, limit_per_client=16, limit_test=8),
                      FedAvg())
    seen = []
    loss = tt.model_loss

    def recording(p, bs, xb, yb, wb, noise=None):
        seen.append(noise)
        return loss(p, bs, xb, yb, wb, noise)

    tt.model_loss = recording
    xb, yb, wb = (torch.from_numpy(a) for a in tt.data.epoch_batches_raw(1))
    state = tt.init_state()
    state = state._replace(opt_state=tt.init_opt(state.params, 0))
    z = torch.zeros(tt.block_size(0))
    state, _ = tt.train_epoch(state, 0, torch.zeros(1, 1), z,
                              torch.tensor(1.0), xb, yb, wb, counter=5)
    tt.close()
    steps = xb.shape[1]
    assert steps == 2 and len(seen) >= state.opt_state[0].func_evals > steps
    draws = {id(n) for n in seen}
    assert len(draws) == steps
    assert torch.equal(seen[0], tt.noise((tt.cfg.seed, 5, 0, 0), 8))
    assert torch.equal(seen[-1], tt.noise((tt.cfg.seed, 5, 0, 1), 8))


def test_federated_vae_cl_matches_the_jax_engine(vae_cl, monkeypatch):
    hist, params = run_port_driver(monkeypatch, federated_vae_cl,
                                   vae_cl["p0"],
                                   driver_argv(K, "--Kc", "3", "--Lc", "4"))
    assert same_rounds(hist, vae_cl["thist"])
    assert max_diff(params, vae_cl["tparams"]) == 0.0
    for j, t in zip(vae_cl["jhist"], hist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    assert max_diff(params, vae_cl["jparams"]) <= 1e-3
