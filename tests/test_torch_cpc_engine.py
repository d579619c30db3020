"""The slice as a whole: the port's CPC trainer (``train/cpc_engine.py``)
against the JAX ``CPCTrainer`` over one full rotation (4 blocks x Nadmm=2
communication rounds), both started from the JAX trainer's ``state0``
carried across with ``bridge.py``, on the same synthetic LOFAR data.

Tolerance: every round runs 2 clients x L-BFGS (history 7, max_iter 2,
backtracking line search) in float32, with sums in different orders on the
two sides; the discrete line-search choices agree, so per-round loss and
dual residual agree at rtol 1e-4 and the final parameters at atol 1e-5
(measured drift about 5e-6 on weights of order 1).  N and bytes_on_wire
are integers and must be equal.
"""

import jax
import numpy as np
import pytest

from federated_pytorch_test_tpu.data.lofar import CPCDataSource as JSource
from federated_pytorch_test_tpu.train.cpc_engine import CPCTrainer as JTrainer
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.data.lofar import CPCDataSource as TSource
from federated_pytorch_test_tpu_torch.drivers import federated_cpc
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.cpc_engine import CPCTrainer as TTrainer

FILES, SAPS = ["a.h5", "b.h5"], ["0", "1"]
GEOM = dict(latent_dim=8, reduced_dim=4, Niter=1)
NADMM = 2


def _port_trainer():
    return TTrainer(TSource(FILES, SAPS, batch_size=2, seed=7),
                    cfg=FederatedConfig(device="cpu"), **GEOM)


@pytest.fixture(scope="module")
def runs():
    jt = JTrainer(JSource(FILES, SAPS, batch_size=2, seed=7), **GEOM)
    jstate, jhist = jt.run(Nloop=1, Nadmm=NADMM, log=lambda m: None,
                           prefetch=False)
    state0 = bridge.cpc_state_from_jax(jax.tree.map(np.asarray, jt.state0))
    tt = _port_trainer()
    tstate, thist = tt.run(Nloop=1, Nadmm=NADMM, state=state0,
                           log=lambda m: None, prefetch=False)
    return dict(jstate=jax.tree.map(np.asarray, jstate._asdict()),
                jhist=jhist, tstate=tstate, thist=thist, state0=state0)


def test_rotation_order_and_counts(runs):
    want = [(r["model"], r["block"], r["nadmm"], r["N"], r["bytes_on_wire"])
            for r in runs["jhist"]]
    got = [(r["model"], r["block"], r["nadmm"], r["N"], r["bytes_on_wire"])
           for r in runs["thist"]]
    assert len(got) == 4 * NADMM
    assert got == want


@pytest.mark.parametrize("key", ["loss", "dual_residual"])
def test_round_metrics_match(runs, key):
    want = np.array([r[key] for r in runs["jhist"]])
    got = np.array([r[key] for r in runs["thist"]])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("mdl", ["encoder", "contextgen", "predictor"])
def test_final_params_match(runs, mdl):
    got = bridge.tree_to_jax(runs["tstate"][mdl], stacked=True)
    want = runs["jstate"][mdl]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                         atol=1e-5),
                 got, want)
    # every block trained and was written back identically to all clients
    before = bridge.tree_to_jax(runs["state0"][mdl], stacked=True)
    for g, b in zip(jax.tree.leaves(got), jax.tree.leaves(before)):
        assert not np.array_equal(g, b)
        np.testing.assert_array_equal(g[0], g[1])


def test_history_records_timing_fields(runs):
    for r in runs["thist"]:
        for k in ("stage_seconds", "compute_seconds", "round_seconds"):
            assert r[k] >= 0.0
        assert r["round_seconds"] >= r["compute_seconds"]
        # CPU tensors take the plain versions: no kernel launches
        assert r["kernel_launches"] == {"infonce_fwd": 0, "infonce_bwd": 0}


def test_prefetch_matches_direct():
    a = _port_trainer()
    sa, ha = a.run(Nloop=1, Nadmm=1, log=lambda m: None, prefetch=True)
    b = _port_trainer()
    sb, hb = b.run(Nloop=1, Nadmm=1, log=lambda m: None, prefetch=False)
    strip = lambda h: [{k: v for k, v in r.items() if not k.endswith("_seconds")}
                       for r in h]
    assert strip(ha) == strip(hb)
    jax.tree.map(np.testing.assert_array_equal,
                 bridge.cpc_state_to_jax(sa), bridge.cpc_state_to_jax(sb))


def test_driver_runs_on_cpu_when_asked():
    lines = []
    trainer, state, hist = federated_cpc.main(
        ["--device", "cpu", "--Lc", "8", "--Rc", "4", "--batch-size", "2",
         "--Niter", "1", "--file-list", *FILES, "--sap-list", *SAPS],
        log=lines.append)
    assert trainer.device.type == "cpu" and trainer.K == 2
    assert [(r["model"], r["block"]) for r in hist] == [
        ("encoder", 0), ("encoder", 1), ("contextgen", 0), ("predictor", 0)]
    assert lines[-1] == "Finished Training"
