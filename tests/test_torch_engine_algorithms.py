"""The port's classifier engine under each algorithm against the JAX
``BlockwiseFederatedTrainer``: FedAvg (z written back to every client),
FedProx (the proximal penalty, no write-back) and ADMM consensus with the
Barzilai-Borwein rho at Nadmm = 4 and ``bb_period_T = 2``, so that round 0
stores the BB history and round 2 runs the ``"bb"`` update.  With the
default ``bb_rhomax`` of 0.1 every BB candidate of this toy run is
rejected (block 0's is about 330), so the case raises ``bb_rhomax`` to
1000: block 0 then takes the BB rho in round 2, block 1 rejects its
candidate (a negative correlation), and both branches of the rule run.

K=4 on Net, two blocks, batch 16, 40 images per client, both sides from the
JAX trainer's weights (``tests/_torch_engine_pair.py``); FedAvg and FedProx
at D=1, ADMM-BB over a 2-shard mesh.

Tolerances are those of the consensus engine test
(``tests/test_torch_classifier_engine.py``), for the same reason: float32
sums in different orders, and Adam's normalised step moves an element
whose gradient is at rounding level by up to lr either way.  N and
bytes_on_wire equal; rho at rtol 1e-5 (it is rho0 but for the BB rho, a
ratio of sums over the block); loss at rtol 1e-4; residuals at rtol 1e-3; final
parameters at atol 5e-4; accuracy within one test image.  Measured
(FedAvg / FedProx / ADMM-BB): loss 3.6e-6 / 6.4e-6 / 5.3e-6, residuals
1.3e-4 / 6.0e-6 / 3.9e-6 (relative), parameters 3.8e-5 / 3.0e-8 / 1.6e-4
(absolute), BB rho 329.2669 against 329.2672 (9.3e-7 relative).
"""

import numpy as np
import pytest

from _torch_engine_pair import max_param_diff, moved_modules, run_both
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg

CASES = {
    "fedavg": ("FedAvg", dict(Nadmm=2, admm_rho0=1.0, check_results=True)),
    "fedprox": ("FedProx", dict(Nadmm=2, admm_rho0=1.0, check_results=False)),
    "admm_bb": ("AdmmConsensus", dict(Nadmm=4, admm_rho0=0.1, bb_update=True,
                                      bb_period_T=2, bb_rhomax=1000.0,
                                      num_devices=2, check_results=False)),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    name, cfg = CASES[request.param]
    out = run_both(JNet, TNet, getattr(jalg, name)(), getattr(talg, name)(),
                   cfg)
    out["case"] = request.param
    return out


def test_round_structure_matches(runs):
    key = lambda r: (r["nloop"], r["block"], r["nadmm"], r["N"],
                     r["bytes_on_wire"])
    assert [key(r) for r in runs["thist"]] == [key(r) for r in runs["jhist"]]
    assert len(runs["thist"]) == 2 * runs["tt"].cfg.Nadmm
    np.testing.assert_allclose([r["rho"] for r in runs["thist"]],
                               [r["rho"] for r in runs["jhist"]], rtol=1e-5)


@pytest.mark.parametrize("key,rtol", [("loss", 1e-4), ("dual_residual", 1e-3),
                                      ("primal_residual", 1e-3)])
def test_round_metrics_match(runs, key, rtol):
    if key not in runs["jhist"][0]:              # FedAvg has no primal
        assert all(key not in r for r in runs["thist"])
        return
    want = np.array([r[key] for r in runs["jhist"]])
    got = np.array([r[key] for r in runs["thist"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_final_params_match(runs):
    assert max_param_diff(runs["tparams"], runs["jparams"]) <= 5e-4
    assert moved_modules(runs["p0"], runs["tparams"]) == {"fc1", "conv1"}


def test_accuracy_matches(runs):
    for j, t in zip(runs["jhist"], runs["thist"]):
        assert ("accuracy" in t) == ("accuracy" in j)
        if "accuracy" in j:
            np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=0,
                                       atol=100.0 / 32 + 1e-9)


def test_write_back_follows_the_algorithm(runs):
    """FedAvg leaves every client holding z in the trained blocks; FedProx
    and ADMM leave the clients apart."""
    tp = runs["tparams"]["fc1"]["kernel"]
    same = all(np.array_equal(tp[0], tp[k]) for k in range(1, tp.shape[0]))
    assert same == (runs["case"] == "fedavg")


def test_bb_mode_ran(runs):
    """ADMM-BB: round 2 of block 0 took the BB rho and kept it for round 3;
    block 1 started afresh at rho0 and rejected its candidate.  The other
    algorithms keep rho0 throughout."""
    rhos = np.array([r["rho"] for r in runs["thist"]], np.float32)
    rho0 = np.float32(runs["tt"].cfg.admm_rho0)
    if runs["case"] != "admm_bb":
        assert (rhos == rho0).all()
        return
    assert (rhos[[0, 1, 4, 5, 6, 7]] == rho0).all()
    assert rhos[2] == rhos[3] and 100.0 < rhos[2] < 1000.0
