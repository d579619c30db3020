"""The top-k exchange in the port's classifier engine against the JAX
``BlockwiseFederatedTrainer``: FedAvg under ``compress="topk"`` with error
feedback over a 2-shard client mesh, with and without
``fused_collective`` (the sparse fused mean: the payloads all-gathered and
scatter-added).  ADMM's fallback to the unfused reduction is held in
``tests/test_torch_fused_engine.py``.

K=4 on Net, two blocks, batch 16, 40 images per client, both sides from
the same weights (``tests/_torch_engine_pair.py``), ``topk_frac`` 0.1 (k =
85 of the 850 coordinates of the block trained first, 46 of conv1's 456).

- **One comm round from the same state, exactly.**  With ``lr = 0`` the
  local epoch leaves every client where it started (Adam's step is
  ``x + 0 * u``), and each client starts from its own seeded offset of
  the common init, so both sides enter each comm round with the same
  clients: every record's N and bytes, the final parameters (FedAvg's
  write-back of z), and the error-feedback residual are bitwise equal,
  fused and unfused.  The dual residual, a norm summed in another order,
  at rtol 1e-6.
- **Whole runs.**  Trained with Adam, the two sides' parameters part at
  rounding level (about 1.6e-4 after an epoch, the consensus engine
  test), and a coordinate whose delta sits near the k-th magnitude could
  then be selected on one side only, a difference that error feedback
  carries into the next round.  Whole runs are held to the consensus
  engine test's tolerances: N and bytes equal; loss at rtol 1e-4; dual
  residual at rtol 1e-3; final parameters and the residual at atol 5e-4;
  accuracy within one test image.  Measured (fused / unfused): loss
  2.1e-7 / 3.2e-7, dual residual 2.0e-7 / 1.2e-7 (relative), parameters
  1.2e-5 / 1.2e-5, residual 4.5e-8 / 4.5e-8 (absolute), accuracy equal:
  no selection differed at this geometry.
"""

import jax
import numpy as np
import pytest

from _torch_engine_pair import max_param_diff, moved_modules, run_both
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg

TOPK = dict(compress="topk", topk_frac=0.1, error_feedback=True,
            num_devices=2, admm_rho0=1.0)
CASES = {
    "fused_exact": dict(TOPK, fused_collective=True, lr=0.0, Nadmm=2,
                        check_results=False),
    "unfused_exact": dict(TOPK, lr=0.0, Nadmm=2, check_results=False),
    "fused_run": dict(TOPK, fused_collective=True, Nadmm=3,
                      check_results=True),
    "unfused_run": dict(TOPK, Nadmm=3, check_results=True),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    exact = request.param.endswith("_exact")
    out = run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(),
                   CASES[request.param], spread=0.05 if exact else 0.0)
    out["case"], out["exact"] = request.param, exact
    return out


def test_records_and_bytes_match(runs):
    keys = ("nloop", "block", "nadmm", "N", "rho", "bytes_on_wire")
    fused = runs["tt"].cfg.fused_collective
    if fused:
        keys += ("bytes_fused",)
    comp = runs["tt"].compressor
    assert len(runs["thist"]) == len(runs["jhist"]) == 2 * runs["tt"].cfg.Nadmm
    for t, j in zip(runs["thist"], runs["jhist"]):
        assert [t[k] for k in keys] == [j[k] for k in keys]
        assert ("bytes_fused" in t) == ("bytes_fused" in j) == fused
        assert t["bytes_on_wire"] == 4 * 8 * comp.inner.k_for(t["N"])
        if fused:
            assert t["bytes_fused"] == t["bytes_on_wire"]       # D = 2


def test_round_metrics_match(runs):
    for key, rtol in (("loss", 1e-4), ("dual_residual",
                                       1e-6 if runs["exact"] else 1e-3)):
        want = np.array([r[key] for r in runs["jhist"]])
        got = np.array([r[key] for r in runs["thist"]])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol)


def test_final_params_match(runs):
    if runs["exact"]:
        for g, w in zip(jax.tree.leaves(runs["tparams"]),
                        jax.tree.leaves(runs["jparams"])):
            assert g.tobytes() == w.tobytes()
    else:
        assert max_param_diff(runs["tparams"], runs["jparams"]) <= 5e-4
    assert moved_modules(runs["p0"], runs["tparams"]) == {"fc1", "conv1"}
    # FedAvg's write-back: every client holds z in the trained blocks
    for mod in ("fc1", "conv1"):
        leaf = runs["tparams"][mod]["kernel"]
        assert all(np.array_equal(leaf[0], leaf[k]) for k in range(4))


def test_error_feedback_residual_matches(runs):
    """The last block's carried residual: bitwise from the same state, and
    nonzero (top-k dropped mass that error feedback keeps)."""
    got = runs["tstate"].comp["resid"].numpy()
    want = np.asarray(runs["jstate"].comp["resid"])
    assert got.shape == want.shape == (4, 456)        # conv1, trained last
    assert (got != 0).any()
    if runs["exact"]:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_accuracy_matches(runs):
    for j, t in zip(runs["jhist"], runs["thist"]):
        assert ("accuracy" in t) == ("accuracy" in j)
        if "accuracy" in j:
            np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=0,
                                       atol=100.0 / 32 + 1e-9)

