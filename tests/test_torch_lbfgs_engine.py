"""The classifier engine's L-BFGS (``optimizer="lbfgs"``) against the JAX
``BlockwiseFederatedTrainer``: FedAvg on Net (BatchNorm-free), one
``LBFGSNew`` step a minibatch (history 10, 4 inner iterations, batch mode,
backtracking) on the flat loss of the active block, each client's L-BFGS
state started afresh at every block.

K=4, batch 16, 40 images per client (3 steps an epoch), Nadmm = 2, both
sides from the JAX trainer's weights (``tests/_torch_engine_pair.py``).

- **The first block.**  The line searches make the same discrete choices
  on both sides, so every integer of each client's L-BFGS state
  (``func_evals``, ``n_iter_total``, ``hist_len``, ``hist_head``) is
  equal; loss at rtol 1e-4, the step scalars (``t``, ``H_diag``,
  ``alphabar``) at rtol 1e-3 (curvature pairs are differences of
  gradients, which amplify float32 rounding, as in
  ``tests/test_torch_lbfgs.py``), parameters at atol 1e-4.  Measured: loss
  3.8e-5 (relative), H_diag 2.4e-4 (relative), parameters 1.0e-5.
- **Two blocks.**  The second block starts from z's that differ at 1e-5,
  and there the backtracking takes a different number of halvings on the
  two sides (29-57 closure evaluations a client in JAX, 24-30 in the
  port), so its iterates part by more than rounding.  The run is held to:
  the first block as above, every loss finite and at rtol 1e-3 (measured
  2.2e-4), accuracy within one test image (measured equal), FedAvg's
  write-back, and each client's L-BFGS counters restarting at the block
  (at most 2 rounds x 3 steps x 4 iterations).
"""

import numpy as np
import pytest

from _torch_engine_pair import max_param_diff, moved_modules, run_both
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg

CFG = dict(Nadmm=2, optimizer="lbfgs", admm_rho0=1.0, check_results=True)


@pytest.fixture(scope="module", params=[1, 2])
def runs(request):
    out = run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(), CFG,
                   blocks=request.param)
    out["blocks"] = request.param
    return out


def test_first_block_matches(runs):
    for j, t in zip(runs["jhist"][:2], runs["thist"][:2]):
        assert (t["block"], t["N"], t["bytes_on_wire"]) == (
            j["block"], j["N"], j["bytes_on_wire"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["dual_residual"], j["dual_residual"],
                                   rtol=1e-3)
    if runs["blocks"] != 1:
        return
    assert max_param_diff(runs["tparams"], runs["jparams"]) <= 1e-4
    js, ts = runs["jstate"].opt_state, runs["tstate"].opt_state
    assert len(ts) == 4
    for f in ("func_evals", "n_iter_total", "hist_len", "hist_head"):
        assert [getattr(s, f) for s in ts] == np.asarray(
            getattr(js, f)).tolist(), f
    for f in ("t", "H_diag", "alphabar"):
        np.testing.assert_allclose([float(getattr(s, f)) for s in ts],
                                   np.asarray(getattr(js, f)), rtol=1e-3)


def test_whole_run_tracks_jax(runs):
    assert len(runs["thist"]) == len(runs["jhist"]) == 2 * runs["blocks"]
    got = np.array([r["loss"] for r in runs["thist"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, [r["loss"] for r in runs["jhist"]],
                               rtol=1e-3)
    for j, t in zip(runs["jhist"], runs["thist"]):
        np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=0,
                                   atol=100.0 / 32 + 1e-9)


def test_state_restarts_at_each_block_and_z_is_written_back(runs):
    for s in runs["tstate"].opt_state:
        assert 0 < s.n_iter_total <= 2 * 3 * 4
    moved = moved_modules(runs["p0"], runs["tparams"])
    assert moved == ({"fc1"} if runs["blocks"] == 1 else {"fc1", "conv1"})
    for mod in moved:
        leaf = runs["tparams"][mod]["kernel"]
        assert all(np.array_equal(leaf[0], leaf[k]) for k in range(4))
