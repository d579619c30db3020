"""The port's fault layer (``train/faults.py``) against the JAX package's.

- ``FaultSpec.parse``: the same fields from the same spec, the same
  ``ValueError`` message from a bad one.
- Every seeded draw family (faults, tag 47; delays, 53/61; churn, 67;
  preemption, 71) over a grid of round coordinates: equal, exactly.
- ``apply_corruption`` in all six modes, with and without activity
  weights, on one shard and over a 2-shard mesh, against the JAX function
  (float32 means summed in other orders: rtol 1e-6); a NaN or inf row
  reaches no other row.
- Two engine pairs (K=4, Net, 2 blocks, Nadmm 3, the JAX side with
  ``device_data=False``, ``tests/_torch_engine_pair.py``): buffered async
  rounds with transit delays and churn, and NaN corruption without the
  guard.  Every record's count fields equal; loss at rtol 1e-4, params at
  atol 5e-4 (the tolerances of ``test_torch_classifier_engine.py``); the
  NaN poisons z in the same round in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_engine_pair import max_param_diff, run_both, torch_threads
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train.faults import FaultSpec as JSpec
from federated_pytorch_test_tpu.train.faults import apply_corruption as japply
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.faults import (
    CORRUPT_MODES,
    FaultSpec,
    apply_corruption,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the port's runs then repeat bit
    for bit, and a loaded machine is not oversubscribed
    (``torch_threads``)."""
    with torch_threads(1):
        yield


SPECS = ["none", "", "drop=0.3", "straggle=0.5,seed=4",
         "corrupt=0.25,mode=nan,seed=9,clients=0+2",
         "corrupt=1,mode=innerprod,scale=3.5",
         "delay=0.4,delay_max=3,seed=11", "join=0.2,leave=0.1,seed=5",
         "preempt=0.5,seed=2", " drop = 0.1 , corrupt=0.2 ,mode=collude, ",
         "drop=0.2,straggle=0.2,corrupt=0.2,delay=0.5,join=0.3,leave=0.3,"
         "preempt=0.2,seed=13"]
BAD = ["drop", "drop=1.5", "delay=1", "delay_max=-1", "mode=zero",
       "clients=", "clients=-1", "nonsense=1", "seed=3", "join=-0.1"]
#: the (nloop, block, nadmm) grid of the draw families
GRID = [(nloop, ci, nadmm) for nloop in (0, 2) for ci in (0, 3, 9)
        for nadmm in (0, 1, 4)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    assert dataclasses.asdict(FaultSpec.parse(spec)) == \
        dataclasses.asdict(JSpec.parse(spec))
    t, j = FaultSpec.parse(spec), JSpec.parse(spec)
    assert (t.enabled, t.churn_enabled, t.masking, t.delaying) == \
        (j.enabled, j.churn_enabled, j.masking, j.delaying)


@pytest.mark.parametrize("spec", BAD)
def test_parse_errors_match_jax(spec):
    with pytest.raises(ValueError) as terr:
        FaultSpec.parse(spec)
    with pytest.raises(ValueError) as jerr:
        JSpec.parse(spec)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", SPECS[2:])
def test_draw_families_replay_jax(spec):
    t, j = FaultSpec.parse(spec), JSpec.parse(spec)
    K = 6
    members_t = members_j = np.ones(K, bool)
    for nloop, ci, nadmm in GRID:
        for a, b in zip(t.round_faults(K, nloop, ci, nadmm),
                        j.round_faults(K, nloop, ci, nadmm)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(t.round_delays(K, nloop, ci, nadmm),
                                      j.round_delays(K, nloop, ci, nadmm))
        members_t = t.round_churn(members_t, nloop, ci, nadmm)
        members_j = j.round_churn(members_j, nloop, ci, nadmm)
        np.testing.assert_array_equal(members_t, members_j)
        assert t.round_preempt(nloop, ci, nadmm) == \
            j.round_preempt(nloop, ci, nadmm)


def test_clients_out_of_range_matches_jax():
    spec = "corrupt=1,clients=1+7"
    with pytest.raises(ValueError) as terr:
        FaultSpec.parse(spec).round_faults(4, 0, 0, 0)
    with pytest.raises(ValueError) as jerr:
        JSpec.parse(spec).round_faults(4, 0, 0, 0)
    assert str(terr.value) == str(jerr.value)


def _corruption_inputs(seed=0, K=6, N=37):
    rng = np.random.default_rng(seed)
    delta = rng.standard_normal((K, N)).astype(np.float32)
    corrupt = np.array([1, 0, 0, 1, 0, 0], np.float32)
    w = np.array([1, 1, 0, 1, 0.5, 1], np.float32)
    return delta, corrupt, w


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_apply_corruption_matches_jax(mode, weighted, D):
    delta, corrupt, w = _corruption_inputs()
    want = np.asarray(japply(jnp.asarray(delta), jnp.asarray(corrupt), mode,
                             2.5, w=jnp.asarray(w) if weighted else None))
    got = apply_corruption(torch.from_numpy(delta), torch.from_numpy(corrupt),
                           mode, 2.5,
                           w=torch.from_numpy(w) if weighted else None,
                           mesh=ClientMesh(D) if D > 1 else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the untouched rows are the input, bit for bit
    np.testing.assert_array_equal(got[corrupt == 0], delta[corrupt == 0])


@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_a_nan_row_reaches_no_other_row(mode):
    """A non-finite delta in a row the mode does not average over stays in
    its row: the honest rows keep their values and the corrupted rows
    their (finite) replacement, as in the JAX function."""
    delta, corrupt, w = _corruption_inputs(1)
    # innerprod averages the honest rows, so the poison sits in a
    # corrupted one; the other modes average the colluders or nothing
    bad = 0 if mode == "innerprod" else 1
    delta[bad, 5] = np.nan
    delta[bad, 9] = np.inf
    got = apply_corruption(torch.from_numpy(delta), torch.from_numpy(corrupt),
                           mode, 2.5, w=torch.from_numpy(w)).numpy()
    want = np.asarray(japply(jnp.asarray(delta), jnp.asarray(corrupt), mode,
                             2.5, w=jnp.asarray(w)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    others = [k for k in range(6) if k != bad]
    if mode in ("nan", "inf"):
        others = [k for k in others if corrupt[k] == 0]
    assert np.isfinite(got[others]).all()
    np.testing.assert_array_equal(got[corrupt == 0], delta[corrupt == 0])


# ---------------------------------------------------------------------------
# engine pairs

ASYNC = dict(Nadmm=3, async_rounds=True, max_staleness=1, staleness_alpha=0.5,
             fault_spec="delay=0.5,drop=0.1,join=0.3,leave=0.3,seed=5")
NAN = dict(Nadmm=3, participation=0.75,
           fault_spec="corrupt=0.3,mode=nan,seed=4")
#: every record field that is a count of the round's schedule
COUNTS = ("nloop", "block", "nadmm", "N", "host_dispatches", "n_active",
          "bytes_on_wire",
          "fault_dropped", "fault_straggled", "fault_corrupted",
          "async_arrived", "admission_rejected", "buffer_depth",
          "staleness_hist", "members_active", "joined", "left")
#: the JAX records' telemetry the port does not keep
JAX_ONLY = {"sync_seconds", "compile_seconds", "cache_hit",
            "flops_round", "hlo_bytes_accessed"}


def check_counts(out, fields=COUNTS):
    jh, th = out["jhist"], out["thist"]
    assert len(jh) == len(th) == 6
    for j, t in zip(jh, th):
        assert set(t) - {"kernel_launches"} == set(j) - JAX_ONLY
        for k in fields:
            assert t.get(k, "absent") == j.get(k, "absent"), k


@pytest.fixture(scope="module")
def async_pair():
    return run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(), ASYNC)


def test_async_churn_counts_equal_jax(async_pair):
    check_counts(async_pair)
    th = async_pair["thist"]
    assert sum(r["joined"] for r in th) > 0 and sum(r["left"] for r in th) > 0
    assert all(len(r["staleness_hist"]) == 2 for r in th)


def test_async_churn_numbers_track_jax(async_pair):
    for j, t in zip(async_pair["jhist"], async_pair["thist"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["dual_residual"], j["dual_residual"],
                                   rtol=1e-3, atol=1e-7)
    assert max_param_diff(async_pair["tparams"], async_pair["jparams"]) <= 5e-4


@pytest.fixture(scope="module")
def nan_pair():
    return run_both(JNet, TNet, jalg.AdmmConsensus(), talg.AdmmConsensus(), NAN)


def test_nan_without_guard_poisons_z_alike(nan_pair):
    check_counts(nan_pair, COUNTS[:10])
    jh, th = nan_pair["jhist"], nan_pair["thist"]
    assert any(r["fault_corrupted"] for r in th)
    for j, t in zip(jh, th):
        assert np.isfinite(t["dual_residual"]) == np.isfinite(j["dual_residual"])
        if t["fault_corrupted"]:
            assert not np.isfinite(t["dual_residual"])
        elif np.isfinite(j["dual_residual"]):
            np.testing.assert_allclose(t["dual_residual"],
                                       j["dual_residual"], rtol=1e-3)
