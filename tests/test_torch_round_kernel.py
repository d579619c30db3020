"""The robustness shell of a round (``train/rounds.py``, the engine's
partial mode) against the JAX engine.

Two engine pairs (K=4, Net, 2 blocks, Nadmm 3, the JAX side with
``device_data=False`` and its Pallas kernels in interpret mode,
``tests/_torch_engine_pair.py``):

- FedProx (the partial-participation regime of its paper) with
  participation 0.5, drop/straggle/corrupt (``mode=scale``, x100) and the
  update guard with quarantine.  Not ADMM: under partial participation
  its dual term makes a client's round loss a difference of terms some 30
  times larger (-55.4 from them, with seed 1), where float32 summation
  order alone moves it by 1e-4 relative in either package;
- ADMM with chunked krum over a 2-shard mesh against ``innerprod``
  corruption.

Every record's mask, fault and guard counts equal the JAX engine's
exactly; loss at rtol 1e-4, residuals at rtol 1e-3, params at atol 5e-4
(the tolerances of ``test_torch_classifier_engine.py``).  Adam's step
count is per client and equals optax's under the JAX ``vmap``.

Port only: a VAE trainer with participation < 1 leaves the absent
clients' parameters bit for bit; every newly ported flag reaches the
config; a round that drops every client runs no exchange and keeps z;
NaN corruption under the guard never reaches z.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_engine_pair import max_param_diff, run_both, torch_threads
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import common
from federated_pytorch_test_tpu_torch.drivers.consensus_multi import DEFAULTS
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)
from federated_pytorch_test_tpu_torch.train.vae_engine import VAETrainer
from federated_pytorch_test_tpu_torch.utils import codec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the port's runs then repeat bit
    for bit, and a loaded machine is not oversubscribed
    (``torch_threads``)."""
    with torch_threads(1):
        yield


GUARD = dict(Nadmm=3, participation=0.5, update_guard=True,
             quarantine_rounds=1,
             fault_spec="drop=0.2,straggle=0.2,corrupt=0.3,mode=scale,"
                        "scale=100,seed=3")
KRUM = dict(Nadmm=3, robust_agg="krum", robust_chunked=True, num_devices=2,
            trim_frac=0.25, fault_spec="corrupt=0.3,mode=innerprod,scale=4,"
                                       "seed=7")
COUNTS = ("nloop", "block", "nadmm", "N", "host_dispatches", "n_active",
          "bytes_on_wire",
          "fault_dropped", "fault_straggled", "fault_corrupted",
          "quarantined", "guard_trips", "n_ok")
JAX_ONLY = {"sync_seconds", "compile_seconds", "cache_hit",
            "flops_round", "hlo_bytes_accessed"}


def check_pair(out):
    jh, th = out["jhist"], out["thist"]
    assert len(jh) == len(th) == 6
    for j, t in zip(jh, th):
        assert set(t) - {"kernel_launches"} == set(j) - JAX_ONLY
        for k in COUNTS:
            assert t.get(k, "absent") == j.get(k, "absent"), k
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        for k in ("primal_residual", "dual_residual"):
            if k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-3, atol=1e-7)
    assert max_param_diff(out["tparams"], out["jparams"]) <= 5e-4


@pytest.fixture(scope="module")
def guard_pair():
    return run_both(JNet, TNet, jalg.FedProx(), talg.FedProx(), GUARD)


@pytest.fixture(scope="module")
def krum_pair():
    return run_both(JNet, TNet, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                    KRUM)


def test_guard_round_counts_equal_jax(guard_pair):
    check_pair(guard_pair)
    th = guard_pair["thist"]
    assert sum(r["fault_corrupted"] for r in th) > 0
    assert sum(r["guard_trips"] for r in th) > 0
    assert sum(r["quarantined"] for r in th) > 0


def test_quarantine_serves_one_round_per_trip(guard_pair):
    """quarantine_rounds=1: a client that trips sits the next round out,
    and nobody else does; the first round of a block has no bound (+inf),
    so a finite x100 delta trips nothing there."""
    th = guard_pair["thist"]
    assert th[0]["quarantined"] == 0
    for prev, cur in zip(th, th[1:]):
        assert cur["quarantined"] == prev["guard_trips"]
    assert all(r["guard_trips"] == 0 for r in th if r["nadmm"] == 0)


def test_adam_count_is_per_client(guard_pair):
    """Clients that sat rounds out have taken fewer Adam steps: the port's
    [K] counts equal optax's under the JAX vmap."""
    tcount = guard_pair["tstate"].opt_state.count
    jcount = [np.asarray(leaf) for leaf in
              jax.tree.leaves(guard_pair["jstate"].opt_state)
              if np.asarray(leaf).dtype.kind == "i"]
    assert len(jcount) == 1
    np.testing.assert_array_equal(tcount.numpy(), jcount[0])
    assert tcount.dtype == torch.int64 and tcount.device.type == "cpu"
    assert len(set(tcount.tolist())) > 1


def test_krum_under_innerprod_equals_jax(krum_pair):
    check_pair(krum_pair)
    assert sum(r["fault_corrupted"] for r in krum_pair["thist"]) > 0
    assert krum_pair["tt"].D == 2


def test_every_dropped_round_keeps_z_and_ticks_quarantine():
    """A round with no client in the exchange runs no collective: z, y
    and rho carry over, the record reads n_active 0, and the quarantine
    still serves a round."""
    tt = TTrainer(TNet(), TConfig(K=4, Nloop=1, Nadmm=2, default_batch=16,
                                  device="cpu", update_guard=True,
                                  fault_spec="drop=1,seed=1"),
                  TData(K=4, batch=16, limit_per_client=20, limit_test=16),
                  talg.AdmmConsensus())
    tt.L = 1
    tt._quarantine[:] = 2
    p0 = tt.init_state().params
    state, hist = tt.run(log=lambda m: None)
    assert [r["n_active"] for r in hist] == [0.0, 0.0]
    assert [r["fault_dropped"] for r in hist] == [0, 0]
    assert [r["guard_trips"] for r in hist] == [0.0, 0.0]
    assert [r["quarantined"] for r in hist] == [4, 4]
    assert tt._quarantine.tolist() == [0, 0, 0, 0]
    assert all(r["loss"] == 0.0 and r["bytes_on_wire"] == 0 for r in hist)
    assert all(torch.equal(a, b) for a, b in
               zip(codec.get_trainable_stack(p0, tt.order,
                                             tt.mask_for_block(0)),
                   codec.get_trainable_stack(state.params, tt.order,
                                             tt.mask_for_block(0))))


def test_guard_keeps_nan_out_of_z():
    """NaN corruption with the guard on: every poisoned update trips the
    finite check (whatever the bound), is neutralised to z and
    quarantined, so z and the residuals stay finite (without the guard
    the same spec poisons z, ``test_torch_faults.py``)."""
    tt = TTrainer(TNet(), TConfig(K=4, Nloop=1, Nadmm=3, default_batch=16,
                                  device="cpu", update_guard=True,
                                  participation=0.75,
                                  fault_spec="corrupt=0.3,mode=nan,seed=4"),
                  TData(K=4, batch=16, limit_per_client=20, limit_test=16),
                  talg.AdmmConsensus())
    tt.L = 2
    state, hist = tt.run(log=lambda m: None)
    assert sum(r["fault_corrupted"] for r in hist) > 0
    for r in hist:
        assert r["guard_trips"] >= r["fault_corrupted"]
        assert np.isfinite(r["dual_residual"]) and np.isfinite(r["loss"])
    assert all(bool(torch.isfinite(t).all()) for t in
               codec.get_trainable_stack(state.params, tt.order,
                                         tt.mask_for_block(None)))


def test_vae_absent_clients_keep_their_params_bit_for_bit():
    cfg = TConfig(K=4, Nloop=1, Nadmm=1, default_batch=16, device="cpu",
                  participation=0.5, check_results=False, seed=3)
    tt = VAETrainer(AutoEncoderCNN(), cfg,
                    TData(K=4, batch=16, limit_per_client=20, limit_test=16),
                    talg.FedAvg())
    tt.L = 2
    active = [tt._participation_host(0, ci, 0) for ci in range(2)]
    assert all(0 < a.sum() < 4 for a in active)
    start = tt.init_state()
    state, hist = tt.run(start, log=lambda m: None)
    assert [r["n_active"] for r in hist] == [float(a.sum()) for a in active]
    for ci in range(2):
        mask = tt.mask_for_block(ci)
        before = codec.get_trainable_stack(start.params, tt.order, mask)
        after = codec.get_trainable_stack(state.params, tt.order, mask)
        for k in range(4):
            # both blocks: the last write to block ci is its own round
            if not active[ci][k]:
                assert torch.equal(after[k], before[k])
            else:
                assert not torch.equal(after[k], before[k])


NEW_FLAGS = [
    (["--participation", "0.5"], "participation", 0.5),
    (["--population", "12"], "population", 12),
    (["--cohort-sampling", "stratified"], "cohort_sampling", "stratified"),
    (["--cohort-frac", "0.5"], "cohort_frac", 0.5),
    (["--fault-spec", "drop=0.1,seed=2"], "fault_spec", "drop=0.1,seed=2"),
    (["--update-guard"], "update_guard", True),
    (["--guard-norm-mult", "4"], "guard_norm_mult", 4.0),
    (["--quarantine-rounds", "3"], "quarantine_rounds", 3),
    (["--async-rounds"], "async_rounds", True),
    (["--max-staleness", "2"], "max_staleness", 2),
    (["--staleness-alpha", "1.5"], "staleness_alpha", 1.5),
    (["--checkpoint-dir", "/tmp/x"], "checkpoint_dir", "/tmp/x"),
    (["--midrun-checkpoint"], "midrun_checkpoint", True),
    (["--async-checkpoint"], "async_checkpoint", True),
    (["--load-model"], "load_model", True),
    (["--no-save-model"], "save_model", False),
    (["--obs-dir", "/tmp/obs"], "obs_dir", "/tmp/obs"),
    (["--obs-sinks", "jsonl,memory"], "obs_sinks", "jsonl,memory"),
    (["--health-action", "abort"], "health_action", "abort"),
    (["--health-streak", "1"], "health_streak", 1),
    (["--health-residual"], "health_residual", True),
    (["--control", "act"], "control", "act"),
    (["--control-policy", "eager"], "control_policy", "eager"),
    (["--max-restarts", "2"], "max_restarts", 2),
    (["--restart-backoff", "0.5"], "restart_backoff", 0.5),
    (["--profile-dir", "/tmp/prof"], "profile_dir", "/tmp/prof"),
    (["--no-client-ledger"], "client_ledger", False),
]


@pytest.mark.parametrize("argv,field,value", NEW_FLAGS)
def test_newly_ported_flag_is_accepted(argv, field, value):
    cfg, _ = common.parse_config(DEFAULTS, "consensus_multi", argv)
    assert getattr(cfg, field) == value
    assert getattr(DEFAULTS, field) != value


@pytest.mark.parametrize("cfg,match", [
    (dict(participation=0.0), "participation=0.0 must be in"),
    (dict(participation=0.5, bb_update=True), "participation < 1"),
    (dict(update_guard=True, bb_update=True), "update guards"),
    (dict(async_rounds=True, max_staleness=-1), "max_staleness"),
    (dict(population=3), "population=3 must be >= the cohort size K=4"),
    (dict(cohort_frac=0.0), "cohort_frac"),
    (dict(guard_norm_mult=0.0), "guard_norm_mult"),
    (dict(fault_spec="drop=2"), "outside"),
])
def test_bad_round_knobs_are_refused_as_in_jax(cfg, match):
    from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
    from federated_pytorch_test_tpu.train import (
        BlockwiseFederatedTrainer as JTrainer,
        FederatedConfig as JConfig,
    )
    data = dict(K=4, batch=16, limit_per_client=16, limit_test=16)
    with pytest.raises(ValueError, match=match) as terr:
        TTrainer(TNet(), TConfig(K=4, device="cpu", **cfg), TData(**data),
                 talg.AdmmConsensus())
    with pytest.raises(ValueError) as jerr:
        JTrainer(JNet(), JConfig(K=4, device_data=False, **cfg),
                 JData(**data), jalg.AdmmConsensus())
    assert str(terr.value) == str(jerr.value)
