"""The port's soak campaigns (``campaign/`` and their engine, driver and
replay wiring) against the JAX package's.

- The schedule: over several specs and rounds 0-500, every window, every
  derived fault spec and the emission sequence equal the JAX package's
  exactly; the grammar's rejections carry its messages.
- The harness: ``resolve_accel`` and ``soak_config`` resolve as JAX's do,
  and the virtual clock divides only wall waits.
- A mini campaign (K=4, Net, FedAvg, 2 blocks of 4 rounds, one virtual
  hour a round) with a corruption burst that starts in the middle of each
  block, against the JAX engine (``tests/_torch_engine_pair.py``): every
  round's count fields and every campaign record equal, the losses at
  rtol 1e-4 and the parameters at atol 5e-4 (the engine pair's
  tolerances).  The JAX engine reads a block's fault flags when it builds
  the block's step, before the block's first campaign tick: block 0 runs
  unmasked, and the burst in the middle of block 1 is drawn and counted
  but not applied.  The port does the same (``_block_flags``).
- A kill (the campaign's own ``preempt_at``) and resume in the port is bit
  for bit the uninterrupted run, the preemption fires once, and both
  packages' replays accept the two-segment stream (a tampered window
  fails both); every record passes the JAX schema.
- The campaign's exclusions (``fault_spec``, ``bb_update``) raise the JAX
  messages; the drivers run a campaign under the soak harness.
- A CPC campaign at toy size (``tests/_torch_cpc_pair.py``): the count
  fields equal the JAX trainer's.
"""

import dataclasses

import numpy as np
import pytest
from _torch_cpc_pair import FILES4, SAPS4
from _torch_cpc_pair import counts as cpc_counts
from _torch_cpc_pair import jax_trainer as cpc_jax_trainer
from _torch_cpc_pair import port_trainer as cpc_port_trainer
from _torch_cpc_pair import run_both as cpc_run_both
from _torch_engine_pair import (
    DATA,
    K,
    max_param_diff,
    run_both,
    torch_threads,
)
from _torch_tmp_cwd import tmp_cwd  # noqa: F401

from federated_pytorch_test_tpu.campaign import clock as jclock
from federated_pytorch_test_tpu.campaign import harness as jharness
from federated_pytorch_test_tpu.campaign.schedule import (
    CampaignSchedule as JSched,
)
from federated_pytorch_test_tpu.control.replay import replay as jreplay
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.obs.report import read_records
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
)
from federated_pytorch_test_tpu.train import FederatedConfig as JConfig
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.campaign import clock as tclock
from federated_pytorch_test_tpu_torch.campaign import harness as tharness
from federated_pytorch_test_tpu_torch.campaign.schedule import (
    CAMPAIGN_FIELDS,
    STORM_TAG,
    BURST_TAG,
    CampaignSchedule,
)
from federated_pytorch_test_tpu_torch.control.replay import replay as treplay
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.drivers import federated_multi
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.parallel.mesh import CollectiveTimeoutError
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves

SPECS = [
    "hours=48,round_minutes=30,diurnal=0.6,leave=0.2,join=0.5,storm=0.3,"
    "storm_len=2,burst=0.25,burst_len=1,preempt_at=12+36,seed=9",
    "hours=200,round_minutes=600,diurnal=0.5,drop=0.2,straggle=0.1,"
    "mode=scale,scale=50,join=0.15,leave=0.15,storm=0.3,storm_len=2,"
    "storm_straggle=0.7,burst=0.2,burst_corrupt=0.3,seed=13",
    "hours=6,round_minutes=30,diurnal=0.3,drop=0.05,join=0.2,leave=0.05,"
    "storm=0.5,storm_len=1,burst=0.5,burst_len=1,burst_corrupt=0.3,"
    "mode=scale,scale=100,preempt_at=3,seed=4",
    "hours=2,corrupt=0.3,mode=innerprod,scale=2.5,accel=120,"
    "health_window_hours=1.5,seed=1",
    " drop = 0.1 , straggle=0.2,round_minutes=7,preempt_at=0+0.5+9,",
]
BAD = ["hours=0,diurnal=1", "diurnal=2", "storm_len=0,storm=1", "nonsense",
       "what=1", "hours=48", "mode=zero,drop=0.1", "preempt_at=-1",
       "preempt_at=+", "round_minutes=-3,drop=0.1"]

#: one virtual hour a round; bursts start at hours 1 and 5, the middles of
#: blocks 0 and 1 of 4 rounds each; the preemption lands at round 6
MINI = ("hours=8,round_minutes=60,drop=0.1,join=0.2,leave=0.1,burst=0.3,"
        "burst_len=1,burst_corrupt=0.5,mode=scale,scale=100,preempt_at=6,"
        "seed=22")
#: the round fields that are counts: equal on both sides, exactly
COUNTS = ("nloop", "block", "nadmm", "N", "bytes_on_wire", "n_active",
          "guard_trips", "n_ok", "quarantined", "fault_dropped",
          "fault_straggled", "fault_corrupted", "members_active", "joined",
          "left")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _counts(hist):
    return [{k: r[k] for k in COUNTS if k in r} for r in hist]


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "run_id"}


# ----------------------------------------------------------------------
# the schedule and the harness: pure functions, equal to JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_equals_jax(spec):
    t, j = CampaignSchedule.parse(spec), JSched.parse(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.total_rounds, t.preempt_rounds(), t.has_churn,
            t.round_seconds) == (j.total_rounds, j.preempt_rounds(),
                                 j.has_churn, j.round_seconds)
    assert (STORM_TAG, BURST_TAG) == (73, 79)
    for r in range(501):
        tw, jw = t.window(r), j.window(r)
        assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
        assert t.record_fields(tw) == j.record_fields(jw)
        assert tuple(t.record_fields(tw)) == CAMPAIGN_FIELDS
        assert dataclasses.asdict(t.spec_for(tw)) == \
            dataclasses.asdict(j.spec_for(jw))
    rounds = list(range(501))
    assert t.expected_emissions(rounds) == j.expected_emissions(rounds)
    assert t.expected_emissions(rounds[137:]) == \
        j.expected_emissions(rounds[137:])


@pytest.mark.parametrize("spec", BAD)
def test_grammar_rejections_match_jax(spec):
    with pytest.raises(ValueError) as terr:
        CampaignSchedule.parse(spec)
    with pytest.raises(ValueError) as jerr:
        JSched.parse(spec)
    assert str(terr.value) == str(jerr.value)
    assert CampaignSchedule.parse("none") is None
    assert CampaignSchedule.parse(None) is None


@pytest.mark.parametrize("accel", [0.0, 600.0])
@pytest.mark.parametrize("spec", SPECS)
def test_soak_resolution_equals_jax(spec, accel):
    t, j = CampaignSchedule.parse(spec), JSched.parse(spec)
    tcfg = FederatedConfig(campaign_accel=accel, health_window=5)
    jcfg = JConfig(campaign_accel=accel, health_window=5)
    assert tharness.resolve_accel(tcfg, t) == jharness.resolve_accel(jcfg, j)
    assert tharness.soak_config(tcfg, t).health_window == \
        jharness.soak_config(jcfg, j).health_window


def test_clock_divides_only_wall_waits():
    twaits, jwaits = [], []
    tc = tclock.VirtualClock(accel=3600.0, sleep=twaits.append)
    jc = jclock.VirtualClock(accel=3600.0, sleep=jwaits.append)
    for v in (0.934, 0.0, -1.0, 7.5, 3600.0):
        tc.sleep(v)
        jc.sleep(v)
    assert twaits == jwaits == [0.934 / 3600, 7.5 / 3600, 1.0]
    assert (tc.virtual_slept, tc.wall_slept) == \
        (jc.virtual_slept, jc.wall_slept)
    assert repr(tc) == repr(jc)
    for bad in (0.0, -2.0):
        with pytest.raises(ValueError) as terr:
            tclock.VirtualClock(accel=bad)
        with pytest.raises(ValueError) as jerr:
            jclock.VirtualClock(accel=bad)
        assert str(terr.value) == str(jerr.value)


def test_run_soak_refuses_campaign_off():
    with pytest.raises(ValueError) as terr:
        tharness.run_soak(None, FederatedConfig(), "unused")
    with pytest.raises(ValueError) as jerr:
        jharness.run_soak(None, JConfig(), "unused")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(fault_spec="drop=0.1"),
                                dict(bb_update=True)])
def test_exclusions_raise_the_jax_messages(kw):
    with pytest.raises(ValueError) as terr:
        BlockwiseFederatedTrainer(
            Net(), FederatedConfig(device="cpu", K=K, campaign_spec=MINI,
                                   **kw),
            FederatedCifar10(**DATA), talg.FedAvg())
    with pytest.raises(ValueError) as jerr:
        JTrainer(JNet(), JConfig(K=K, campaign_spec=MINI, **kw),
                 JData(**DATA), jalg.FedAvg())
    assert str(terr.value) == str(jerr.value)
    assert "campaign_spec" in str(terr.value)


# ----------------------------------------------------------------------
# the mini campaign against the JAX engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mini():
    return run_both(JNet, Net, jalg.FedAvg(), talg.FedAvg(),
                    dict(Nadmm=4, campaign_spec=MINI, obs_sinks="memory"),
                    blocks=2)


def test_mini_counts_and_records_equal_jax(mini):
    assert len(mini["thist"]) == len(mini["jhist"]) == 8
    assert _counts(mini["thist"]) == _counts(mini["jhist"])
    tc = [_strip(r) for r in mini["tt"].obs_recorder.memory
          if r["event"] == "campaign"]
    jc = [_strip(r) for r in mini["jt"].obs_recorder.memory
          if r["event"] == "campaign"]
    assert tc == jc and len(tc) == 8


def test_mini_losses_and_params_match_jax(mini):
    want = np.array([r["loss"] for r in mini["jhist"]])
    got = np.array([r["loss"] for r in mini["thist"]])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert max_param_diff(mini["tparams"], mini["jparams"]) < 5e-4


def test_mid_block_burst_is_counted_not_applied(mini):
    """The flags of a block come from the spec in force before its first
    tick: block 0 from the disabled base spec (unmasked: every round
    counts all K on the wire though members left), block 1 from round 3's
    window (drop on, no burst): its round-5 burst is drawn and counted,
    and the parameters above show it was not applied on either side."""
    sched = CampaignSchedule.parse(MINI)
    assert [sched.window(r).burst for r in range(8)] == \
        [False, True, False, False, False, True, False, False]
    assert mini["tt"]._flag_cache == {0: (False, None), 1: (True, None)}
    hist = mini["thist"]
    assert hist[1]["fault_corrupted"] > 0 and hist[5]["fault_corrupted"] > 0
    assert all("n_active" not in r for r in hist[:4])
    assert hist[3]["members_active"] < K
    assert all("n_active" in r for r in hist[4:])


# ----------------------------------------------------------------------
# kill and resume in the port
# ----------------------------------------------------------------------
def _port(tmp_path, name):
    cfg = FederatedConfig(device="cpu", K=K, Nloop=1, Nepoch=1, Nadmm=4,
                          default_batch=16, biased_input=True,
                          campaign_spec=MINI, update_guard=True,
                          obs_sinks="jsonl", obs_dir=str(tmp_path / name))
    t = BlockwiseFederatedTrainer(Net(), cfg, FederatedCifar10(**DATA),
                                  talg.FedAvg())
    t.L = 2
    t.obs_run_name = "seg"
    return t


def _det(rec):
    return {k: v for k, v in rec.items()
            if isinstance(v, (int, float)) and not k.endswith("_seconds")}


@pytest.fixture(scope="module")
def kill_resume(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("camp")
    full = _port(tmp, "full")
    s_full, h_full = full.run(log=lambda m: None)
    ck = str(tmp / "ck")
    with pytest.raises(CollectiveTimeoutError) as err:
        _port(tmp, "kr").run(log=lambda m: None, checkpoint_path=ck)
    s_res, h_res = _port(tmp, "kr").run(log=lambda m: None,
                                        checkpoint_path=ck, resume=True)
    records = read_records(str(tmp / "kr" / "seg.jsonl"), validate=True)
    return dict(err=err.value, s_full=s_full, h_full=h_full, s_res=s_res,
                h_res=h_res, records=records)


def test_kill_resume_is_the_uninterrupted_run(kill_resume):
    kr = kill_resume
    assert kr["err"].round_index == 6
    assert len(kr["h_res"]) == len(kr["h_full"]) == 8
    for a, b in zip(leaves(kr["s_full"].params), leaves(kr["s_res"].params)):
        assert a.equal(b)
    assert [_det(r) for r in kr["h_full"]] == [_det(r) for r in kr["h_res"]]


@pytest.mark.parametrize("replay", [jreplay, treplay],
                         ids=["jax_replay", "port_replay"])
def test_replay_accepts_the_two_segment_stream(kill_resume, replay):
    records = kill_resume["records"]
    errors, stats = replay(records)
    assert not errors, errors
    assert stats["segments"] == 2
    # segment 0 emits rounds 0-5 (6 hours), segment 1 round 6 (its first
    # round, also the preempted window) and 7
    assert stats["campaign_records"] == 8
    tampered = [dict(r, arrival_frac=round(r["arrival_frac"] + 0.01, 6))
                if r.get("event") == "campaign" and r["round_index"] == 7
                else r for r in records]
    errors2, _ = replay(tampered)
    assert errors2 and "diverges" in errors2[0]


def test_driver_runs_the_soak_harness(capsys):
    log = []
    federated_multi.main([
        "--device", "cpu", "--K", "4", "--model", "net", "--Nloop", "1",
        "--Nadmm", "1", "--n-train", "40", "--n-test", "32",
        "--default-batch", "16", "--update-guard", "--campaign-spec",
        "hours=4,round_minutes=60,drop=0.1,preempt_at=2,seed=3",
        "--campaign-accel", "3600", "--max-restarts", "1",
        "--restart-backoff", "1", "--no-save-model"], log=log.append)
    done = [m for m in log if m.startswith("soak campaign done:")]
    assert done and "accel=3600" in done[0]
    assert any("CollectiveTimeoutError at round 2" in m for m in log)
    records = read_records("checkpoints/obs/federated_multi.jsonl")
    assert not jreplay(records)[0] and not treplay(records)[0]


# ----------------------------------------------------------------------
# the CPC's campaign tick
# ----------------------------------------------------------------------
CPC_SPEC = ("hours=12,round_minutes=60,diurnal=0.4,drop=0.1,straggle=0.1,"
            "join=0.2,leave=0.15,storm=0.3,storm_len=2,burst=0.3,"
            "burst_corrupt=0.5,mode=scale,scale=100,seed=3")


def test_cpc_campaign_counts_equal_jax():
    """Under the guard both trainers build the robust round; the port
    builds it for a campaign alone as well, the JAX trainer does not."""
    pair = cpc_run_both(FILES4, SAPS4, 2, campaign_spec=CPC_SPEC,
                        update_guard=True)
    assert len(pair["thist"]) == len(pair["jhist"]) == 8
    assert cpc_counts(pair["thist"]) == cpc_counts(pair["jhist"])
    assert sum(r.get("fault_corrupted", 0) for r in pair["thist"]) > 0
    assert cpc_port_trainer(FILES4, SAPS4,
                            campaign_spec=CPC_SPEC)._robust_round
    assert not cpc_jax_trainer(FILES4, SAPS4,
                               campaign_spec=CPC_SPEC)._robust_round
