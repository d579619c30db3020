"""The port's restart supervisor (``control/supervisor.py``) against the
JAX one.

- The seeded backoff, the degradation ladder (overrides, engine skips and
  the ``ladder_override`` records) equal the JAX package's for every
  engine (``classifier``, ``vae``, ``cpc``) and attempts 1-4, from the
  same configuration.
- A supervised plain restart is a manual resume bit for bit: on the
  classifier (a health abort that repeats on the resumed segment, the
  JAX package's ``TestSupervisedVsManualResume``) and on the CPC (a crash
  mid-rotation through the driver's bare ``supervise``, its
  ``TestCPCSupervised`` at toy size).
- The chaos acceptance (the JAX package's ``TestChaosAcceptance``: async
  ADMM under NaN corruption and delays, act mode, two restarts): the
  port's run survives with the attempts, the ladder records and the
  ``(event, rule or intervention, round_index)`` sequence of the JAX
  run of the same configuration; the JAX package's replay returns 0 on
  the port's stream and 1 once a backoff is forged or a restart dropped.
- ``RestartBudgetExhausted`` appends a ``give_up`` record.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
from _torch_cpc_pair import FILES2, SAPS2, SILENT, port_trainer
from _torch_engine_pair import BASE, DATA, torch_threads

from federated_pytorch_test_tpu.control import supervisor as jsup
from federated_pytorch_test_tpu.control.replay import main as jreplay
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.obs.report import read_records
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
)
from federated_pytorch_test_tpu.train import FederatedConfig as JConfig
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.control import supervisor as tsup
from federated_pytorch_test_tpu_torch.control.replay import main as treplay
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.obs.health import RunHealthAbort
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
    ClientState,
)

LADDER_CFGS = [
    dict(),
    dict(compress="q8", fused_collective=True, participation=0.8),
    dict(update_guard=True, quarantine_rounds=3, robust_agg="krum",
         participation=0.4),
    dict(population=20, cohort_frac=0.8, compress="topk"),
]


@pytest.mark.parametrize("engine", ["classifier", "vae", "cpc"])
@pytest.mark.parametrize("i", range(len(LADDER_CFGS)))
def test_backoff_and_ladder_equal_jax(engine, i):
    kw = LADDER_CFGS[i]
    mine, theirs = FederatedConfig(**kw), JConfig(**kw)
    for attempt in (1, 2, 3, 4):
        assert tsup.restart_backoff_seconds(1.5, 7, attempt) == \
            jsup.restart_backoff_seconds(1.5, 7, attempt)
        ts, tc, tch = tsup.ladder_overrides(mine, attempt, engine=engine)
        js, jc, jch = jsup.ladder_overrides(theirs, attempt, engine=engine)
        assert (ts, tch) == (js, jch)
        for _, field, _, _ in tch:
            assert getattr(tc, field) == getattr(jc, field)
        assert tsup.ladder_skips(mine, attempt, engine) == \
            jsup.ladder_skips(theirs, attempt, engine)
        assert tsup.ladder_records(mine, attempt, run_id="r", ridx=3,
                                   engine=engine) == \
            jsup.ladder_records(theirs, attempt, run_id="r", ridx=3,
                                engine=engine)


CHAOS = dict(fault_spec="corrupt=0.2,mode=nan,seed=0", health_action="abort",
             health_streak=1, health_residual=True, obs_sinks="jsonl,memory")
#: the JAX package's chaos configuration (tests/test_control.py), on Net
CHAOS_CFG = dict(BASE, Nloop=2, Nadmm=2, check_results=False, admm_rho0=0.1,
                 async_rounds=True, max_staleness=2, control="act",
                 max_restarts=2, restart_backoff=0.0,
                 **dict(CHAOS, fault_spec="corrupt=0.2,mode=nan,seed=0,"
                                         "delay=0.25,delay_max=1"))


def _port(c, name="seg"):
    t = BlockwiseFederatedTrainer(Net(), c, FederatedCifar10(**DATA),
                                  talg.AdmmConsensus())
    t.L = 2
    t.obs_run_name = name
    return t


def _det(recs):
    """The deterministic stream: alerts by rule, control records by
    intervention (the supervisor's, and the policy's outside the
    wall-clock-driven rungs), with their round."""
    timing = ("escalate_compression", "deescalate_compression",
              "shrink_batch", "grow_batch")
    out = []
    for r in recs:
        if r["event"] == "alert":
            out.append(("alert", r["rule"], r["round_index"]))
        elif r["event"] == "control" and r["intervention"] not in timing:
            out.append(("control", r["intervention"], r["round_index"],
                        r.get("attempt")))
        elif r["event"] == "run_header":
            out.append(("run_header",))
    return out


def _rounds_by_segment(path):
    segs = []
    for r in read_records(path, validate=True):
        if r["event"] == "run_header":
            segs.append([])
        elif r["event"] == "round":
            segs[-1].append({k: repr(r.get(k)) for k in (
                "round_index", "loss", "primal_residual", "dual_residual",
                "rho", "n_active", "guard_trips", "admission_rejected")})
    return segs


def test_supervised_plain_restart_is_a_manual_resume(tmp_path):
    cfg = FederatedConfig(**dict(BASE, device="cpu", Nloop=2, Nadmm=2,
                                 check_results=False, admm_rho0=0.1,
                                 **CHAOS))
    with torch_threads(1):
        mdir = tmp_path / "manual"
        mcfg = dataclasses.replace(cfg, obs_dir=str(mdir / "obs"))
        for resume in (False, True):
            with pytest.raises(RunHealthAbort):
                _port(mcfg).run(log=SILENT, checkpoint_path=str(mdir / "ck"),
                                resume=resume)
        sdir = tmp_path / "supervised"
        scfg = dataclasses.replace(cfg, obs_dir=str(sdir / "obs"),
                                   max_restarts=1, restart_backoff=0.0)
        with pytest.raises(tsup.RestartBudgetExhausted):
            tsup.supervise_classifier(lambda c, a: _port(c), scfg,
                                      str(sdir / "ck"),
                                      run_kwargs={"log": SILENT}, log=SILENT,
                                      sleep=lambda s: None)
    manual = _rounds_by_segment(str(mdir / "obs" / "seg.jsonl"))
    sup = _rounds_by_segment(str(sdir / "obs" / "seg.jsonl"))
    assert len(manual) == len(sup) == 2
    assert manual == sup and manual[1]
    # the spent budget closes the stream with a give_up record
    recs = read_records(str(sdir / "obs" / "seg.jsonl"), validate=True)
    assert [r["intervention"] for r in recs if r["event"] == "control"] == \
        ["restart", "give_up"]


def test_cpc_supervised_crash_resume_is_the_uninterrupted_run(tmp_path):
    strip = lambda h: [{k: v for k, v in r.items()
                        if not k.endswith("_seconds")} for r in h]

    class Crash(Exception):
        pass

    calls = []

    def bomb(msg):
        calls.append(msg)
        if len(calls) == 3:
            raise Crash

    ck = str(tmp_path / "ck")

    def run_attempt(attempt, resume_now):
        return port_trainer(FILES2, SAPS2).run(
            Nloop=1, Nadmm=2, log=bomb if attempt == 1 else SILENT,
            checkpoint_path=ck, resume=resume_now)

    with torch_threads(1):
        want_s, want = port_trainer(FILES2, SAPS2).run(Nloop=1, Nadmm=2,
                                                       log=SILENT)
        got_s, got = tsup.supervise(run_attempt, max_restarts=2,
                                    backoff_base=0.0, seed=5,
                                    retry_on=(Crash,), log=SILENT)
    assert len(calls) == 3
    assert strip(got) == strip(want)
    for m in want_s:
        for a, b in zip(jax.tree.leaves(bridge.tree_to_jax(want_s[m])),
                        jax.tree.leaves(bridge.tree_to_jax(got_s[m]))):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos")
    jbuilt, tbuilt = [], []

    def jbuild(c, attempt):
        t = JTrainer(JNet(), c, JData(**DATA), jalg.AdmmConsensus())
        t.L = 2
        t.obs_run_name = "chaos"
        jbuilt.append((attempt, c.compress, c.update_guard))
        return t

    jcfg = JConfig(device_data=False, obs_dir=str(d / "jax"), **CHAOS_CFG)
    first = jbuild(jcfg, 0)
    jbuilt.clear()
    p0 = jax.tree.map(np.asarray, first.params0)
    b0 = jax.tree.map(np.asarray, first.batch_stats0)
    jsup.supervise_classifier(lambda c, a: first if a == 1 else jbuild(c, a),
                              jcfg, str(d / "jck"),
                              run_kwargs={"log": SILENT}, log=SILENT,
                              sleep=lambda s: None)

    def tbuild(c, attempt):
        tbuilt.append((attempt, c.compress, c.update_guard))
        return _port(c, "chaos")

    tcfg = FederatedConfig(device="cpu", obs_dir=str(d / "port"),
                           **CHAOS_CFG)
    with torch_threads(1):
        state, hist = tsup.supervise_classifier(
            tbuild, tcfg, str(d / "tck"),
            state=ClientState(*bridge.classifier_state_from_jax(p0, b0)),
            run_kwargs={"log": SILENT}, log=SILENT, sleep=lambda s: None)
    return dict(state=state, hist=hist, tbuilt=tbuilt,
                jpath=str(d / "jax" / "chaos.jsonl"),
                tpath=str(d / "port" / "chaos.jsonl"), dir=d)


def test_chaos_run_survives_with_the_shield_rung(chaos):
    assert len(chaos["hist"]) == 2 * 2 * 2
    for leaf in jax.tree.leaves(bridge.tree_to_jax(chaos["state"].params,
                                                   stacked=True)):
        assert np.all(np.isfinite(leaf))
    assert [b[1:] for b in chaos["tbuilt"]] == [
        ("none", False), ("none", False), ("q8", True)]
    recs = read_records(chaos["tpath"], validate=True)
    sup = [r for r in recs if r["event"] == "control"
           and r["source"] == "supervisor"]
    assert [r["attempt"] for r in sup if r["intervention"] == "restart"] \
        == [1, 2]
    ladder = [r for r in sup if r["intervention"] == "ladder_override"]
    assert {(r["param"], r["to_value"]) for r in ladder} == {
        ("compress", "q8"), ("update_guard", True), ("quarantine_rounds", 2)}
    assert all(r["ladder_stage"] == 1 for r in ladder)
    assert all("time_unix" not in r for r in recs
               if r["event"] == "control")


def test_chaos_stream_matches_jax(chaos):
    trecs = read_records(chaos["tpath"], validate=True)
    jrecs = read_records(chaos["jpath"], validate=True)
    assert _det(trecs) == _det(jrecs)
    ladder = lambda recs: [{k: r.get(k) for k in (
        "param", "from_value", "to_value", "attempt", "ladder_stage",
        "applied", "reason", "round_index")} for r in recs
        if r["event"] == "control"
        and r["intervention"] == "ladder_override"]
    assert ladder(trecs) == ladder(jrecs)


def test_replay_accepts_the_stream_and_catches_tampering(chaos, capsys):
    path = chaos["tpath"]
    assert jreplay([path]) == 0
    assert treplay([path]) == 0
    lines = open(path).read().splitlines()
    forged = chaos["dir"] / "forged.jsonl"
    dropped = chaos["dir"] / "dropped.jsonl"
    with open(forged, "w") as f, open(dropped, "w") as g:
        for line in lines:
            r = json.loads(line)
            restart = (r.get("event") == "control"
                       and r.get("intervention") == "restart")
            if restart:
                f.write(json.dumps(dict(r, backoff_seconds=99.0)) + "\n")
            else:
                f.write(line + "\n")
            if not (restart and r.get("attempt") == 1):
                g.write(line + "\n")
    for p in (forged, dropped):
        assert jreplay([str(p)]) == 1
        assert treplay([str(p)]) == 1
    capsys.readouterr()


def test_cpc_driver_supervised_preemption(tmp_path):
    """The CPC driver under ``--max-restarts`` (chip_smoke phase 27 at toy
    size): a simulated preemption inside a block past the first is
    resumed by restart 1, and the run ends bit for bit where the same
    run without the preemption does, end-of-run checkpoint included."""
    from federated_pytorch_test_tpu_torch.drivers import federated_cpc
    from federated_pytorch_test_tpu_torch.train.faults import FaultSpec
    from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt

    base = "delay=0.3,join=0.2,leave=0.1"
    for seed in range(500):
        sp = FaultSpec.parse(f"{base},preempt=0.15,seed={seed}")
        fires = [b * 2 + n for b in range(4) for n in range(2)
                 if sp.round_preempt(0, b, n)]
        if fires and fires[0] % 2 and fires[0] >= 2:
            break
    argv = ["--device", "cpu", "--Lc", "8", "--Rc", "4", "--batch-size",
            "2", "--Niter", "1", "--file-list", *FILES2, "--sap-list",
            *SAPS2, "--Nadmm", "2", "--async-rounds", "--max-staleness",
            "2", "--max-restarts", "2", "--restart-backoff", "0.5"]
    runs = {}
    with torch_threads(1):
        for tag, spec in (("ref", f"{base},seed={seed}"),
                          ("run", f"{base},preempt=0.15,seed={seed}")):
            d = str(tmp_path / tag)
            t, _, h = federated_cpc.main(
                [*argv, "--fault-spec", spec, "--checkpoint-dir", d],
                log=SILENT)
            runs[tag] = (h, ckpt.load_checkpoint(
                str(tmp_path / tag / "federated_cpc")),
                t.obs_recorder.jsonl_path)
    strip = lambda h: [{k: v for k, v in r.items()
                        if not k.endswith("_seconds")} for r in h]
    (hr, (tr, mr), _), (h1, (t1, m1), path) = runs["ref"], runs["run"]
    assert strip(h1) == strip(hr) and mr == m1
    assert tr.keys() == t1.keys()
    for k in tr:
        assert tr[k].equal(t1[k])
    recs = read_records(path, validate=True)
    ctl = [r for r in recs if r["event"] == "control"]
    assert [(r["intervention"], r["attempt"]) for r in ctl] == [
        ("restart", 1)]
    assert ctl[0]["backoff_seconds"] == tsup.restart_backoff_seconds(
        0.5, 69, 1)
    assert 0.25 <= ctl[0]["backoff_seconds"] <= 0.75
    assert treplay([path]) == 0 and jreplay([path]) == 0
