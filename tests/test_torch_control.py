"""The port's control plane (``control/policy.py``) against the JAX one,
and its act mode in the port's classifier engine.

- Fed the same record stream, the port's ``ControlPolicy`` and the JAX
  package's make the same decisions, field for field, with a stream for
  each intervention.
- Act mode: a block-scope compressor swap decided in a block's first
  round lands at the next block boundary (the records' wire bytes switch
  there), and the swaps the construction rules forbid are skipped (a
  dense wire, or a sparse one, under a fused dual-state collective); a
  round-scope staleness decision applies live.
- ``off``, ``observe`` and ``act`` are bit-identical when no decision
  applies (the patient preset cannot fire in the run's rounds).
- A real act-mode run (buffered async rounds whose every arrival is too
  stale, so the watchdog's ``admission_blowup`` alert makes the policy
  widen the cutoff): the JAX package's ``control.replay.main`` returns 0
  on the port's stream, and so does the port's own replay.
"""

import dataclasses

import numpy as np
import pytest
from _torch_engine_pair import BASE, DATA, torch_threads

from federated_pytorch_test_tpu.control.policy import ControlPolicy as JPolicy
from federated_pytorch_test_tpu.control.replay import main as jreplay
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.control import replay
from federated_pytorch_test_tpu_torch.control.policy import (
    SCOPE_BLOCK,
    SCOPE_ROUND,
    Controller,
    ControlPolicy,
    Decision,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train import rounds
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import BlockwiseFederatedTrainer

SILENT = lambda m: None


def _round(i, secs=1.0, comm=0.1, **kw):
    return dict(event="round", round_index=i, round_seconds=secs,
                comm_seconds=comm, loss=1.0, images=64, **kw)


def _alert(i, rule):
    return dict(event="alert", round_index=i, rule=rule, severity="warn",
                observed=1.0, threshold=1.0, streak=1)


def _case(name):
    """(policy keywords, record stream) that fire ``name``."""
    hi = [_round(i, comm=0.9) for i in range(4)]
    if name == "escalate_compression":
        return {}, hi
    if name == "deescalate_compression":
        return {}, hi + [_round(4 + i, comm=0.0) for i in range(12)]
    if name == "relax_staleness":
        return dict(async_rounds=True), [_round(0), _alert(0,
                                                           "admission_blowup")]
    if name == "tighten_staleness":
        return dict(async_rounds=True), (
            [_round(0), _alert(0, "admission_blowup")]
            + [_round(1 + i, admission_rejected=0) for i in range(12)])
    if name == "tighten_trim":
        return dict(robust_agg="trim"), [_round(0), _alert(0, "guard_spike")]
    if name == "relax_trim":
        return dict(robust_agg="trim"), (
            [_round(0), _alert(0, "guard_spike")]
            + [_round(1 + i, guard_trips=0) for i in range(12)])
    if name == "shrink_cohort":
        return dict(population=16), [_round(0),
                                     _alert(0, "throughput_collapse")]
    if name == "grow_cohort":
        return dict(population=16), (
            [_round(0), _alert(0, "throughput_collapse")]
            + [_round(1 + i) for i in range(16)])
    if name == "shrink_batch":
        return {}, [_round(0), _alert(0, "throughput_collapse")]
    if name == "grow_batch":
        return {}, ([_round(0), _alert(0, "throughput_collapse")]
                    + [_round(1 + i) for i in range(16)])
    if name == "checkpoint_restart":
        return {}, [_round(0), _alert(0, "nonfinite_loss")]
    if name == "refresh_serving":
        return {}, [_round(0), _alert(0, "serve_drift")]
    assert name == "flag_clients"
    return {}, [dict(event="client", round_index=i, clients=2,
                     update_norm=[1.0, float("nan")], active=[1.0, 1.0],
                     guard_ok=[1.0, 0.0]) for i in range(4)]


INTERVENTIONS = ("escalate_compression", "deescalate_compression",
                 "relax_staleness", "tighten_staleness", "tighten_trim",
                 "relax_trim", "shrink_cohort", "grow_cohort", "shrink_batch",
                 "grow_batch", "checkpoint_restart", "refresh_serving",
                 "flag_clients")


@pytest.mark.parametrize("name", INTERVENTIONS)
def test_same_decisions_as_jax(name):
    kw, stream = _case(name)
    mine, theirs = ControlPolicy(**kw), JPolicy(**kw)
    got, want = [], []
    for rec in stream:
        got += [d.fields(source="policy")
                for d in mine.observe(dict(rec))]
        want += [d.fields(source="policy")
                 for d in theirs.observe(dict(rec))]
    assert got == want
    assert name in [d["intervention"] for d in got]


def _cfg(**kw):
    base = dict(BASE, device="cpu", Nadmm=2, check_results=False,
                obs_sinks="memory")
    base.update(kw)
    return FederatedConfig(**base)


def _trainer(algo=None, **kw):
    t = BlockwiseFederatedTrainer(Net(), _cfg(**kw), FederatedCifar10(**DATA),
                                  algo or talg.FedAvg())
    t.L = 2
    return t


class _FirstRoundPolicy(ControlPolicy):
    """Decides ``compress -> to`` in the run's first round only."""

    to = "q8"

    def _observe_round(self, rec):
        if rec.get("round_index") != 0:
            return []
        return [self._decide(0, "escalate_compression", "compress",
                             "none", self.to, SCOPE_BLOCK, "test")]


@pytest.mark.parametrize("case", ["swap", "fused_dense", "fused_sparse"])
def test_block_scope_swap_lands_at_the_block_boundary(case, monkeypatch):
    to = {"swap": "q8", "fused_dense": "none", "fused_sparse": "topk"}[case]
    policy = type("P", (_FirstRoundPolicy,), {"to": to})

    def controller(cfg, recorder=None):
        ctl = Controller(policy.from_config(cfg), mode="act")
        recorder.attach_control(ctl)
        return ctl

    monkeypatch.setattr(rounds, "controller_from_config", controller)
    if case == "swap":
        t = _trainer(control="act")
    else:
        t = _trainer(talg.AdmmConsensus(), control="act", compress="q8",
                     fused_collective=True, num_devices=2, admm_rho0=0.1)
    before = t.compressor.name
    lines = []
    with torch_threads(1):
        _, h = t.run(log=lines.append)
    by_block = [[r["bytes_on_wire"] for r in h if r["block"] == b]
                for b in (0, 1)]
    N1 = h[-1]["N"]
    if case == "swap":
        assert before == "none" and t.compressor.name == "q8"
        # block 0 shipped dense float32, block 1 the q8 codec
        assert by_block[0] == [4 * 4 * h[0]["N"]] * 2
        assert by_block[1] == [t.round_bytes_on_wire(N1, 4)] * 2
        assert by_block[1][0] < 4 * 4 * N1
    else:
        assert t.compressor.name == before == "q8"
        assert any("control: skip compress" in m for m in lines)
    assert t.cfg.compress == t.compressor.name


def test_round_scope_staleness_applies_live():
    t = _trainer(control="act", async_rounds=True, max_staleness=2)
    ctl = Controller(ControlPolicy.from_config(t.cfg), mode="act")
    ctl._register(Decision(round_index=0, intervention="relax_staleness",
                           param="max_staleness", from_value=2, to_value=3,
                           scope=SCOPE_ROUND, reason="t"))

    class Obs:
        control = ctl

    t._apply_round_control(Obs(), None, log=SILENT)
    assert t.cfg.max_staleness == 3


def test_off_observe_act_bit_identical():
    outs = []
    for mode in ("off", "observe", "act"):
        t = _trainer(control=mode, control_policy="patient",
                     participation=0.5)
        with torch_threads(1):
            s, h = t.run(log=SILENT)
        outs.append((bridge.tree_to_jax(s.params, stacked=True),
                     [{k: v for k, v in r.items()
                       if not k.endswith("_seconds")} for r in h]))
        if mode != "off":
            assert [r for r in t.obs_recorder.memory
                    if r["event"] == "control"] == []
        else:
            assert t.obs_recorder.control is None
    for p, h in outs[1:]:
        assert h == outs[0][1]
        for m in p:
            for k in p[m]:
                np.testing.assert_array_equal(p[m][k], outs[0][0][m][k])


def test_jax_replay_accepts_the_port_act_stream(tmp_path):
    t = _trainer(control="act", async_rounds=True, max_staleness=0,
                 fault_spec="delay=0.99,delay_max=1,seed=2",
                 health_streak=1, obs_sinks="jsonl,memory",
                 obs_dir=str(tmp_path))
    t.cfg = dataclasses.replace(t.cfg, Nadmm=4)
    with torch_threads(1):
        t.run(log=SILENT)
    ctl = [r for r in t.obs_recorder.memory if r["event"] == "control"]
    assert [(r["intervention"], r["applied"]) for r in ctl][:1] == [
        ("relax_staleness", True)]
    assert t.cfg.max_staleness >= 1
    path = t.obs_recorder.jsonl_path
    assert jreplay([path]) == 0
    assert replay.main([path]) == 0
