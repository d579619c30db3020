"""The port's health watchdog (``obs/health.py``) against the JAX one, and
its fatal actions in the port's engines.

- Fed the same round records, the port's ``HealthMonitor`` and the JAX
  package's raise the same alerts, for each of the eight rules a port run
  can trip (every rule but ``serve_drift``: serving is not ported).
- ``abort`` and ``checkpoint-abort`` end the classifier engine's and the
  CPC trainer's run in ``RunHealthAbort`` (a NaN attack without the
  guard poisons z, and ``--health-residual`` trips on the round's
  residual); ``checkpoint-abort`` first leaves a verified newest slot:
  the run's mid-run slot, or the one-off ``<run>_health_abort`` slot.
- ``off`` attaches no monitor; the stream then carries no alert.
"""

import os

import pytest
from _torch_cpc_pair import FILES2, SAPS2, SILENT, port_trainer
from _torch_engine_pair import BASE, DATA, torch_threads

from federated_pytorch_test_tpu.obs.health import HealthMonitor as JMonitor
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.obs import make_recorder
from federated_pytorch_test_tpu_torch.obs.health import (
    HealthMonitor,
    RunHealthAbort,
)
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import BlockwiseFederatedTrainer
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt


def _round(i, **kw):
    rec = dict(round_index=i, loss=1.0, images=1000, round_seconds=1.0)
    rec.update(kw)
    return rec


def _stream(rule):
    """Round records that trip ``rule`` after a clean warm-up of 8."""
    warm = [_round(i) for i in range(8)]
    bad = {
        "nonfinite_loss": dict(loss=float("nan")),
        "throughput_collapse": dict(round_seconds=100.0),
        "guard_spike": dict(n_active=4, guard_trips=2, quarantined=1),
        "admission_blowup": dict(async_arrived=2, admission_rejected=2),
        "zero_progress": dict(n_active=0, n_ok=0.0),
        "nonfinite_residual": dict(dual_residual=float("nan")),
    }
    if rule == "loss_divergence":
        # each loss past the envelope the previous ones dragged up
        return warm + [_round(8 + i, loss=10.0 ** (3 + 3 * i))
                       for i in range(4)]
    if rule == "buffer_backlog":
        return warm + [_round(8 + i, buffer_depth=i + 1, n_active=20)
                       for i in range(9)]
    return warm + [_round(8 + i, **bad[rule]) for i in range(4)]


RULES = ("nonfinite_loss", "loss_divergence", "throughput_collapse",
         "guard_spike", "buffer_backlog", "admission_blowup",
         "zero_progress", "nonfinite_residual")


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("action", ["warn", "abort"])
def test_same_alerts_as_jax(rule, action):
    kw = dict(action=action, streak=3, window=8, residual_check=True)
    mine, theirs = HealthMonitor(**kw), JMonitor(**kw)
    for rec in _stream(rule):
        mine.observe(dict(rec))
        theirs.observe(dict(rec))
    assert mine.alerts == theirs.alerts
    assert rule in {a["rule"] for a in mine.alerts}
    assert (mine.tripped == theirs.tripped) and \
        ((mine.tripped is not None) == (action == "abort"))


NAN_ATTACK = dict(fault_spec="corrupt=0.5,mode=nan,seed=0",
                  health_streak=1, health_residual=True)


def _classifier(tmp_path, action):
    cfg = FederatedConfig(device="cpu", Nadmm=2, check_results=False,
                          checkpoint_dir=str(tmp_path / "ck"),
                          obs_dir=str(tmp_path / "obs"), obs_sinks="jsonl",
                          health_action=action,
                          **dict(BASE, **NAN_ATTACK))
    t = BlockwiseFederatedTrainer(Net(), cfg, FederatedCifar10(**DATA),
                                  talg.FedAvg())
    t.L = 2
    t.obs_run_name = "health"
    return t


@pytest.mark.parametrize("midrun", [True, False])
@pytest.mark.parametrize("action", ["abort", "checkpoint-abort"])
def test_classifier_fatal_actions(tmp_path, action, midrun):
    t = _classifier(tmp_path, action)
    path = str(tmp_path / "midrun") if midrun else None
    with torch_threads(1), pytest.raises(RunHealthAbort) as e:
        t.run(log=SILENT, checkpoint_path=path)
    assert e.value.alert["rule"] == "nonfinite_residual"
    assert t.obs_recorder._closed
    one_off = str(tmp_path / "ck" / "health_health_abort")
    if action == "checkpoint-abort":
        slot = ckpt.checkpoint_slots(path if midrun else one_off)[0]
        assert ckpt.verify_checkpoint(slot)
    elif not midrun:
        assert not os.path.exists(one_off)


@pytest.mark.parametrize("action", ["abort", "checkpoint-abort"])
def test_cpc_fatal_actions(tmp_path, action):
    t = port_trainer(FILES2, SAPS2, health_action=action,
                     checkpoint_dir=str(tmp_path / "ck"), **NAN_ATTACK)
    with torch_threads(1), pytest.raises(RunHealthAbort) as e:
        t.run(Nloop=1, Nadmm=2, log=SILENT, prefetch=False)
    assert e.value.alert["rule"] == "nonfinite_residual"
    one_off = str(tmp_path / "ck" / "cpc_admm_health_abort")
    if action == "checkpoint-abort":
        assert ckpt.verify_checkpoint(ckpt.checkpoint_slots(one_off)[0])
    else:
        assert not os.path.exists(one_off)


def test_off_attaches_no_monitor(tmp_path):
    t = _classifier(tmp_path, "off")
    with torch_threads(1):
        t.run(log=SILENT)
    rec = t.obs_recorder
    assert rec.health is None
    assert rec.jsonl_path is not None
    with open(rec.jsonl_path) as f:
        assert '"alert"' not in f.read()
    assert make_recorder("none").health is None
