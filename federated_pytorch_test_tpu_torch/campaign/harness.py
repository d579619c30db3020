"""Soak harness: supervised multi-restart campaign runs on one stream.

Port of ``federated_pytorch_test_tpu/campaign/harness.py``.
:func:`run_soak` is the campaign twin of
:func:`~federated_pytorch_test_tpu_torch.control.supervisor.supervise_classifier`:
it compiles the config's ``campaign_spec``, builds the
:class:`~federated_pytorch_test_tpu_torch.campaign.clock.VirtualClock`
from the resolved acceleration, and threads the clock's ``sleep`` through
the supervisor, so that a restart backoff waits ``backoff / accel`` wall
seconds while the recorded ``backoff_seconds`` stay the unscaled seeded
values that ``control.replay`` verifies at any acceleration.

Every attempt's trainer is pinned to one ``obs_run_name``, so all
segments append to one campaign JSONL: run headers delimit segments, and
the supervisor's restart and ladder records land in the dying segment.
The spec's ``health_window_hours`` (virtual time) becomes the engine's
round-count ``health_window``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from federated_pytorch_test_tpu_torch.campaign.clock import VirtualClock
from federated_pytorch_test_tpu_torch.campaign.schedule import CampaignSchedule
from federated_pytorch_test_tpu_torch.control.supervisor import (
    supervise_classifier,
)

__all__ = ["resolve_accel", "soak_config", "run_soak"]


def resolve_accel(cfg, sched: CampaignSchedule) -> float:
    """Acceleration: the config's ``campaign_accel`` wins, then the spec's
    ``accel``, then real time.  Scheduling-inert: it only divides wall
    waits, never a recorded value."""
    accel = float(getattr(cfg, "campaign_accel", 0.0) or 0.0)
    if accel <= 0:
        accel = float(sched.accel or 0.0)
    return accel if accel > 0 else 1.0


def soak_config(cfg, sched: CampaignSchedule):
    """``cfg`` with the campaign-derived knobs applied (a copy):
    ``health_window_hours`` H becomes ``health_window = max(2, round(H *
    3600 / round_seconds))``; zero leaves the knob alone."""
    if sched.health_window_hours > 0:
        rounds = max(2, round(sched.health_window_hours * 3600.0
                              / sched.round_seconds))
        cfg = dataclasses.replace(cfg, health_window=rounds)
    return cfg


def run_soak(build_trainer, cfg, checkpoint_path: str, *,
             state=None, resume: bool = False,
             run_kwargs: Optional[Dict[str, Any]] = None,
             retry_on: Tuple = (),
             log: Callable[[str], None] = print,
             engine: str = "classifier",
             run_name: str = "soak"):
    """Supervised campaign run; returns ``(result, clock)``.

    ``build_trainer(cfg, attempt)`` is the factory
    :func:`supervise_classifier` takes; each trainer's ``obs_run_name`` is
    pinned to ``run_name`` unless the factory set one, so every segment
    appends to the same stream.  The returned :class:`VirtualClock` says
    how much virtual and wall time the supervisor spent in backoff."""
    sched = CampaignSchedule.parse(getattr(cfg, "campaign_spec", "none"))
    if sched is None:
        raise ValueError(
            "run_soak requires a campaign: cfg.campaign_spec is "
            f"{getattr(cfg, 'campaign_spec', 'none')!r} (use "
            "supervise_classifier directly for plain supervised runs)")
    clock = VirtualClock(accel=resolve_accel(cfg, sched))
    cfg = soak_config(cfg, sched)

    def build(c, attempt):
        trainer = build_trainer(c, attempt)
        if getattr(trainer, "obs_run_name", None) is None:
            trainer.obs_run_name = run_name
        return trainer

    result = supervise_classifier(
        build, cfg, checkpoint_path, state=state, resume=resume,
        run_kwargs=run_kwargs, retry_on=retry_on, log=log,
        sleep=clock.sleep, engine=engine)
    return result, clock


def selftest() -> str:
    """Pure checks of accel resolution and health-window derivation."""
    sched = CampaignSchedule.parse(
        "hours=48,round_minutes=30,diurnal=0.5,accel=120,"
        "health_window_hours=4")

    class _Cfg:
        campaign_accel = 0.0
        health_window = 8

    assert resolve_accel(_Cfg(), sched) == 120.0
    cfg = _Cfg()
    cfg.campaign_accel = 600.0
    assert resolve_accel(cfg, sched) == 600.0       # CLI wins
    plain = CampaignSchedule.parse("hours=2,round_minutes=30,diurnal=0.5")
    assert resolve_accel(_Cfg(), plain) == 1.0      # real time default

    # 4 virtual hours at 30-minute rounds -> 8-round health window
    @dataclasses.dataclass
    class _DCfg:
        health_window: int = 2

    assert soak_config(_DCfg(), sched).health_window == 8
    assert soak_config(_DCfg(), plain).health_window == 2  # untouched
    try:
        run_soak(None, _DCfg(), "nope")
    except (ValueError, AttributeError):
        pass
    else:                                            # pragma: no cover
        raise AssertionError("run_soak must reject campaign-off configs")
    return ("campaign harness selftest OK: accel resolution and "
            "health-window mapping are pure")


if __name__ == "__main__":                           # pragma: no cover
    print(selftest())
