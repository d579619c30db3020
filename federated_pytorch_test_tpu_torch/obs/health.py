"""Streaming run-health watchdog (schema v5).

A copy of ``federated_pytorch_test_tpu/obs/health.py`` for the port (the
port imports nothing of the JAX package).

A :class:`HealthMonitor` taps into :class:`~.recorder.RunRecorder` via
``recorder.attach_health(monitor)`` and evaluates per-round rules on
every round record — in-process and sink-independent, so a doomed run
is caught even when no JSONL sink is configured.  Rules:

- ``nonfinite_loss``      — NaN/inf loss for ``streak`` consecutive rounds
- ``loss_divergence``     — |loss| blows past ``loss_mult`` x a warmed-up
  EMA envelope for ``streak`` rounds
- ``throughput_collapse`` — images/sec drops below ``tput_frac`` x the
  rolling median over ``window`` rounds, for ``streak`` rounds
- ``guard_spike``         — >= half the cohort tripping guards or sitting
  in quarantine, for ``streak`` rounds
- ``buffer_backlog``      — async ``buffer_depth`` strictly growing over
  ``window`` rounds, or exceeding the cohort size
- ``admission_blowup``    — async admission rejecting >= everything that
  arrived, for ``streak`` rounds
- ``zero_progress``       — no client contributed (``n_active``/``n_ok``
  zero) for ``streak`` rounds
- ``nonfinite_residual``  — (opt-in, ``--health-residual``) NaN/inf ADMM
  primal/dual residual for ``streak`` rounds.  Residuals poison the
  consensus fold the same round they appear, one to two rounds BEFORE
  the (staged) loss goes non-finite — tripping here is what keeps a
  clean checkpoint slot alive for the restart supervisor to resume from
- ``serve_drift``         — (serving runs, schema v13) live served
  accuracy below ``tput_frac`` x its own warmed EMA baseline for
  ``streak`` serving rounds.  Fed ``serve`` records through
  ``observe_serve`` (recorder.serve_event) — the eval-stream half of
  the continuous-learning loop; in act mode the control plane answers
  with a ``refresh_serving`` intervention (control/policy.py)

Each trip emits a structured ``alert`` record into the SAME stream the
round records use.  What happens next is ``health_action``:

- ``off``              — no monitor is attached at all
- ``warn`` (default)   — alert records only; the run continues
- ``abort``            — the engine raises :class:`RunHealthAbort`
- ``checkpoint-abort`` — the engine forces a final verified checkpoint
  through the existing sync/async writers, THEN raises

Determinism: the monitor only OBSERVES values the engines already
fetched at round boundaries — it never adds device syncs and never
perturbs training math.  ``observe()`` cannot raise; rule failures
degrade to silence, and the abort is raised by the ENGINE (after
checking ``monitor.tripped``), never from inside the recorder.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, List, Optional

HEALTH_ACTIONS = ("off", "warn", "abort", "checkpoint-abort")


class RunHealthAbort(RuntimeError):
    """A watchdog rule tripped with ``--health-action abort`` or
    ``checkpoint-abort``.  Carries the triggering alert record."""

    def __init__(self, alert: Dict[str, Any]):
        self.alert = dict(alert)
        rule = alert.get("rule", "?")
        msg = alert.get("message", "")
        super().__init__(f"run health abort [{rule}] {msg}")


def _finite(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


class HealthMonitor:
    """Per-round rule evaluator; attach via ``recorder.attach_health``."""

    def __init__(self, *, action: str = "warn", streak: int = 3,
                 window: int = 8, loss_mult: float = 10.0,
                 tput_frac: float = 0.25,
                 n_clients: Optional[int] = None,
                 residual_check: bool = False):
        if action not in HEALTH_ACTIONS:
            raise ValueError(f"health action {action!r} not in "
                             f"{HEALTH_ACTIONS}")
        if action == "off":
            raise ValueError("action='off' means: do not attach a monitor")
        self.action = action
        self.streak = max(1, int(streak))
        self.window = max(2, int(window))
        self.loss_mult = float(loss_mult)
        self.tput_frac = float(tput_frac)
        self.n_clients = n_clients
        self.residual_check = bool(residual_check)
        self.recorder = None          # set by RunRecorder.attach_health
        self.tripped: Optional[Dict[str, Any]] = None  # first fatal alert
        self.alerts: List[Dict[str, Any]] = []
        # per-rule consecutive-bad-round counters
        self._streaks: Dict[str, int] = {}
        # loss EMA envelope (warmed up over `window` finite samples)
        self._ema: Optional[float] = None
        self._ema_n = 0
        # rolling throughput window (images/sec, finite-positive only)
        self._ips: deque = deque(maxlen=self.window)
        # async buffer_depth trajectory
        self._depths: deque = deque(maxlen=self.window)
        # served-accuracy EMA baseline (serve_drift, schema v13 serve
        # records via observe_serve — warmed like the loss EMA)
        self._serve_ema: Optional[float] = None
        self._serve_ema_n = 0

    # -- rule plumbing ---------------------------------------------------

    def _bump(self, rule: str, bad: bool) -> int:
        n = self._streaks.get(rule, 0) + 1 if bad else 0
        self._streaks[rule] = n
        return n

    def _fire(self, rec: Dict[str, Any], rule: str, message: str, *,
              observed: float, threshold: float, streak: int) -> None:
        fatal = self.action in ("abort", "checkpoint-abort")
        alert = {
            "rule": rule,
            "round_index": int(rec.get("round_index", -1)),
            "severity": "fatal" if fatal else "warn",
            "message": message,
            "observed": float(observed) if _finite(observed) else -1.0,
            "threshold": float(threshold),
            "streak": int(streak),
            "action": self.action,
        }
        self.alerts.append(alert)
        self._streaks[rule] = 0       # re-arm: alert once per streak
        if self.recorder is not None:
            try:
                self.recorder.alert(alert)
            except Exception:
                pass                  # a sink failure must not kill the run
        if fatal and self.tripped is None:
            self.tripped = alert

    # -- the rules -------------------------------------------------------

    def observe(self, rec: Dict[str, Any]) -> None:
        """Evaluate every rule against one round record.  Never raises."""
        try:
            self._observe(rec)
        except Exception:
            pass

    def _observe(self, rec: Dict[str, Any]) -> None:
        loss = rec.get("loss")
        have_loss = (isinstance(loss, (int, float))
                     and not isinstance(loss, bool))

        # nonfinite_loss
        if have_loss:
            n = self._bump("nonfinite_loss", not math.isfinite(loss))
            if n >= self.streak:
                self._fire(rec, "nonfinite_loss",
                           f"loss non-finite for {n} consecutive rounds",
                           observed=loss, threshold=float(self.streak),
                           streak=n)

        # loss_divergence: EMA envelope, warmed up over `window` samples
        if have_loss and math.isfinite(loss):
            if self._ema_n >= self.window:
                limit = self.loss_mult * max(abs(self._ema), 1e-8)
                n = self._bump("loss_divergence", abs(loss) > limit)
                if n >= self.streak:
                    self._fire(rec, "loss_divergence",
                               f"|loss|={abs(loss):.4g} > {self.loss_mult}x "
                               f"EMA envelope ({limit:.4g}) for {n} rounds",
                               observed=abs(loss), threshold=limit, streak=n)
            alpha = 2.0 / (self.window + 1.0)
            self._ema = (loss if self._ema is None
                         else (1 - alpha) * self._ema + alpha * loss)
            self._ema_n += 1

        # throughput_collapse: rolling-median envelope on images/sec
        images, secs = rec.get("images"), rec.get("round_seconds")
        if (_finite(images) and _finite(secs) and secs > 0 and images > 0):
            ips = images / secs
            if len(self._ips) >= self.window:
                med = sorted(self._ips)[len(self._ips) // 2]
                floor = self.tput_frac * med
                n = self._bump("throughput_collapse", ips < floor)
                if n >= self.streak:
                    self._fire(rec, "throughput_collapse",
                               f"{ips:.1f} img/s < {self.tput_frac}x rolling "
                               f"median ({med:.1f}) for {n} rounds",
                               observed=ips, threshold=floor, streak=n)
            self._ips.append(ips)

        # guard_spike: guard trips + quarantined vs cohort size
        cohort = self.n_clients or rec.get("n_active")
        trips = rec.get("guard_trips")
        quar = rec.get("quarantined")
        if _finite(cohort) and cohort > 0 and (_finite(trips)
                                               or _finite(quar)):
            bad_clients = (trips if _finite(trips) else 0) + (
                quar if _finite(quar) else 0)
            frac = bad_clients / cohort
            n = self._bump("guard_spike", frac >= 0.5)
            if n >= self.streak:
                self._fire(rec, "guard_spike",
                           f"{bad_clients:.0f}/{cohort:.0f} clients tripping "
                           f"guards/quarantined for {n} rounds",
                           observed=frac, threshold=0.5, streak=n)

        # buffer_backlog: async buffer depth growing without bound
        depth = rec.get("buffer_depth")
        if _finite(depth):
            self._depths.append(depth)
            growing = (len(self._depths) == self.window
                       and all(b > a for a, b in zip(self._depths,
                                                     list(self._depths)[1:])))
            over = (_finite(cohort) and cohort > 0 and depth >= cohort)
            if growing or over:
                n = self._bump("buffer_backlog", True)
                self._fire(rec, "buffer_backlog",
                           f"async buffer_depth={depth:.0f} "
                           + ("strictly growing over "
                              f"{self.window} rounds" if growing
                              else f">= cohort size {cohort:.0f}"),
                           observed=depth,
                           threshold=float(cohort if over else self.window),
                           streak=n)
            else:
                self._bump("buffer_backlog", False)

        # admission_blowup: admission rejecting everything that arrives
        rejected = rec.get("admission_rejected")
        arrived = rec.get("async_arrived")
        if _finite(rejected):
            base = arrived if _finite(arrived) else 0
            n = self._bump("admission_blowup",
                           rejected >= max(1, base))
            if n >= self.streak:
                self._fire(rec, "admission_blowup",
                           f"admission rejected {rejected:.0f} of "
                           f"{base:.0f} arrivals for {n} rounds",
                           observed=rejected, threshold=float(max(1, base)),
                           streak=n)

        # nonfinite_residual (opt-in): the consensus fold is already
        # poisoned the round a residual goes NaN — earlier than the
        # staged loss can show it, so the previous checkpoint slot is
        # still clean when the abort fires.
        if self.residual_check:
            primal = rec.get("primal_residual")
            dual = rec.get("dual_residual")
            have = (isinstance(primal, float) or isinstance(dual, float))
            bad = ((isinstance(primal, float) and not math.isfinite(primal))
                   or (isinstance(dual, float) and not math.isfinite(dual)))
            if have:
                n = self._bump("nonfinite_residual", bad)
                if n >= self.streak:
                    self._fire(rec, "nonfinite_residual",
                               f"ADMM residual non-finite for {n} "
                               f"consecutive rounds",
                               observed=(dual if isinstance(dual, float)
                                         else -1.0),
                               threshold=float(self.streak), streak=n)

        # zero_progress: no client contributed
        n_active = rec.get("n_active")
        self._check_zero_progress(rec, n_active)

    def observe_serve(self, rec: Dict[str, Any]) -> None:
        """Evaluate the ``serve_drift`` rule against one ``serve``
        record (schema v13; fed by ``RunRecorder.serve_event`` — the
        round records never reach this path).  Never raises."""
        try:
            self._observe_serve(rec)
        except Exception:
            pass

    def _observe_serve(self, rec: Dict[str, Any]) -> None:
        acc = rec.get("serve_accuracy")
        if not _finite(acc):
            return
        # serve_drift: live served accuracy collapsing below tput_frac x
        # its own warmed EMA baseline — the same envelope discipline as
        # loss_divergence, pointed at the eval stream
        if self._serve_ema_n >= self.window and self._serve_ema is not None \
                and self._serve_ema > 0:
            floor = self.tput_frac * self._serve_ema
            n = self._bump("serve_drift", acc < floor)
            if n >= self.streak:
                self._fire(rec, "serve_drift",
                           f"served accuracy {acc:.4f} < {self.tput_frac}x "
                           f"its EMA baseline ({self._serve_ema:.4f}) for "
                           f"{n} serving rounds",
                           observed=acc, threshold=floor, streak=n)
        alpha = 2.0 / (self.window + 1.0)
        self._serve_ema = (acc if self._serve_ema is None
                           else (1 - alpha) * self._serve_ema + alpha * acc)
        self._serve_ema_n += 1

    def _check_zero_progress(self, rec: Dict[str, Any], n_active) -> None:
        n_ok = rec.get("n_ok")
        if _finite(n_active) or _finite(n_ok):
            stalled = ((_finite(n_active) and n_active <= 0)
                       or (_finite(n_ok) and n_ok <= 0))
            n = self._bump("zero_progress", stalled)
            if n >= self.streak:
                self._fire(rec, "zero_progress",
                           f"no client contributed for {n} rounds",
                           observed=float(n_ok if _finite(n_ok)
                                          else n_active),
                           threshold=0.0, streak=n)


def monitor_from_config(cfg, recorder=None) -> Optional[HealthMonitor]:
    """Build a monitor from a TrainConfig-like object.

    Returns None when ``health_action == "off"`` (nothing is attached —
    the obs stream stays exactly as before).  When ``recorder`` is given
    the monitor is attached to it.
    """
    action = getattr(cfg, "health_action", "warn")
    if action == "off":
        return None
    mon = HealthMonitor(
        action=action,
        streak=getattr(cfg, "health_streak", 3),
        window=getattr(cfg, "health_window", 8),
        loss_mult=getattr(cfg, "health_loss_mult", 10.0),
        tput_frac=getattr(cfg, "health_tput_frac", 0.25),
        n_clients=getattr(cfg, "K", None),
        residual_check=getattr(cfg, "health_residual", False),
    )
    if recorder is not None:
        recorder.attach_health(mon)
    return mon


def selftest() -> None:
    """Synthetic NaN-streak run must alert; used by ``report --selftest``."""
    from federated_pytorch_test_tpu_torch.obs.recorder import RunRecorder
    from federated_pytorch_test_tpu_torch.obs.sinks import MemorySink

    rec = RunRecorder([MemorySink()], engine="selftest",
                      run_name="health_selftest")
    mon = HealthMonitor(action="warn", streak=3, n_clients=4)
    rec.attach_health(mon)
    rec.open()
    for i in range(5):
        rec.round({"round_index": i, "round_seconds": 0.01,
                   "loss": float("nan") if i >= 1 else 1.0,
                   "t_start": float(i), "images": 64})
    rec.close()
    alerts = [r for r in rec.memory if r["event"] == "alert"]
    assert alerts, "NaN streak produced no alert record"
    assert alerts[0]["rule"] == "nonfinite_loss", alerts[0]
    assert mon.tripped is None, "warn action must not trip an abort"
    summary = rec.memory[-1]
    assert summary["event"] == "summary"
    assert summary.get("alerts_total", 0) == len(alerts), summary

    # fatal actions set `tripped` so the engine can raise
    mon2 = HealthMonitor(action="checkpoint-abort", streak=2)
    for i in range(3):
        mon2.observe({"round_index": i, "loss": float("inf")})
    assert mon2.tripped is not None
    try:
        raise RunHealthAbort(mon2.tripped)
    except RunHealthAbort as e:
        assert e.alert["rule"] == "nonfinite_loss"

    # serve_drift: a warmed accuracy baseline then a sustained collapse
    # must alert; the warmup itself must not (cold start != drift)
    mon3 = HealthMonitor(action="warn", streak=2, window=4)
    for i in range(6):
        mon3.observe_serve({"round_index": i, "serve_accuracy": 0.8})
    assert not mon3.alerts, "steady serving accuracy must not alert"
    for i in range(6, 9):
        mon3.observe_serve({"round_index": i, "serve_accuracy": 0.0})
    assert mon3.alerts and mon3.alerts[0]["rule"] == "serve_drift", \
        mon3.alerts
    assert mon3.alerts[0]["round_index"] == 7
