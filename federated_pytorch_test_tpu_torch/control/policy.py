"""Deterministic control policy: telemetry in, typed interventions out.

A copy of ``federated_pytorch_test_tpu/control/policy.py`` for the port (the
port imports nothing of the JAX package).

The policy engine is the decision half of the closed-loop control plane
(README "Control plane").  A :class:`ControlPolicy` consumes the SAME
record stream the obs layer writes — round records plus the
:class:`~..obs.health.HealthMonitor`'s alert records — and maps them to
typed :class:`Decision` objects:

- ``escalate_compression`` / ``deescalate_compression`` — walk the
  ``none → q8 → q4 → topk`` ladder when the comm fraction of the round
  stays above/below its thresholds (block scope: the compressor is
  baked into the compiled round fns, so the engine applies it at the
  next block boundary).
- ``relax_staleness`` / ``tighten_staleness`` — widen ``max_staleness``
  on sustained admission blowups, walk it back toward the configured
  value once admissions go quiet (round scope: the engine reads the
  knob on the host every round, so it applies live).
- ``tighten_trim`` / ``relax_trim`` — grow/shrink ``trim_frac`` under
  guard-spike pressure when the robust aggregator uses it (restart
  scope: the mean fn is baked at construction; the restart supervisor
  applies it on the next segment).
- ``shrink_cohort`` / ``grow_cohort`` — under population federation
  (``--population K``) throughput collapse first halves ``cohort_frac``
  (the fraction of sampled cohort slots active per round) down to a
  floor of 0.25, and sustained healthy throughput doubles it back
  toward the configured value (round scope: the round kernel reads the
  knob on the host every round).  Tried BEFORE ``shrink_batch`` — a
  smaller cohort is cheaper to undo than a pipeline rebuild.
- ``shrink_batch`` / ``grow_batch`` — halve/double ``default_batch``
  within declared bounds on throughput collapse/recovery vs the rolling
  median (restart scope: the data pipeline is built at construction).
- ``checkpoint_restart`` — a non-fatal non-finite-loss alert under
  ``--control act`` triggers checkpoint-then-restart through the
  supervisor (fatal alerts are ignored here: the engine aborts and the
  supervisor owns recovery).

DETERMINISM CONTRACT (PARITY.md): every decision is a pure function of
the recorded telemetry and the round index — no wall clock, no
randomness, no device values beyond what the round records already
carry.  Each intervention is hysteresis-gated (per-rule streaks + a
per-param cooldown) so decisions don't flap, and the policy advances
its *internal* view of each knob when it decides (in ``observe`` and
``act`` mode alike), so the decision sequence is identical in both
modes and ``python -m federated_pytorch_test_tpu_torch.control.replay`` can
re-derive it bit-exactly from the JSONL stream.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional

CONTROL_MODES = ("off", "observe", "act")

#: escalation ladder for the wire format (compress/)
COMPRESS_LADDER = ("none", "q8", "q4", "topk")

#: hysteresis presets selectable via --control-policy
CONTROL_POLICIES = ("default", "eager", "patient")
_PRESETS = {
    "default": dict(streak=3, cooldown=6),
    "eager": dict(streak=2, cooldown=3),
    "patient": dict(streak=5, cooldown=12),
}

#: intervention scopes — who can apply the decision, and when
SCOPE_ROUND = "round"      # engine, next round (host-read knob)
SCOPE_BLOCK = "block"      # engine, next block boundary (recompile)
SCOPE_RESTART = "restart"  # supervisor, next run segment (reconstruct)
SCOPE_ADVISORY = "advisory"  # nobody: recorded evidence only — by
#                              construction Controller._register never
#                              queues this scope, so client-health
#                              signals can extend the replay contract
#                              without adding interventions


class ControlRestart(RuntimeError):
    """The policy decided checkpoint-then-restart under ``--control
    act``.  Raised by the ENGINE at the round boundary (after the
    round's mid-run checkpoint is flushed and verified); the restart
    supervisor catches it and resumes.  Carries the decision record."""

    def __init__(self, decision: Dict[str, Any]):
        self.decision = dict(decision)
        super().__init__(
            f"control restart requested at round "
            f"{decision.get('round_index')}: {decision.get('reason', '')}")


def _finite(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


def _cfg_get(cfg, name: str, default):
    """Read a knob off a FederatedConfig OR a run_header config dict —
    the same policy must be constructible from a live config and from
    the snapshot a recorded stream carries (control/replay.py)."""
    if isinstance(cfg, dict):
        v = cfg.get(name, default)
    else:
        v = getattr(cfg, name, default)
    return default if v is None else v


@dataclasses.dataclass(frozen=True)
class Decision:
    """One typed intervention; maps 1:1 onto a ``control`` record."""

    round_index: int
    intervention: str
    param: str
    from_value: Any
    to_value: Any
    scope: str
    reason: str
    observed: Optional[float] = None
    threshold: Optional[float] = None
    streak: Optional[int] = None

    def fields(self, *, source: str, mode: Optional[str] = None,
               applied: Optional[bool] = None) -> Dict[str, Any]:
        """The control-record body (obs/schema.py v8) for this decision."""
        f: Dict[str, Any] = {
            "round_index": int(self.round_index),
            "source": source,
            "intervention": self.intervention,
            "param": self.param,
            "from_value": self.from_value,
            "to_value": self.to_value,
            "scope": self.scope,
            "reason": self.reason,
        }
        if self.observed is not None:
            f["observed"] = float(self.observed)
        if self.threshold is not None:
            f["threshold"] = float(self.threshold)
        if self.streak is not None:
            f["streak"] = int(self.streak)
        if mode is not None:
            f["mode"] = mode
        if applied is not None:
            f["applied"] = bool(applied)
        return f

    #: the content replay compares — everything except who/how it was
    #: applied (mode/applied are engine-side facts, not decisions)
    def key(self) -> tuple:
        return (self.round_index, self.intervention, self.param,
                repr(self.from_value), repr(self.to_value), self.scope,
                self.reason, self.observed, self.threshold, self.streak)


class ControlPolicy:
    """Pure decision rules over the record stream; see module docstring.

    Thresholds derive ONLY from constructor arguments, all of which are
    recorded in the run-header config snapshot — so
    :meth:`from_config` rebuilds the identical policy from a stream.
    """

    COMM_FRAC_HI = 0.5        # comm/round fraction that forces escalation
    COMM_FRAC_LO = 0.05       # fraction that allows de-escalation
    TRIM_STEP = 0.05
    TRIM_MAX = 0.45
    STALENESS_RELAX_LIMIT = 4  # max rounds above the configured cutoff
    TPUT_OK_FRAC = 0.75       # healthy-throughput floor vs rolling median
    COHORT_FRAC_MIN = 0.25    # floor the cohort rung shrinks toward

    def __init__(self, *, preset: str = "default", compress: str = "none",
                 max_staleness: int = 4, trim_frac: float = 0.1,
                 default_batch: int = 128, robust_agg: str = "none",
                 fused_collective: bool = False, async_rounds: bool = False,
                 window: int = 8, population: int = 0,
                 cohort_frac: float = 1.0):
        if preset not in _PRESETS:
            raise ValueError(f"control policy {preset!r} not in "
                             f"{CONTROL_POLICIES}")
        if compress not in COMPRESS_LADDER:
            raise ValueError(f"compress {compress!r} not in "
                             f"{COMPRESS_LADDER}")
        self.preset = preset
        self.streak = int(_PRESETS[preset]["streak"])
        self.cooldown = int(_PRESETS[preset]["cooldown"])
        self.window = max(2, int(window))
        # starting knob values (the configured baseline the policy
        # de-escalates back toward) and declared bounds
        self._start_compress = COMPRESS_LADDER.index(compress)
        # under fused collectives the sparse rung is off the table (the
        # dense dual aggregate can't ride a sparse wire) and "none"
        # violates the fused path's packed-wire requirement
        self._max_compress = (COMPRESS_LADDER.index("q4")
                              if fused_collective
                              else len(COMPRESS_LADDER) - 1)
        self._start_staleness = int(max_staleness)
        self._start_trim = float(trim_frac)
        self._start_batch = int(default_batch)
        self._batch_min = max(8, self._start_batch // 4)
        self._trim_capable = robust_agg in ("trim", "krum")
        self._async = bool(async_rounds)
        self._pop = int(population) > 0
        self._start_frac = float(cohort_frac)
        # internal knob view: advances when a decision fires (BOTH
        # modes — see module docstring determinism note)
        self.cur_compress = self._start_compress
        self.cur_staleness = self._start_staleness
        self.cur_trim = self._start_trim
        self.cur_batch = self._start_batch
        self.cur_frac = self._start_frac
        # hysteresis state: per-rule consecutive-round counters and a
        # per-param cooldown horizon (round index the param re-arms at)
        self._streaks: Dict[str, int] = {}
        self._cooldown_until: Dict[str, int] = {}
        self._ips: deque = deque(maxlen=self.window)

    @classmethod
    def from_config(cls, cfg) -> "ControlPolicy":
        """Build from a FederatedConfig or a run_header ``config`` dict."""
        return cls(
            preset=str(_cfg_get(cfg, "control_policy", "default")),
            compress=str(_cfg_get(cfg, "compress", "none")),
            max_staleness=int(_cfg_get(cfg, "max_staleness", 4)),
            trim_frac=float(_cfg_get(cfg, "trim_frac", 0.1)),
            default_batch=int(_cfg_get(cfg, "default_batch", 128)),
            robust_agg=str(_cfg_get(cfg, "robust_agg", "none")),
            fused_collective=bool(_cfg_get(cfg, "fused_collective", False)),
            async_rounds=bool(_cfg_get(cfg, "async_rounds", False)),
            window=int(_cfg_get(cfg, "health_window", 8)),
            population=int(_cfg_get(cfg, "population", 0)),
            cohort_frac=float(_cfg_get(cfg, "cohort_frac", 1.0)),
        )

    # -- hysteresis plumbing -------------------------------------------

    def _bump(self, rule: str, bad: bool) -> int:
        n = self._streaks.get(rule, 0) + 1 if bad else 0
        self._streaks[rule] = n
        return n

    def _armed(self, param: str, ridx: int) -> bool:
        return ridx >= self._cooldown_until.get(param, -(1 << 30))

    def _decide(self, ridx: int, intervention: str, param: str,
                from_value, to_value, scope: str, reason: str, *,
                observed=None, threshold=None, streak=None
                ) -> Optional[Decision]:
        if not self._armed(param, ridx):
            return None
        self._cooldown_until[param] = ridx + self.cooldown
        return Decision(
            round_index=int(ridx), intervention=intervention, param=param,
            from_value=from_value, to_value=to_value, scope=scope,
            reason=reason,
            observed=float(observed) if _finite(observed) else None,
            threshold=float(threshold) if _finite(threshold) else None,
            streak=int(streak) if isinstance(streak, int) else None)

    # -- the rules ------------------------------------------------------

    def observe(self, rec: Dict[str, Any]) -> List[Decision]:
        """Feed one record (round or alert); returns fired decisions.

        Records MUST be fed in stream (file) order — the recorder feeds
        the controller round N before round N's alerts for exactly this
        reason (obs/recorder.py attach_control).
        """
        ev = rec.get("event", "round")
        if ev == "alert":
            return self._observe_alert(rec)
        if ev == "round":
            return self._observe_round(rec)
        if ev == "client":
            return self._observe_client(rec)
        return []

    def _observe_alert(self, alert: Dict[str, Any]) -> List[Decision]:
        # fatal alerts mean the engine is about to abort: recovery
        # belongs to the restart supervisor, not an in-run decision
        if alert.get("severity") == "fatal":
            return []
        rule = alert.get("rule")
        ridx = int(alert.get("round_index", -1))
        obs, thr = alert.get("observed"), alert.get("threshold")
        stk = alert.get("streak")
        out: List[Decision] = []
        if rule == "nonfinite_loss":
            d = self._decide(
                ridx, "checkpoint_restart", "run", None, None,
                SCOPE_RESTART,
                "non-finite loss streak: restart from the last verified "
                "checkpoint", observed=obs, threshold=thr, streak=stk)
            if d:
                out.append(d)
        elif (rule == "admission_blowup" and self._async
              and self.cur_staleness
              < self._start_staleness + self.STALENESS_RELAX_LIMIT):
            d = self._decide(
                ridx, "relax_staleness", "max_staleness",
                self.cur_staleness, self.cur_staleness + 1, SCOPE_ROUND,
                "admission controller rejecting every arrival: widen the "
                "staleness cutoff", observed=obs, threshold=thr,
                streak=stk)
            if d:
                self.cur_staleness += 1
                out.append(d)
        elif (rule == "guard_spike" and self._trim_capable
              and self.cur_trim + self.TRIM_STEP <= self.TRIM_MAX + 1e-9):
            new = round(self.cur_trim + self.TRIM_STEP, 4)
            d = self._decide(
                ridx, "tighten_trim", "trim_frac", self.cur_trim, new,
                SCOPE_RESTART,
                "guard spike: raise the trimmed-mean rejection fraction",
                observed=obs, threshold=thr, streak=stk)
            if d:
                self.cur_trim = new
                out.append(d)
        elif rule == "throughput_collapse":
            if (self._pop
                    and self.cur_frac > self.COHORT_FRAC_MIN + 1e-9):
                # population mode: the cohort rung goes first — a
                # host-read knob the kernel applies next round, far
                # cheaper to undo than a restart-scope pipeline rebuild
                new = round(max(self.COHORT_FRAC_MIN,
                                self.cur_frac / 2), 4)
                d = self._decide(
                    ridx, "shrink_cohort", "cohort_frac", self.cur_frac,
                    new, SCOPE_ROUND,
                    "throughput collapse vs rolling median: shrink the "
                    "sampled cohort before touching the minibatch",
                    observed=obs, threshold=thr, streak=stk)
                if d:
                    self.cur_frac = new
                    out.append(d)
            elif self.cur_batch > self._batch_min:
                new = max(self._batch_min, self.cur_batch // 2)
                d = self._decide(
                    ridx, "shrink_batch", "default_batch", self.cur_batch,
                    new, SCOPE_RESTART,
                    "throughput collapse vs rolling median: shrink the "
                    "minibatch", observed=obs, threshold=thr, streak=stk)
                if d:
                    self.cur_batch = new
                    out.append(d)
        elif rule == "serve_drift":
            # serving rung (serve/): live served accuracy collapsed vs
            # its EMA baseline — arm a forced weight refresh at the next
            # serve tick.  A host-read flag like cohort_frac: the kernel
            # republishes the CURRENT consensus without bumping the pure
            # weights_version sequence, so replay is untouched; a
            # serving-off run logs a skip (rounds._apply_round_control).
            d = self._decide(
                ridx, "refresh_serving", "serve_swap", None, "resync",
                SCOPE_ROUND,
                "served accuracy drifted below the EMA envelope: "
                "republish the consensus weights to the serving plane",
                observed=obs, threshold=thr, streak=stk)
            if d:
                out.append(d)
        return out

    def _observe_client(self, rec: Dict[str, Any]) -> List[Decision]:
        """Client-health evidence from a schema-v10 ``client`` record
        (obs/clients.py) — observe-only: the one rule here fires an
        SCOPE_ADVISORY decision, which ``Controller._register`` never
        queues, so client records extend the replay contract without
        adding interventions.  Same hysteresis plumbing as every other
        rule, so replay from a recorded stream reproduces the exact
        decision sequence."""
        ridx = rec.get("round_index")
        if not isinstance(ridx, int):
            return []
        norms = rec.get("update_norm")
        guard = rec.get("guard_ok")
        active = rec.get("active")
        k = rec.get("clients")
        if not isinstance(norms, list) or not isinstance(k, int):
            return []
        offenders = set()
        for i, v in enumerate(norms[:k]):
            if isinstance(v, (int, float)) and not math.isfinite(v):
                offenders.add(i)
        if isinstance(guard, list) and isinstance(active, list):
            for i, (g, a) in enumerate(zip(guard[:k], active[:k])):
                if _finite(g) and _finite(a) and a > 0 and g < 0.5:
                    offenders.add(i)
        n = self._bump("client_sick", bool(offenders))
        out: List[Decision] = []
        if n >= self.streak and offenders:
            d = self._decide(
                ridx, "flag_clients", "client_health", None,
                sorted(offenders), SCOPE_ADVISORY,
                f"per-client evidence: {len(offenders)} client(s) with "
                f"non-finite update norms or guard rejections for {n} "
                "consecutive rounds",
                observed=float(len(offenders)), threshold=0.0, streak=n)
            if d:
                out.append(d)
        return out

    def _observe_round(self, rec: Dict[str, Any]) -> List[Decision]:
        ridx = rec.get("round_index")
        if not isinstance(ridx, int):
            return []
        out: List[Decision] = []
        secs = rec.get("round_seconds")
        comm = rec.get("comm_seconds")

        # compression ladder: comm fraction of the round vs thresholds
        if _finite(secs) and secs > 0 and _finite(comm):
            frac = comm / secs
            n = self._bump("comm_hi", frac > self.COMM_FRAC_HI)
            if n >= self.streak and self.cur_compress < self._max_compress:
                d = self._decide(
                    ridx, "escalate_compression", "compress",
                    COMPRESS_LADDER[self.cur_compress],
                    COMPRESS_LADDER[self.cur_compress + 1], SCOPE_BLOCK,
                    f"comm fraction above {self.COMM_FRAC_HI} for "
                    f"{n} rounds: escalate the wire format",
                    observed=frac, threshold=self.COMM_FRAC_HI, streak=n)
                if d:
                    self.cur_compress += 1
                    out.append(d)
            m = self._bump("comm_lo", frac < self.COMM_FRAC_LO)
            if (m >= 2 * self.streak
                    and self.cur_compress > self._start_compress):
                d = self._decide(
                    ridx, "deescalate_compression", "compress",
                    COMPRESS_LADDER[self.cur_compress],
                    COMPRESS_LADDER[self.cur_compress - 1], SCOPE_BLOCK,
                    f"comm fraction below {self.COMM_FRAC_LO} for "
                    f"{m} rounds: step the wire format back toward the "
                    "configured baseline",
                    observed=frac, threshold=self.COMM_FRAC_LO, streak=m)
                if d:
                    self.cur_compress -= 1
                    out.append(d)

        # staleness walk-back: once admissions go quiet, step a relaxed
        # cutoff back toward the configured value
        if self._async and self.cur_staleness > self._start_staleness:
            rej = rec.get("admission_rejected")
            n = self._bump("staleness_quiet", _finite(rej) and rej == 0)
            if n >= 2 * self.streak:
                d = self._decide(
                    ridx, "tighten_staleness", "max_staleness",
                    self.cur_staleness, self.cur_staleness - 1,
                    SCOPE_ROUND,
                    f"no admission rejections for {n} rounds: walk the "
                    "staleness cutoff back",
                    observed=0.0, threshold=0.0, streak=n)
                if d:
                    self.cur_staleness -= 1
                    out.append(d)

        # batch walk-back: sustained healthy throughput after a shrink
        images = rec.get("images")
        ips = (images / secs if _finite(images) and _finite(secs)
               and secs > 0 and images > 0 else None)
        if ips is not None:
            if (self.cur_batch < self._start_batch
                    and len(self._ips) >= self.window):
                med = sorted(self._ips)[len(self._ips) // 2]
                n = self._bump("tput_ok",
                               ips >= self.TPUT_OK_FRAC * med)
                if n >= 2 * self.streak:
                    new = min(self._start_batch, self.cur_batch * 2)
                    d = self._decide(
                        ridx, "grow_batch", "default_batch",
                        self.cur_batch, new, SCOPE_RESTART,
                        f"throughput healthy vs rolling median for {n} "
                        "rounds: grow the minibatch back",
                        observed=ips, threshold=self.TPUT_OK_FRAC * med,
                        streak=n)
                    if d:
                        self.cur_batch = new
                        out.append(d)
            # cohort walk-back: sustained healthy throughput after a
            # shrink_cohort regrows the sampled fraction (round scope)
            if (self._pop and self.cur_frac < self._start_frac - 1e-9
                    and len(self._ips) >= self.window):
                med = sorted(self._ips)[len(self._ips) // 2]
                n = self._bump("cohort_ok",
                               ips >= self.TPUT_OK_FRAC * med)
                if n >= 2 * self.streak:
                    new = round(min(self._start_frac,
                                    self.cur_frac * 2), 4)
                    d = self._decide(
                        ridx, "grow_cohort", "cohort_frac",
                        self.cur_frac, new, SCOPE_ROUND,
                        f"throughput healthy vs rolling median for {n} "
                        "rounds: regrow the sampled cohort",
                        observed=ips, threshold=self.TPUT_OK_FRAC * med,
                        streak=n)
                    if d:
                        self.cur_frac = new
                        out.append(d)
            self._ips.append(ips)

        # trim walk-back: guards quiet after a tighten
        if self._trim_capable and self.cur_trim > self._start_trim + 1e-9:
            trips = rec.get("guard_trips")
            n = self._bump("guard_quiet", _finite(trips) and trips == 0)
            if n >= 2 * self.streak:
                new = round(max(self._start_trim,
                                self.cur_trim - self.TRIM_STEP), 4)
                d = self._decide(
                    ridx, "relax_trim", "trim_frac", self.cur_trim, new,
                    SCOPE_RESTART,
                    f"no guard trips for {n} rounds: relax the "
                    "trimmed-mean rejection fraction",
                    observed=0.0, threshold=0.0, streak=n)
                if d:
                    self.cur_trim = new
                    out.append(d)
        return out


class Controller:
    """Mode + recorder glue around a :class:`ControlPolicy`.

    Attached to a :class:`~..obs.recorder.RunRecorder` via
    ``attach_control``; the recorder feeds it every round and alert
    record in stream order.  Each fired decision is emitted as a
    ``control`` record; in ``act`` mode the applicable ones are queued
    for the engine to pick up at the round/block boundary
    (``take_round`` / ``take_block`` / ``take_restart``).

    ``observe()`` never raises — a policy failure degrades to "no
    decision" (mirroring the health monitor's contract), so the control
    plane can never kill a run it was meant to protect.
    """

    def __init__(self, policy: ControlPolicy, *, mode: str = "observe",
                 can_restart: bool = False):
        if mode not in ("observe", "act"):
            raise ValueError(f"controller mode {mode!r} must be "
                             "'observe' or 'act'")
        self.policy = policy
        self.mode = mode
        self.can_restart = bool(can_restart)
        self.recorder = None          # set by RunRecorder.attach_control
        self.decisions: List[Decision] = []
        self.records: List[Dict[str, Any]] = []
        self._pending_round: List[Decision] = []
        self._pending_block: List[Decision] = []
        self._restart: Optional[Decision] = None

    def observe(self, rec: Dict[str, Any]) -> None:
        try:
            fired = self.policy.observe(rec)
        except Exception:
            return                    # never kill the run
        for d in fired:
            self._register(d)

    def _register(self, d: Decision) -> None:
        applied = False
        if self.mode == "act":
            if d.scope == SCOPE_ROUND:
                self._pending_round.append(d)
                applied = True
            elif d.scope == SCOPE_BLOCK:
                self._pending_block.append(d)
                applied = True
            elif d.intervention == "checkpoint_restart":
                if self.can_restart and self._restart is None:
                    self._restart = d
                    applied = True
            # other restart-scope decisions are recorded for the
            # supervisor / operator; nothing to apply in-run
        self.decisions.append(d)
        body = d.fields(source="policy", mode=self.mode, applied=applied)
        self.records.append(body)
        if self.recorder is not None:
            try:
                self.recorder.control_event(body)
            except Exception:
                pass                  # a sink failure must not kill the run

    def take_round(self) -> List[Decision]:
        """Drain act-mode round-scope decisions (apply before next round)."""
        out, self._pending_round = self._pending_round, []
        return out

    def take_block(self) -> List[Decision]:
        """Drain act-mode block-scope decisions (apply at block boundary)."""
        out, self._pending_block = self._pending_block, []
        return out

    def take_restart(self) -> Optional[Decision]:
        """Pop the act-mode checkpoint-then-restart decision, if any."""
        d, self._restart = self._restart, None
        return d


def controller_from_config(cfg, recorder=None) -> Optional[Controller]:
    """Build a Controller from a FederatedConfig-like object.

    Returns None when ``control == "off"`` (nothing is attached — the
    obs stream and the training math stay exactly as before, the same
    contract as ``monitor_from_config``).
    """
    mode = _cfg_get(cfg, "control", "off")
    if mode not in CONTROL_MODES:
        raise ValueError(f"control={mode!r} must be one of {CONTROL_MODES}")
    if mode == "off":
        return None
    ctl = Controller(ControlPolicy.from_config(cfg), mode=mode)
    if recorder is not None:
        recorder.attach_control(ctl)
    return ctl
