"""Trace-driven campaign schedules: declarative heavy-traffic load.

Port of ``federated_pytorch_test_tpu/campaign/schedule.py``, numpy only and
copied as it is over the port's ``train/faults.py``, so that a campaign
spec compiles to the same windows and fault specs in either package.

A campaign spec describes a WEEK of production traffic — the diurnal
arrival curve, churn waves that follow it, straggler storms and
correlated corruption bursts that strike at seeded virtual hours, and
deterministic preemption events — and this module compiles it into the
existing seeded fault/churn families (train/faults.py).  FL_PyTorch
(arXiv:2202.03099) frames federated experiments as managed, replayable
campaigns; FedJAX (arXiv:2108.02117) shows seeded client-population
simulation is what makes that CI-feasible.  This is both, on top of the
fault machinery the chaos tests already trust.

Spec grammar (``--campaign-spec``)::

    none
    hours=H,round_minutes=M,diurnal=A,drop=P,straggle=P,corrupt=P,
    mode=M,scale=X,join=P,leave=P,storm=P,storm_len=N,storm_straggle=P,
    burst=P,burst_len=N,burst_corrupt=P,preempt_at=h1+h2,seed=N,
    accel=X,health_window_hours=H

- ``hours`` is the declared campaign length (virtual hours; default 48)
  and ``round_minutes`` maps one communication round to that many
  virtual minutes (default 30) — virtual time is ``round_index *
  round_minutes * 60`` seconds, a pure function of the round index, so
  every derived quantity survives kill/resume and mesh reshape.
- ``diurnal=A`` (amplitude in [0, 1]) shapes the arrival fraction
  ``1 - A*(0.5 + 0.5*cos(2*pi*h/24))`` — trough at virtual midnight,
  peak at noon.  Arrival feeds the DROP family: the effective per-round
  drop probability is ``1 - arrival*(1 - drop)`` (absent clients are
  non-participants, exactly the established semantics).
- ``join=/leave=`` are churn waves riding the same curve: effective
  ``join*arrival`` and ``leave*(2 - arrival)`` — departures surge in
  the trough, rejoins in the ramp.
- ``storm=P`` starts a straggler storm at each virtual hour with seeded
  probability ``P`` (tag ``73``); a storm lasts ``storm_len`` hours and
  raises the straggle probability to ``storm_straggle``.  ``burst=P``
  is the correlated-corruption twin (tag ``79``, ``burst_len``,
  ``burst_corrupt``).
- ``preempt_at=h1+h2`` schedules deterministic slice preemptions: the
  first round at or past each virtual hour raises
  :class:`~..parallel.mesh.CollectiveTimeoutError` (after the newest
  checkpoint is durable), so the restart supervisor's reshape rung
  exercises mid-campaign.
- ``accel=X`` is the virtual-clock scale (virtual seconds per wall
  second) the harness hands to :class:`~.clock.VirtualClock`.
  Scheduling-inert: nothing derived from it is recorded.
- ``health_window_hours=H`` sizes the health monitor's rolling window
  in VIRTUAL time; the harness converts it to the equivalent round
  count before the run (recorded in the header config like any knob).

Everything the schedule derives is hour-quantized (probabilities are
constant within a virtual hour) and a pure function of ``(seed,
round_index)`` — the same statelessness contract as every fault family
— so ``control.replay`` re-derives the entire campaign from the stream
header, and a resumed segment replays the identical trajectory.  Tags
``73``/``79`` keep the storm/burst draws disjoint from participation
(11), compressor (23), population (31/37/41), faults (47), delay
(53/61), churn (67), preempt (71) and backoff (0xC791) streams.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from federated_pytorch_test_tpu_torch.train.faults import CORRUPT_MODES, FaultSpec

#: seeded-draw tags for the correlated-event families (see module
#: docstring for the full allocation table)
STORM_TAG = 73
BURST_TAG = 79

#: campaign-record field names, in emission order — shared by the
#: recorder path (rounds._emit_round_obs) and the replay verifier
#: (control/replay.check_campaign_records) so both compare the same set
CAMPAIGN_FIELDS = ("round_index", "virtual_seconds", "arrival_frac",
                   "drop_p", "straggle_p", "corrupt_p", "join_p",
                   "leave_p", "storm", "burst", "preempt_now", "phase")


@dataclasses.dataclass(frozen=True)
class CampaignWindow:
    """One round's hour-quantized slice of the campaign schedule.

    A pure function of ``(schedule, round_index)`` — every probability
    is what the derived :class:`FaultSpec` for that round carries, and
    every field lands verbatim in the stream's ``campaign`` record
    (schema v12) when the window transitions.
    """

    round_index: int
    virtual_seconds: float
    hour: int                 # virtual-hour index (quantization unit)
    arrival_frac: float
    drop_p: float
    straggle_p: float
    corrupt_p: float
    join_p: float
    leave_p: float
    storm: bool
    burst: bool
    preempt_now: bool
    phase: str                # trough|shoulder|peak, storm/burst override


@dataclasses.dataclass(frozen=True)
class CampaignSchedule:
    """Parsed ``--campaign-spec`` (see module docstring for the grammar)."""

    hours: float = 48.0
    round_minutes: float = 30.0
    diurnal: float = 0.0
    drop: float = 0.0
    straggle: float = 0.0
    corrupt: float = 0.0
    mode: str = "scale"
    scale: float = 100.0
    join: float = 0.0
    leave: float = 0.0
    storm: float = 0.0
    storm_len: int = 2
    storm_straggle: float = 0.5
    burst: float = 0.0
    burst_len: int = 1
    burst_corrupt: float = 0.5
    preempt_at: Tuple[float, ...] = ()
    seed: int = 0
    accel: float = 0.0        # 0 = harness/default decides (1.0)
    health_window_hours: float = 0.0

    @property
    def has_churn(self) -> bool:
        """Does ANY window of this campaign move the membership ledger?

        Sticky by design: the engine's churn gates (ledger meta, rejoin
        resets, v9 round fields) must not flap per-window, or a resumed
        segment checkpointed during a join=leave=0 window would lose the
        ledger.
        """
        return self.join > 0 or self.leave > 0

    @property
    def round_seconds(self) -> float:
        return self.round_minutes * 60.0

    @property
    def total_rounds(self) -> int:
        """Rounds needed to cover the declared campaign length."""
        return int(math.ceil(self.hours * 3600.0 / self.round_seconds))

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["CampaignSchedule"]:
        """``"none"``/empty/None -> None (campaign off — the literal
        seed path); else key=value CSV, same grammar style as
        ``--fault-spec``."""
        if spec is None or spec.strip() in ("", "none"):
            return None
        kw: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"campaign-spec item {item!r} is not key=value "
                    "(grammar: hours=H,round_minutes=M,diurnal=A,"
                    "drop=P,...,preempt_at=h1+h2,seed=N,accel=X)")
            key, val = (s.strip() for s in item.split("=", 1))
            if key in ("drop", "straggle", "corrupt", "join", "leave",
                       "storm", "burst", "storm_straggle",
                       "burst_corrupt", "diurnal"):
                p = float(val)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"campaign-spec {key}={p} outside [0, 1]")
                kw[key] = p
            elif key in ("hours", "round_minutes", "accel",
                         "health_window_hours"):
                x = float(val)
                if x < 0 or (x <= 0 and key in ("hours", "round_minutes")):
                    raise ValueError(
                        f"campaign-spec {key}={x} must be positive")
                kw[key] = x
            elif key in ("storm_len", "burst_len"):
                n = int(val)
                if n < 1:
                    raise ValueError(
                        f"campaign-spec {key}={n} must be >= 1 hour")
                kw[key] = n
            elif key == "mode":
                if val not in CORRUPT_MODES:
                    raise ValueError(
                        f"campaign-spec mode={val!r}; expected one of "
                        f"{CORRUPT_MODES}")
                kw[key] = val
            elif key == "scale":
                kw[key] = float(val)
            elif key == "seed":
                kw[key] = int(val)
            elif key == "preempt_at":
                hs = tuple(float(s) for s in val.split("+") if s != "")
                if not hs or any(h < 0 for h in hs):
                    raise ValueError(
                        f"campaign-spec preempt_at={val!r}: need "
                        "non-negative virtual hours joined by '+'")
                kw[key] = tuple(sorted(hs))
            else:
                raise ValueError(f"unknown campaign-spec key {key!r}")
        out = cls(**kw)
        if not (out.diurnal > 0 or out.drop > 0 or out.straggle > 0
                or out.corrupt > 0 or out.has_churn or out.storm > 0
                or out.burst > 0 or out.preempt_at):
            raise ValueError(
                f"campaign-spec {spec!r} schedules no load (set diurnal/"
                "drop/straggle/corrupt/join/leave/storm/burst/preempt_at,"
                " or pass 'none')")
        return out

    # -- the pure schedule functions -----------------------------------

    def virtual_seconds(self, round_index: int) -> float:
        """Virtual time at the START of ``round_index`` — a pure
        function of the index, so resume/reshape cannot skew it."""
        return float(round_index) * self.round_seconds

    def hour_index(self, round_index: int) -> int:
        return int(self.virtual_seconds(round_index) // 3600.0)

    def arrival(self, hour: int) -> float:
        """Diurnal arrival fraction for virtual hour ``hour`` (constant
        within the hour; trough at virtual midnight, peak at noon)."""
        if self.diurnal <= 0:
            return 1.0
        frac = 0.5 + 0.5 * math.cos(2.0 * math.pi * (hour % 24) / 24.0)
        return round(1.0 - self.diurnal * frac, 6)

    def _event_active(self, hour: int, tag: int, prob: float,
                      length: int) -> bool:
        """Is a seeded correlated event (storm/burst) covering ``hour``?

        An event starts at virtual hour ``h`` iff ``rng([seed, tag, h])
        < prob`` and covers hours ``h .. h+length-1``; checking every
        candidate start keeps the answer a pure function of the hour."""
        if prob <= 0.0:
            return False
        for start in range(max(0, hour - length + 1), hour + 1):
            u = np.random.default_rng(
                [self.seed, tag, start]).random()
            if u < prob:
                return True
        return False

    def _preempt_round(self, at_hour: float) -> int:
        """First round index whose start time is >= the event hour
        (floored at 1 — a round-0 preemption would have no checkpoint
        to recover from)."""
        return max(1, int(math.ceil(at_hour * 3600.0 / self.round_seconds)))

    def preempt_rounds(self) -> Tuple[int, ...]:
        return tuple(sorted({self._preempt_round(h)
                             for h in self.preempt_at}))

    def window(self, round_index: int) -> CampaignWindow:
        """Compile the schedule at ``round_index`` — THE pure function
        everything else (engine tick, record emission, replay
        verification, tests) shares."""
        hour = self.hour_index(round_index)
        arrival = self.arrival(hour)
        storm = self._event_active(hour, STORM_TAG, self.storm,
                                   self.storm_len)
        burst = self._event_active(hour, BURST_TAG, self.burst,
                                   self.burst_len)
        drop_p = round(1.0 - arrival * (1.0 - self.drop), 6)
        straggle_p = round(max(self.straggle,
                               self.storm_straggle if storm else 0.0), 6)
        corrupt_p = round(max(self.corrupt,
                              self.burst_corrupt if burst else 0.0), 6)
        join_p = round(self.join * arrival, 6)
        leave_p = round(min(1.0, self.leave * (2.0 - arrival)), 6)
        if storm and burst:
            phase = "storm+burst"
        elif storm:
            phase = "storm"
        elif burst:
            phase = "burst"
        elif arrival >= 0.75:
            phase = "peak"
        elif arrival >= 0.4:
            phase = "shoulder"
        else:
            phase = "trough"
        return CampaignWindow(
            round_index=int(round_index),
            virtual_seconds=self.virtual_seconds(round_index),
            hour=hour, arrival_frac=arrival, drop_p=drop_p,
            straggle_p=straggle_p, corrupt_p=corrupt_p, join_p=join_p,
            leave_p=leave_p, storm=storm, burst=burst,
            preempt_now=round_index in self.preempt_rounds(),
            phase=phase)

    def spec_for(self, w: CampaignWindow,
                 base: Optional[FaultSpec] = None) -> FaultSpec:
        """The derived per-round :class:`FaultSpec` for window ``w``.

        Every probability flows into the EXISTING seeded families (tags
        47/67), so the per-client draws are the same machinery the
        chaos tests trust; ``preempt`` stays 0 — campaign preemption is
        the deterministic ``preempt_at`` event, not the Bernoulli tag-71
        family.
        """
        return dataclasses.replace(
            base if base is not None else FaultSpec(),
            drop=w.drop_p, straggle=w.straggle_p, corrupt=w.corrupt_p,
            join=w.join_p, leave=w.leave_p, mode=self.mode,
            scale=self.scale, seed=self.seed, preempt=0.0)

    def record_fields(self, w: CampaignWindow) -> dict:
        """The ``campaign`` record body (schema v12) for window ``w`` —
        deliberately NO wall-clock field: every value is a pure function
        of (spec, round_index), the replay contract."""
        return {
            "round_index": w.round_index,
            "virtual_seconds": w.virtual_seconds,
            "arrival_frac": w.arrival_frac,
            "drop_p": w.drop_p, "straggle_p": w.straggle_p,
            "corrupt_p": w.corrupt_p, "join_p": w.join_p,
            "leave_p": w.leave_p, "storm": w.storm, "burst": w.burst,
            "preempt_now": w.preempt_now, "phase": w.phase,
        }

    def expected_emissions(self, round_indices) -> list:
        """Which of a SEGMENT's round indices emit a ``campaign`` record,
        and with what fields: ``[(round_index, fields), ...]``.

        The emission rule (shared verbatim with the engine's
        ``_emit_round_obs``): the segment's first completed round, every
        virtual-hour transition, and any round whose window carries
        ``preempt_now`` (the post-resume re-run of a preempted round is
        worth a line in the timeline).  Pure function of (spec, the
        segment's round indices) — exactly what ``control.replay``
        recomputes from the stream.
        """
        out, last_hour = [], None
        for r in round_indices:
            w = self.window(int(r))
            if last_hour is None or w.hour != last_hour or w.preempt_now:
                out.append((int(r), self.record_fields(w)))
            last_hour = w.hour
        return out
