"""Deterministic request micro-batcher + seeded synthetic traffic.

Port of ``federated_pytorch_test_tpu/serve/batcher.py``, numpy only and
copied as it is, so that a serve spec plans the same traffic in either
package.

Two halves, split by what replay can check:

``ServeSchedule`` is the pure half.  It reuses the campaign
diurnal-wave grammar (``campaign/schedule.py``): a comma-separated
``key=value`` spec describes offered load, pad buckets, the hot-swap
cadence and an optional drift injection round, and every *planning*
quantity — request count, batch plan, padded slots, weights version,
swap flag — is a pure function of (seed, round_index).  Traffic draws
use dedicated tag 83 in the seeded-draw namespace
(``np.random.default_rng([seed, 83, round_index])``), so they collide
with none of the participation/fault/churn/campaign streams.
``control/replay.py`` re-derives the pure fields of every ``serve``
record from the header config alone.

``MicroBatcher`` is the timed half: a bounded queue that groups
requests into pad-to-bucket batches and dispatches them through an
injected callable, measuring per-batch latency (p50/p99 ms) and QPS.
Wall-clock numbers are advisory telemetry — recorded, reported,
benched, but never replay-checked.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

# Seeded-draw tag for serve traffic (participation=11, compressor=23,
# population=31/37/41, faults=47, delay=53/61, churn=67, preempt=71,
# storm=73, burst=79, backoff=0xC791 — serve=83).
SERVE_TAG = 83

# The replay-checked (pure) fields of a `serve` record, in emission
# order.  Everything else on the record (serve_p50_ms, serve_p99_ms,
# serve_qps, swap_gap_seconds, serve_accuracy, drift_score,
# forced_refresh) is advisory wall-clock/accuracy telemetry.
SERVE_FIELDS = (
    "round_index",
    "weights_version",
    "requests",
    "batches",
    "padded_slots",
    "padding_waste_frac",
    "drift_injected",
    "swap",
)

_SERVE_KEYS = ("qps", "round_minutes", "diurnal", "buckets", "swap_every",
               "drift_at", "seed")


@dataclass(frozen=True)
class ServeSchedule:
    """Parsed, validated serve spec — hashable, comparable, printable.

    Grammar (all keys optional)::

        qps=8,round_minutes=0.5,diurnal=0.6,buckets=8+32+128,
        swap_every=1,drift_at=-1,seed=0

    - ``qps``           offered load in requests/second at wave peak.
    - ``round_minutes`` virtual minutes of traffic per training round.
    - ``diurnal``       wave amplitude in [0, 1]; 0 = flat arrivals.
    - ``buckets``       ascending pad buckets, ``+``-separated.
    - ``swap_every``    hot-swap the served weights every N rounds.
    - ``drift_at``      inject label drift from this round on (-1 off).
    - ``seed``          traffic stream seed (tag 83 draws).
    """

    qps: float = 8.0
    round_minutes: float = 0.5
    diurnal: float = 0.0
    buckets: Tuple[int, ...] = (8, 32, 128)
    swap_every: int = 1
    drift_at: int = -1
    seed: int = 0

    # ------------------------------------------------------------------
    # parsing
    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["ServeSchedule"]:
        """``"none"``/empty/None → None (serving off); else a schedule.

        Raises ``ValueError`` on unknown keys or out-of-range values so
        a typo fails at config time, not mid-run.
        """
        if spec is None:
            return None
        text = spec.strip()
        if not text or text.lower() == "none":
            return None
        kw: Dict[str, object] = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"serve spec entry {part!r} is not key=value")
            key, _, val = part.partition("=")
            key = key.strip()
            val = val.strip()
            if key not in _SERVE_KEYS:
                raise ValueError(
                    f"unknown serve spec key {key!r} "
                    f"(expected one of {_SERVE_KEYS})")
            if key in ("qps", "round_minutes", "diurnal"):
                kw[key] = float(val)
            elif key == "buckets":
                sizes = tuple(int(s) for s in val.split("+") if s)
                kw[key] = sizes
            else:
                kw[key] = int(val)
        sched = cls(**kw)  # type: ignore[arg-type]
        sched._validate()
        return sched

    def _validate(self) -> None:
        if not self.qps > 0.0:
            raise ValueError(f"serve qps must be > 0, got {self.qps}")
        if not self.round_minutes > 0.0:
            raise ValueError(
                f"serve round_minutes must be > 0, got {self.round_minutes}")
        if not 0.0 <= self.diurnal <= 1.0:
            raise ValueError(
                f"serve diurnal must be in [0, 1], got {self.diurnal}")
        if not self.buckets:
            raise ValueError("serve buckets must be non-empty")
        if any(b <= 0 for b in self.buckets):
            raise ValueError(
                f"serve buckets must be positive, got {self.buckets}")
        if tuple(sorted(self.buckets)) != self.buckets:
            raise ValueError(
                f"serve buckets must be ascending, got {self.buckets}")
        if len(set(self.buckets)) != len(self.buckets):
            raise ValueError(
                f"serve buckets must be distinct, got {self.buckets}")
        if self.swap_every < 1:
            raise ValueError(
                f"serve swap_every must be >= 1, got {self.swap_every}")
        if self.drift_at < -1:
            raise ValueError(
                f"serve drift_at must be -1 (off) or a round index, "
                f"got {self.drift_at}")

    # ------------------------------------------------------------------
    # the pure per-round plan
    # ------------------------------------------------------------------
    def arrival(self, round_index: int) -> float:
        """Diurnal arrival-rate multiplier in [1-diurnal, 1] — the same
        24h cosine as ``CampaignSchedule.arrival``, with one virtual
        hour every ``3600 / (round_minutes * 60)`` rounds."""
        hour = int(round_index * self.round_minutes * 60 // 3600)
        return round(
            1.0 - self.diurnal
            * (0.5 + 0.5 * math.cos(2.0 * math.pi * (hour % 24) / 24.0)),
            6)

    def requests_for(self, round_index: int) -> int:
        """Seeded request count for this round's traffic window: the
        diurnal base rate with ±10% multiplicative jitter from the tag-83
        stream.  Always >= 1 — a serving round never goes silent."""
        base = self.qps * self.round_minutes * 60.0 * self.arrival(
            round_index)
        u = float(np.random.default_rng(
            [self.seed, SERVE_TAG, round_index]).random())
        return max(1, int(round(base * (0.9 + 0.2 * u))))

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` requests (the largest bucket
        when none does — callers split oversize groups first)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def batch_plan(self, n_requests: int) -> List[Tuple[int, int]]:
        """Greedy (bucket, fill) plan for ``n_requests``: full max-size
        batches first, then one right-sized batch for the remainder.
        Pure in ``n_requests`` — no RNG, no clock."""
        if n_requests <= 0:
            return []
        big = self.buckets[-1]
        plan = [(big, big)] * (n_requests // big)
        rem = n_requests % big
        if rem:
            plan.append((self.bucket_for(rem), rem))
        return plan

    def padded_slots(self, n_requests: int) -> int:
        return sum(b - f for b, f in self.batch_plan(n_requests))

    def padding_waste_frac(self, n_requests: int) -> float:
        plan = self.batch_plan(n_requests)
        total = sum(b for b, _ in plan)
        if total == 0:
            return 0.0
        return round(self.padded_slots(n_requests) / total, 6)

    def weights_version(self, round_index: int) -> int:
        """Version of the weights serving round ``round_index`` — pure
        in the round index (``1 + r // swap_every``), so replay and
        kill/resume re-derive the whole swap sequence with no serve
        state in the checkpoint."""
        return 1 + round_index // self.swap_every

    def swap(self, round_index: int) -> bool:
        """True when this round publishes fresh weights."""
        return round_index % self.swap_every == 0

    def drift_injected(self, round_index: int) -> bool:
        return self.drift_at >= 0 and round_index >= self.drift_at

    def record_fields(self, round_index: int) -> Dict[str, object]:
        """The pure (replay-checked) fields of round ``round_index``'s
        ``serve`` record, keyed exactly as ``SERVE_FIELDS``."""
        n = self.requests_for(round_index)
        plan = self.batch_plan(n)
        return {
            "round_index": int(round_index),
            "weights_version": self.weights_version(round_index),
            "requests": n,
            "batches": len(plan),
            "padded_slots": self.padded_slots(n),
            "padding_waste_frac": self.padding_waste_frac(n),
            "drift_injected": self.drift_injected(round_index),
            "swap": self.swap(round_index),
        }

    def expected_records(
            self, round_indices: Iterable[int]
    ) -> List[Tuple[int, Dict[str, object]]]:
        """(round_index, pure fields) for every serving round — the
        replay oracle ``control/replay.check_serve_records`` diffs the
        stream against."""
        return [(int(r), self.record_fields(int(r)))
                for r in round_indices]

    def spec_string(self) -> str:
        """Canonical spec that parses back to ``self`` (header config)."""
        return (f"qps={self.qps:g},round_minutes={self.round_minutes:g},"
                f"diurnal={self.diurnal:g},"
                f"buckets={'+'.join(str(b) for b in self.buckets)},"
                f"swap_every={self.swap_every},drift_at={self.drift_at},"
                f"seed={self.seed}")


class MicroBatcher:
    """Bounded queue → pad-to-bucket → dispatch, with latency telemetry.

    ``dispatch`` is any callable taking a padded ``[bucket, ...]`` batch
    and returning per-row outputs; the batcher slices the pad rows back
    off before handing results to the caller.  Padding uses row 0 as
    filler (a real sample, so the dispatched batch is always valid
    input) — pad outputs are discarded, never scored.
    """

    def __init__(self, schedule: ServeSchedule,
                 dispatch: Callable[[np.ndarray], np.ndarray],
                 max_queue: int = 8192):
        self.schedule = schedule
        self.dispatch = dispatch
        self.max_queue = int(max_queue)
        self._queue: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, request: np.ndarray) -> None:
        """Enqueue one request (a single sample, no batch axis)."""
        if len(self._queue) >= self.max_queue:
            raise OverflowError(
                f"serve queue full ({self.max_queue} requests)")
        self._queue.append(np.asarray(request))

    def drain(self) -> Tuple[List[np.ndarray], Dict[str, float]]:
        """Batch, pad, and dispatch every queued request.

        Returns (per-request outputs in submit order, telemetry dict
        with requests/batches/padded_slots/padding_waste_frac plus
        advisory serve_p50_ms/serve_p99_ms/serve_qps).
        """
        requests = self._queue
        self._queue = []
        n = len(requests)
        plan = self.schedule.batch_plan(n)
        outputs: List[np.ndarray] = []
        latencies_ms: List[float] = []
        # every dispatch below returns host numpy (the predictor syncs),
        # so the elapsed read covers execution; an empty drain times nothing
        t_all0 = time.perf_counter()
        cursor = 0
        for bucket, fill in plan:
            group = requests[cursor:cursor + fill]
            cursor += fill
            batch = np.stack(group + [group[0]] * (bucket - fill))
            t0 = time.perf_counter()
            out = np.asarray(self.dispatch(batch))
            latencies_ms.append((time.perf_counter() - t0) * 1e3)
            outputs.extend(out[:fill])
        elapsed = max(time.perf_counter() - t_all0, 1e-9)
        padded = sum(b - f for b, f in plan)
        total_slots = sum(b for b, _ in plan)
        lat = np.asarray(latencies_ms, np.float64)
        telemetry = {
            "requests": float(n),
            "batches": float(len(plan)),
            "padded_slots": float(padded),
            "padding_waste_frac":
                round(padded / total_slots, 6) if total_slots else 0.0,
            "serve_p50_ms":
                float(np.percentile(lat, 50)) if lat.size else 0.0,
            "serve_p99_ms":
                float(np.percentile(lat, 99)) if lat.size else 0.0,
            "serve_qps": float(n / elapsed),
        }
        return outputs, telemetry
