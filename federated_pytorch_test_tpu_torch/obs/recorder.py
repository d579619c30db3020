"""RunRecorder: the per-run event emitter the engines thread through.

Port of ``federated_pytorch_test_tpu/obs/recorder.py``: the same records,
validated by the same schema.  The run header names the platform
(``"gpu"`` or ``"cpu"``), the torch version and, on a card, the CUDA
version and the card's name, and ``clock_offset_ns``
(:func:`clock_offset_ns`), which maps the stream's ``perf_counter`` stamps
onto the clock of ``torch.profiler``'s events; the round records carry the
CUDA allocator's memory counters (:func:`device_memory_stats`).  The port
emits no ``compile`` records.

Lifecycle::

    rec = make_recorder(obs_sinks=cfg.obs_sinks, obs_dir=cfg.obs_dir,
                        run_name="federated_multi", engine="classifier",
                        algorithm="fedavg")
    rec.open(config=dataclasses.asdict(cfg), mesh_shape=dict(mesh.shape),
             resumed=False, rounds_prior=0)
    for ...:
        rec.round({...per-round fields...})       # one per comm round
    rec.close(status="completed")                 # or "aborted"

Everything happens on the HOST at round boundaries, so with sinks disabled
(``obs_sinks="none"``) the recorder short-circuits to no-ops and the
numerical path is bit-identical by construction.

``round()`` enforces strictly increasing ``round_index`` (the engines
use the global history length, which the mid-run checkpoint restores),
so a resumed run APPENDS monotonically to the same JSONL — never
duplicates.
"""

from __future__ import annotations

import os
import socket
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import torch

from federated_pytorch_test_tpu_torch.obs.metrics import Metrics
from federated_pytorch_test_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
    SchemaError,
    json_safe,
    validate_record,
)
from federated_pytorch_test_tpu_torch.obs.sinks import MemorySink, Sink, make_sinks

#: round fields summed into *_total summary fields
_SUMMED = ("bytes_on_wire", "bytes_dense", "images", "guard_trips",
           "fault_dropped", "fault_straggled", "fault_corrupted")
_SUMMED_SECONDS = ("round_seconds", "stage_seconds", "comm_seconds")


def device_memory_stats(device=None) -> Dict[str, int]:
    """``torch.cuda.memory_allocated`` and ``max_memory_allocated`` of the
    trainer's CUDA ``device`` as ``mem_bytes_in_use`` and
    ``mem_peak_bytes_in_use``; ``{}`` on the CPU (the round record then
    omits the fields, per the schema's "where available")."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    return {"mem_bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "mem_peak_bytes_in_use":
                int(torch.cuda.max_memory_allocated(device))}


def clock_offset_ns(tries: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the pair read with
    the smallest gap out of ``tries``: a stream stamp ``t`` (perf_counter
    seconds) lies at ``t * 1e9 + offset`` on ``time.time_ns``'s clock,
    the clock of ``torch.profiler``'s events."""
    best = None
    for _ in range(tries):
        a = time.time_ns()
        p = time.perf_counter_ns()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - p)
    return best[1]


def git_rev() -> Optional[str]:
    """Short git rev of the source tree, or None outside a checkout."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        p = subprocess.run(["git", "-C", root, "rev-parse", "--short",
                            "HEAD"], capture_output=True, text=True,
                           timeout=5)
    except Exception:
        return None
    rev = p.stdout.strip()
    return rev if p.returncode == 0 and rev else None


class RunRecorder:
    """Validates records against the schema and fans them out to sinks."""

    def __init__(self, sinks: Sequence[Sink], *, engine: str,
                 algorithm: Optional[str] = None, run_name: str = "run",
                 run_id: Optional[str] = None,
                 jsonl_path: Optional[str] = None, device=None):
        self.sinks = list(sinks)
        self.device = torch.device(device or "cpu")
        self.engine = engine
        self.algorithm = algorithm
        self.run_name = run_name
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self.jsonl_path = jsonl_path
        self.enabled = bool(self.sinks)
        self.totals = Metrics()
        self._opened = False
        self._closed = False
        self._t0 = None
        self._last_index: Optional[int] = None
        self._loss_first: Optional[float] = None
        self._loss_final: Optional[float] = None
        # live run-health layer (schema v5): the run-level span id every
        # round/phase span parent-links to, the [min, max] host-monotonic
        # extent of the spans seen (the run span emitted at close), the
        # attached streaming watchdog (obs/health.py; sink-independent —
        # it observes round records even when no sink is configured), and
        # the alert tally surfaced on the summary
        self.run_span_id: Optional[str] = None
        self.health = None
        self._span_extent: Optional[List[float]] = None
        self._alerts = 0
        # closed-loop control plane (schema v8): the attached Controller
        # (control/policy.py; sink-independent like the watchdog) and the
        # intervention tally surfaced on the summary
        self.control = None
        self._controls = 0
        # the device-memory high-watermark tracked across round records
        # (device_memory_stats is instantaneous; the run-level peak
        # belongs on the summary)
        self._mem_watermark: Optional[int] = None
        self._mem_final: Optional[int] = None

    @property
    def memory(self) -> Optional[List[dict]]:
        """Records captured by the first MemorySink, if one is attached."""
        for s in self.sinks:
            if isinstance(s, MemorySink):
                return s.records
        return None

    def _emit(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        validate_record(rec)
        for s in self.sinks:
            s.emit(rec)
        return rec

    def attach_health(self, monitor) -> None:
        """Tap a :class:`~..obs.health.HealthMonitor` into the round
        stream.  In-process and sink-independent: the monitor observes
        every round record (and can trip an abort) even when no sink is
        configured; its alert records only hit disk when sinks exist."""
        self.health = monitor
        if monitor is not None:
            monitor.recorder = self

    def attach_control(self, controller) -> None:
        """Tap a :class:`~..control.policy.Controller` into the round
        stream.  Like the watchdog it is in-process and sink-independent.
        Feed order matters for replay: the controller observes each
        round record BEFORE the health monitor runs on it (the monitor
        may emit alert records, which the controller also observes), so
        the in-process observation order equals the JSONL file order —
        round N, then round N's alerts — and ``control.replay`` can
        re-derive decisions by feeding records in file order."""
        self.control = controller
        if controller is not None:
            controller.recorder = self

    def _grow_extent(self, t_start, t_end) -> None:
        if not (isinstance(t_start, (int, float))
                and isinstance(t_end, (int, float))):
            return
        if self._span_extent is None:
            self._span_extent = [float(t_start), float(t_end)]
        else:
            self._span_extent[0] = min(self._span_extent[0], float(t_start))
            self._span_extent[1] = max(self._span_extent[1], float(t_end))

    def open(self, *, config: Optional[dict] = None,
             mesh_shape: Optional[dict] = None, resumed: bool = False,
             rounds_prior: int = 0,
             extra: Optional[dict] = None) -> Optional[dict]:
        """Emit the run-header event; returns it (None when disabled)."""
        self._opened = True
        self._t0 = time.monotonic()
        self._last_index = rounds_prior - 1 if rounds_prior else None
        self.run_span_id = uuid.uuid4().hex[:12]
        if not self.enabled:
            return None
        cuda = self.device.type == "cuda"
        rec: Dict[str, Any] = {
            "event": "run_header", "schema": SCHEMA_VERSION,
            "run_id": self.run_id, "run_name": self.run_name,
            "span_id": self.run_span_id,
            "engine": self.engine, "time_unix": time.time(),
            "devices": 1, "local_devices": 1,
            "platform": "gpu" if cuda else "cpu",
            "torch_version": torch.__version__,
            "resumed": bool(resumed), "rounds_prior": int(rounds_prior),
            "host": socket.gethostname(), "pid": os.getpid(),
            "clock_offset_ns": clock_offset_ns(),
        }
        if cuda:
            rec["cuda_version"] = torch.version.cuda
            rec["device_name"] = torch.cuda.get_device_name(self.device)
        if self.algorithm is not None:
            rec["algorithm"] = self.algorithm
        rev = git_rev()
        if rev is not None:
            rec["git_rev"] = rev
        if config is not None:
            rec["config"] = json_safe(config)
        if mesh_shape is not None:
            rec["mesh_shape"] = json_safe(mesh_shape)
        if extra:
            rec.update(json_safe(extra))
        return self._emit(rec)

    def round(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit one round record; enforces monotone ``round_index``.

        When the caller includes a numeric ``t_start`` (host
        ``perf_counter`` at round entry) the record doubles as the
        round's SPAN: it gains ``span_id``/``parent_span``/``t_end``
        (schema v5, additive).  Without ``t_start`` the record is
        emitted exactly as in v4 — no span fields, no run span at
        close — so pre-v5 consumers and the lifecycle tests see an
        unchanged stream.
        """
        if (not self.enabled and self.health is None
                and self.control is None):
            return None
        idx = fields.get("round_index")
        if not isinstance(idx, int):
            raise SchemaError(f"round() needs an int round_index, "
                              f"got {idx!r}")
        if self._last_index is not None and idx <= self._last_index:
            raise SchemaError(
                f"round_index went backwards: {idx} after "
                f"{self._last_index} (duplicate or out-of-order round)")
        self._last_index = idx
        rec = {"event": "round", "schema": SCHEMA_VERSION,
               "run_id": self.run_id, "engine": self.engine}
        if self.algorithm is not None:
            rec["algorithm"] = self.algorithm
        rec.update(json_safe(fields))
        t_start = rec.get("t_start")
        if (isinstance(t_start, (int, float))
                and not isinstance(t_start, bool)):
            rec.setdefault("span_id", uuid.uuid4().hex[:12])
            if self.run_span_id is not None:
                rec.setdefault("parent_span", self.run_span_id)
            if "t_end" not in rec:
                secs = rec.get("round_seconds")
                if isinstance(secs, (int, float)):
                    rec["t_end"] = float(t_start) + float(secs)
            self._grow_extent(t_start, rec.get("t_end", t_start))
        if self.enabled:
            self.totals.counter("rounds").inc()
            for k in _SUMMED:
                v = rec.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.totals.counter(k + "_total").inc(v)
            for k in _SUMMED_SECONDS:
                v = rec.get(k)
                if isinstance(v, (int, float)):
                    self.totals.timer(k[: -len("_seconds")]).observe(v)
            if isinstance(rec.get("quarantined"), int):
                self.totals.gauge("quarantined_last").set(rec["quarantined"])
            for k in ("mem_peak_bytes_in_use", "mem_bytes_in_use"):
                v = rec.get(k)
                if isinstance(v, int) and not isinstance(v, bool):
                    if self._mem_watermark is None or v > self._mem_watermark:
                        self._mem_watermark = v
                    break  # prefer the backend's peak over instantaneous
            v = rec.get("mem_bytes_in_use")
            if isinstance(v, int) and not isinstance(v, bool):
                self._mem_final = v
            loss = rec.get("loss")
            if isinstance(loss, (int, float)):
                if self._loss_first is None:
                    self._loss_first = float(loss)
                self._loss_final = float(loss)
            out = self._emit(rec)
        else:
            out = rec  # watchdog-only mode: observe, never write
        if self.control is not None:
            # BEFORE health: the monitor may emit alert records during
            # observe(), and the controller must see round N before
            # round N's alerts (file order — see attach_control)
            self.control.observe(rec)
        if self.health is not None:
            self.health.observe(rec)
        return out

    def span(self, name: str, t_start: float, t_end: float, *,
             cat: str = "phase", round_index: Optional[int] = None,
             parent_span: Optional[str] = None,
             span_id: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[dict]:
        """Emit a phase/sub-operation span record (schema v5).

        Timestamps are host-monotonic (``time.perf_counter``); device
        phases must bound them with the engines' EXISTING ``_obs_sync``
        barriers — ``span()`` itself never touches the device.
        """
        if not self.enabled:
            return None
        rec: Dict[str, Any] = {
            "event": "span", "schema": SCHEMA_VERSION,
            "run_id": self.run_id,
            "span_id": span_id or uuid.uuid4().hex[:12],
            "name": str(name), "cat": str(cat),
            "t_start": float(t_start), "t_end": float(t_end),
        }
        parent = parent_span or self.run_span_id
        if parent is not None:
            rec["parent_span"] = parent
        if round_index is not None:
            rec["round_index"] = int(round_index)
        if extra:
            rec.update(json_safe(extra))
        self._grow_extent(rec["t_start"], rec["t_end"])
        return self._emit(rec)

    def alert(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit a watchdog alert record (schema v5).

        Counted toward the summary's ``alerts_total`` even when no sink
        is attached (the watchdog still ran); written only when one is.
        """
        self._alerts += 1
        if self.control is not None:
            # the alert is policy input too (the HealthMonitor tap);
            # fed whether or not a sink writes it — replay sees it in
            # the stream at exactly this position.  json_safe first so
            # the controller sees bit-identical values in-process and
            # from a parsed file.
            self.control.observe(json_safe(dict(fields, event="alert")))
        if not self.enabled:
            return None
        rec = {"event": "alert", "schema": SCHEMA_VERSION,
               "run_id": self.run_id, "time_unix": time.time()}
        rec.update(json_safe(fields))
        return self._emit(rec)

    def control_event(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit one ``control`` record (schema v8; control/).

        Counted toward the summary's ``interventions_total`` even when
        no sink is attached (the decision was still made); written only
        when one is.  Deliberately NO ``time_unix``: a control record
        is a pure function of recorded telemetry + round index, the
        determinism contract ``control.replay`` checks.
        """
        self._controls += 1
        if not self.enabled:
            return None
        rec = {"event": "control", "schema": SCHEMA_VERSION,
               "run_id": self.run_id}
        rec.update(json_safe(fields))
        return self._emit(rec)

    def client_event(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit one ``client`` record (schema v10; obs/clients.py).

        ``fields`` is a :func:`~..obs.clients.client_round_fields` body:
        ``round_index`` + ``clients`` plus the advisory length-K lists.
        Emitted right after the round record it describes, so file
        order equals replay order.  Like alerts, the record is policy
        input: it is fed to the controller (json_safe first, so replay
        from a parsed file sees bit-identical values) whether or not a
        sink writes it.  Deliberately NO ``time_unix`` — the ledger and
        its anomaly ranking are pure functions of the stream.
        """
        rec = {"event": "client", "schema": SCHEMA_VERSION,
               "run_id": self.run_id}
        rec.update(json_safe(fields))
        if self.control is not None:
            self.control.observe(rec)
        if not self.enabled:
            return None
        return self._emit(rec)

    def campaign_event(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit one ``campaign`` record (schema v12; ``campaign/``): a
        :meth:`~..campaign.schedule.CampaignSchedule.record_fields` body,
        right after the round record of the window's first round.  No
        ``time_unix`` and not fed to the controller: the window is a pure
        function of (campaign seed, round_index) that ``control.replay``
        re-derives from the header config."""
        if not self.enabled:
            return None
        rec = {"event": "campaign", "schema": SCHEMA_VERSION,
               "run_id": self.run_id}
        rec.update(json_safe(fields))
        return self._emit(rec)

    def serve_event(self, fields: Dict[str, Any]) -> Optional[dict]:
        """Emit one ``serve`` record (schema v13; ``serve/``): the pure
        subset (:data:`~..serve.batcher.SERVE_FIELDS`) plus the advisory
        latency, QPS and eval-stream fields.  No ``time_unix`` and not fed
        to the controller; like ``round()`` it is fed to the watchdog's
        ``observe_serve`` (whose ``serve_drift`` alert is policy input)
        even when no sink writes it."""
        if not self.enabled and self.health is None:
            return None
        rec = {"event": "serve", "schema": SCHEMA_VERSION,
               "run_id": self.run_id}
        rec.update(json_safe(fields))
        out = self._emit(rec) if self.enabled else rec
        if self.health is not None:
            self.health.observe_serve(rec)
        return out

    def close(self, status: str = "completed",
              extra: Optional[dict] = None) -> Optional[dict]:
        """Emit the summary event and close every sink. Idempotent."""
        if self._closed:
            return None
        self._closed = True
        if not self.enabled:
            return None
        if self._span_extent is not None and self.run_span_id is not None:
            # the run-level span closes the hierarchy; extent is the
            # min/max of observed span timestamps (perf_counter clock —
            # NOT self._t0, which is time.monotonic with a different base)
            self._emit({
                "event": "span", "schema": SCHEMA_VERSION,
                "run_id": self.run_id, "span_id": self.run_span_id,
                "name": "run", "cat": "run",
                "t_start": self._span_extent[0],
                "t_end": self._span_extent[1],
            })
        snap = self.totals.snapshot()
        rounds = int(snap.get("rounds", 0))
        rec: Dict[str, Any] = {
            "event": "summary", "schema": SCHEMA_VERSION,
            "run_id": self.run_id, "status": status, "rounds": rounds,
            "time_unix": time.time(),
        }
        if self._t0 is not None:
            rec["total_seconds"] = time.monotonic() - self._t0
        for k in _SUMMED:
            if k + "_total" in snap:
                v = snap[k + "_total"]
                rec[k + "_total"] = (int(v) if float(v).is_integer()
                                     else float(v))
        for k in _SUMMED_SECONDS:
            base = k[: -len("_seconds")]
            if base + "_seconds" in snap:
                rec[k + "_total"] = snap[base + "_seconds"]
        if "quarantined_last" in snap:
            rec["quarantined_last"] = snap["quarantined_last"]
        if self._loss_first is not None:
            rec["loss_first"] = self._loss_first
            rec["loss_final"] = self._loss_final
        if self._alerts or self.health is not None:
            rec["alerts_total"] = self._alerts
        if self._controls or self.control is not None:
            rec["interventions_total"] = self._controls
        if self._mem_watermark is not None:
            rec["mem_peak_bytes_watermark"] = int(self._mem_watermark)
            if self._mem_final is not None:
                rec["mem_final_vs_peak_bytes"] = int(
                    self._mem_watermark - self._mem_final)
        rs = rec.get("round_seconds_total", 0.0)
        if rounds and rs:
            rec["rounds_per_sec"] = rounds / rs
            if rec.get("images_total"):
                rec["images_per_sec"] = rec["images_total"] / rs
            if "comm_seconds_total" in rec:
                rec["comm_overhead_frac"] = rec["comm_seconds_total"] / rs
        if rec.get("bytes_dense_total"):
            rec["compression_savings_frac"] = (
                1.0 - rec.get("bytes_on_wire_total", 0)
                / rec["bytes_dense_total"])
        if extra:
            rec.update(json_safe(extra))
        out = self._emit(rec)
        for s in self.sinks:
            s.close()
        return out


def make_recorder(obs_sinks: str = "auto", obs_dir: Optional[str] = None,
                  *, run_name: str = "run", engine: str = "run",
                  algorithm: Optional[str] = None,
                  extra_sinks: Sequence[Sink] = (),
                  device=None) -> RunRecorder:
    """Build a RunRecorder from the ``--obs-sinks``/``--obs-dir`` knobs;
    ``device`` is the trainer's (the header's platform and versions)."""
    sinks, jsonl_path = make_sinks(obs_sinks, obs_dir, run_name)
    sinks.extend(extra_sinks)
    return RunRecorder(sinks, engine=engine, algorithm=algorithm,
                       run_name=run_name, jsonl_path=jsonl_path,
                       device=device)
