"""Pluggable event sinks for run telemetry.

A copy of ``federated_pytorch_test_tpu/obs/sinks.py`` for the port (the
port imports nothing of the JAX package).

A sink receives every schema-validated record (``run_header`` /
``round`` / ``summary``) from a :class:`~.recorder.RunRecorder`:

- :class:`JsonlSink`  — one JSON object per line, append mode (a
  resumed run extends the same file), flushed per record so a killed
  run keeps everything up to its last completed round.  A transient
  ``OSError`` on the per-record write is retried with bounded backoff;
  a persistently failing filesystem degrades the sink to an in-memory
  overflow buffer (one structured warning, the run keeps going —
  telemetry must never kill training).  ``close()`` makes one last
  attempt to land the overflow on disk.
- :class:`CsvSink`    — ``round`` records only; columns fixed by the
  first round record (later extra keys are dropped, missing keys blank)
  so the file stays loadable by anything that reads CSV.
- :class:`StdoutSink` — raw JSONL to stdout (pipe into ``obs.report``).
- :class:`MemorySink` — in-process list, for tests.

``make_sinks`` parses the ``--obs-sinks`` spec (comma-separated; see
``SINK_CHOICES``).  ``"auto"`` resolves to ``jsonl`` when an
``--obs-dir`` is set and to ``none`` otherwise, which is what makes
observability default-on for driver runs but file-free for bare
engine-API callers (unit tests).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, List, Optional, Tuple

SINK_CHOICES = ("auto", "none", "jsonl", "csv", "stdout", "memory")


class Sink:
    """Interface: ``emit`` one validated record dict; ``close`` once."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    #: per-record write attempts before the sink degrades; backoff is
    #: ``retry_backoff * 2**i`` between attempts (tiny — this guards
    #: against transient EAGAIN/ENOSPC blips, not outages)
    RETRIES = 3
    #: overflow cap: a degraded long run must not eat the heap; the
    #: newest records win because the tail is what post-mortems read
    OVERFLOW_CAP = 10_000

    def __init__(self, path: str, retry_backoff: float = 0.05,
                 sleep=time.sleep):
        self.path = path
        self.retry_backoff = float(retry_backoff)
        self._sleep = sleep
        self._f: Optional[IO[str]] = None
        self.degraded = False
        self.overflow: List[dict] = []
        self.dropped = 0

    def _write_line(self, line: str) -> None:
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(line)
        self._f.flush()

    def _buffer(self, record: dict) -> None:
        if len(self.overflow) >= self.OVERFLOW_CAP:
            self.overflow.pop(0)
            self.dropped += 1
        self.overflow.append(record)

    def emit(self, record: dict) -> None:
        if self.degraded:
            self._buffer(record)
            return
        line = json.dumps(record) + "\n"
        last: Optional[OSError] = None
        for i in range(self.RETRIES):
            try:
                self._write_line(line)
                return
            except OSError as e:
                last = e
                # a failed write leaves the handle in an unknown state;
                # drop it so the retry reopens (append mode, no loss)
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass
                self._f = None
                if i + 1 < self.RETRIES and self.retry_backoff > 0:
                    self._sleep(self.retry_backoff * (2.0 ** i))
        # persistent failure: degrade to the in-memory overflow buffer
        # with ONE structured warning — telemetry never kills the run
        self.degraded = True
        self._buffer(record)
        print(json.dumps({"event": "sink_degraded", "sink": "jsonl",
                          "path": self.path, "retries": self.RETRIES,
                          "error": str(last)}),
              file=sys.stderr, flush=True)

    def close(self) -> None:
        if self.degraded and self.overflow:
            # one last attempt: the filesystem may have come back
            try:
                self._write_line("".join(json.dumps(r) + "\n"
                                         for r in self.overflow))
                self.overflow = []
                self.degraded = False
            except OSError:
                pass
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


class CsvSink(Sink):
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO[str]] = None
        self._writer = None
        self._columns: Optional[List[str]] = None

    def emit(self, record: dict) -> None:
        import csv

        if record.get("event") != "round":
            return
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # append mode like JsonlSink; a resumed run whose first new
            # record has the same shape just keeps extending the table
            new = not os.path.exists(self.path)
            self._f = open(self.path, "a", newline="")
            self._columns = list(record.keys())
            self._writer = csv.DictWriter(self._f, self._columns,
                                          extrasaction="ignore",
                                          restval="")
            if new:
                self._writer.writeheader()
        row = {k: record.get(k, "") for k in self._columns}
        # lists (e.g. accuracy) would explode the cell; keep them JSON
        row = {k: json.dumps(v) if isinstance(v, (list, dict)) else v
               for k, v in row.items()}
        self._writer.writerow(row)
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutSink(Sink):
    def emit(self, record: dict) -> None:
        print(json.dumps(record), flush=True)


class MemorySink(Sink):
    def __init__(self):
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


def make_sinks(spec: str, obs_dir: Optional[str] = None,
               run_name: str = "run") -> Tuple[List[Sink], Optional[str]]:
    """Build sinks from a comma-separated spec.

    Returns ``(sinks, jsonl_path)`` — the path is reported back so
    callers (bench.py) can record where the artifact went.  File sinks
    land in ``obs_dir`` (created on first write) as
    ``<run_name>.jsonl`` / ``<run_name>.csv``; requesting one without
    an ``obs_dir`` defaults to ``./obs``.
    """
    tokens = [t.strip() for t in (spec or "auto").split(",") if t.strip()]
    resolved: List[str] = []
    for t in tokens:
        if t not in SINK_CHOICES:
            raise ValueError(
                f"unknown obs sink {t!r}; expected one of {SINK_CHOICES}")
        if t == "auto":
            t = "jsonl" if obs_dir else "none"
        if t != "none" and t not in resolved:
            resolved.append(t)
    sinks: List[Sink] = []
    jsonl_path = None
    for t in resolved:
        if t in ("jsonl", "csv") and obs_dir is None:
            obs_dir = "obs"
        if t == "jsonl":
            jsonl_path = os.path.join(obs_dir, run_name + ".jsonl")
            sinks.append(JsonlSink(jsonl_path))
        elif t == "csv":
            sinks.append(CsvSink(os.path.join(obs_dir, run_name + ".csv")))
        elif t == "stdout":
            sinks.append(StdoutSink())
        elif t == "memory":
            sinks.append(MemorySink())
    return sinks, jsonl_path
