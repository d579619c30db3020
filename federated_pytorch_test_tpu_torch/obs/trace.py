"""Span timeline exporter: obs JSONL → Chrome trace-event JSON.

A copy of ``federated_pytorch_test_tpu/obs/trace.py`` for the port; both
exporters turn the same stream into the same trace.  Schema v5 gives the
run stream a span hierarchy::

    run (span record at close, id stamped on the run_header)
    └── round N        (the round record itself, when it carries t_start)
        ├── train / stage / comm / sync ...   (span records, cat="phase")
        ├── compile <site>   (schema v6 compile records, which the JAX
        │                     package writes and the port does not:
        │                     out-of-window events parent to the RUN span)
        └── ...
    └── ckpt           (parented to the RUN span: the mid-run save runs
                        after round_seconds is measured, so hanging it
                        off the round would break laminar nesting)

``python -m federated_pytorch_test_tpu_torch.obs.trace run.jsonl -o trace.json``
converts that into Chrome trace-event / Perfetto JSON (load in
``chrome://tracing`` or https://ui.perfetto.dev).  Round spans carry
``round_index`` in their args — the index of the ``comm_round#<index>``
``record_function`` span of a ``--profile-dir`` capture
(``utils/profiling.py``) — so the host-side JSONL timeline and a
``torch.profiler`` trace correlate round for round.

Timestamps: ``t_start``/``t_end`` are host ``time.perf_counter`` stamps.
A resumed run appends a new segment (new ``run_header``) whose
perf_counter base belongs to a DIFFERENT process, so segments are split
at headers — one trace pid per segment — and anchored to wall clock via
the headers' ``time_unix`` deltas.

``--device-trace <profile-dir>/trace.json`` instead places a
``--profile-dir`` capture's device events (kernels, copies, sets) on the
stream's timeline through the header's ``clock_offset_ns`` and prints the
card's idle gaps, each labelled with the innermost program span or
``record_function`` range (``comm_round#<n>``, the step phases, the comm
step's parts, the evaluation) covering its start, and how far each
``comm_round#<n>`` range starts from round n's record (the clock check)::

    python -m federated_pytorch_test_tpu_torch.obs.trace run.jsonl \
        --device-trace prof/trace.json
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from federated_pytorch_test_tpu_torch.obs.schema import SchemaError

_EPS_US = 1e-3   # float-roundoff tolerance for nesting checks (µs)


def _segments(records: List[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Split a record stream at run_headers (resumed runs append)."""
    segs: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    for r in records:
        if r.get("event") == "run_header" and cur:
            segs.append(cur)
            cur = []
        cur.append(r)
    if cur:
        segs.append(cur)
    return segs


def _spans_in(seg: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Round records with timing + explicit span records, as one list."""
    out = []
    for r in seg:
        ev = r.get("event")
        t0, t1 = r.get("t_start"), r.get("t_end")
        if not (isinstance(t0, (int, float)) and isinstance(t1, (int, float))):
            continue
        if ev == "round":
            out.append({"span_id": r.get("span_id"),
                        "parent_span": r.get("parent_span"),
                        "name": f"round {r.get('round_index')}",
                        "cat": "round", "t_start": float(t0),
                        "t_end": float(t1),
                        "round_index": r.get("round_index"),
                        "loss": r.get("loss")})
        elif ev == "span":
            out.append({"span_id": r.get("span_id"),
                        "parent_span": r.get("parent_span"),
                        "name": r.get("name", "span"),
                        "cat": r.get("cat", "phase"),
                        "t_start": float(t0), "t_end": float(t1),
                        "round_index": r.get("round_index")})
        elif ev == "compile":
            # schema v6: compile events render as bubbles inside their
            # round (in-window) or directly under the run span (events
            # drained outside any round window, e.g. eval compiles)
            out.append({"span_id": r.get("span_id"),
                        "parent_span": r.get("parent_span"),
                        "name": f"compile {r.get('site', '?')}",
                        "cat": "compile",
                        "t_start": float(t0), "t_end": float(t1),
                        "round_index": r.get("round_index")})
    return out


def to_chrome_trace(records: List[Dict[str, Any]],
                    run_name: str = "run") -> Dict[str, Any]:
    """Build a Chrome trace-event JSON object from an obs record stream."""
    events: List[Dict[str, Any]] = []
    wall0: Optional[float] = None
    # supervisor-restart attempt per segment: the dying segment writes
    # the restart control record (with its 1-based `attempt`), so the
    # segment that FOLLOWS it is that attempt's run.  Tracked across the
    # whole stream so a segment's process name is stable no matter how
    # many empty segments the exporter skips.
    next_attempt: Optional[int] = None
    for pid, seg in enumerate(_segments(records), start=1):
        header = next((r for r in seg if r.get("event") == "run_header"), {})
        attempt = next_attempt
        for r in seg:
            if (r.get("event") == "control"
                    and r.get("intervention") == "restart"
                    and isinstance(r.get("attempt"), int)):
                next_attempt = r["attempt"]
        spans = _spans_in(seg)
        if not spans:
            continue
        # anchor this segment's perf_counter clock to wall time so
        # resumed segments land after the original instead of on top
        wall = header.get("time_unix")
        if wall0 is None and isinstance(wall, (int, float)):
            wall0 = float(wall)
        seg_t0 = min(s["t_start"] for s in spans)
        off_us = ((float(wall) - wall0) * 1e6
                  if isinstance(wall, (int, float)) and wall0 is not None
                  else 0.0)
        label = header.get("run_name") or run_name
        # stable human-readable process name: segment-<n> is the
        # position in the FULL stream (empty segments included, so
        # names never renumber when a segment gains its first span),
        # plus the supervisor restart attempt that produced it and
        # whether it resumed from a checkpoint
        seg_name = f"segment-{pid}"
        if isinstance(attempt, int):
            seg_name += f" restart-attempt-{attempt}"
        elif header.get("resumed"):
            seg_name += " resumed"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{label} ({seg_name}, "
                                        f"run {header.get('run_id', '?')})"}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 1, "args": {"name": "rounds"}})
        for s in spans:
            args: Dict[str, Any] = {"span_id": s["span_id"]}
            if s.get("parent_span"):
                args["parent_span"] = s["parent_span"]
            if s.get("round_index") is not None:
                args["round_index"] = s["round_index"]
            if s.get("loss") is not None:
                args["loss"] = s["loss"]
            events.append({
                "ph": "X", "name": s["name"], "cat": s["cat"],
                "pid": pid, "tid": 1,
                "ts": (s["t_start"] - seg_t0) * 1e6 + off_us,
                "dur": max(0.0, (s["t_end"] - s["t_start"]) * 1e6),
                "args": args,
            })
        # alerts become instant markers at their round's end
        by_round = {s["round_index"]: s for s in spans
                    if s["cat"] == "round"}
        for r in seg:
            if r.get("event") != "alert":
                continue
            anchor = by_round.get(r.get("round_index"))
            ts = ((anchor["t_end"] - seg_t0) * 1e6 + off_us
                  if anchor else off_us)
            events.append({"ph": "i", "name": f"alert:{r.get('rule')}",
                           "cat": "alert", "pid": pid, "tid": 1,
                           "ts": ts, "s": "p",
                           "args": {"rule": r.get("rule"),
                                    "severity": r.get("severity"),
                                    "message": r.get("message"),
                                    "round_index": r.get("round_index")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Dict[str, Any]) -> None:
    """Well-formedness check: shape, laminar nesting, parent containment.

    Raises :class:`SchemaError` on the first violation.  "Laminar": on
    each (pid, tid) lane any two complete events are either disjoint or
    one contains the other — the invariant trace viewers assume when
    they stack slices.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise SchemaError("trace must be a dict with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise SchemaError("traceEvents must be a list")
    lanes: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    by_id: Dict[str, Tuple[float, float]] = {}
    xs = []
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            raise SchemaError(f"event {i}: not a trace event")
        if e["ph"] != "X":
            continue
        for k in ("name", "ts", "dur", "pid", "tid"):
            if k not in e:
                raise SchemaError(f"event {i} ({e.get('name')!r}): "
                                  f"missing {k!r}")
        if e["ts"] < 0 or e["dur"] < 0:
            raise SchemaError(f"event {i} ({e['name']!r}): negative ts/dur")
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        lanes.setdefault((e["pid"], e["tid"]), []).append((lo, hi, e["name"]))
        sid = (e.get("args") or {}).get("span_id")
        if sid:
            by_id[str(sid)] = (lo, hi)
        xs.append(e)
    for lane, ivals in lanes.items():
        # widest-first on ties so a parent sharing its child's start
        # time is on the stack before the child arrives
        ivals.sort(key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[float, float, str]] = []
        for lo, hi, name in ivals:
            while stack and stack[-1][1] <= lo + _EPS_US:
                stack.pop()
            if stack and hi > stack[-1][1] + _EPS_US:
                raise SchemaError(
                    f"lane {lane}: {name!r} [{lo:.1f}, {hi:.1f}] "
                    f"straddles {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f}, {stack[-1][1]:.1f}] "
                    f"(nesting not laminar)")
            stack.append((lo, hi, name))
    for e in xs:
        args = e.get("args") or {}
        parent = args.get("parent_span")
        if not parent or str(parent) not in by_id:
            continue
        plo, phi = by_id[str(parent)]
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if lo < plo - _EPS_US or hi > phi + _EPS_US:
            raise SchemaError(
                f"span {e['name']!r} [{lo:.1f}, {hi:.1f}] escapes its "
                f"parent {parent} [{plo:.1f}, {phi:.1f}]")


#: chrome-trace categories of the card's own work (kineto's names)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the label of a gap that no span or range covers
ELSEWHERE = "outside every span"
_ROUND_RANGE = re.compile(r"^comm_round#(\d+)$")


def innermost(spans: List[Tuple[int, int, str]], points: List[int],
              default: str = ELSEWHERE) -> List[str]:
    """For each point (ascending), the label of the innermost span (spans
    properly nested) that covers it, else ``default``."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        names.append(stack[-1][2] if stack else default)
    return names


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _profile_events(trace: Dict[str, Any]):
    """The device events' and the ``record_function`` ranges' intervals
    of a ``torch.profiler`` Chrome trace, in ``time.time_ns`` ns: ``ts``
    is microseconds after ``baseTimeNanoseconds`` (0 when absent)."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    device, ranges = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat not in DEVICE_CATS and cat != "user_annotation":
            continue
        s = base + round(float(e["ts"]) * 1e3)
        t = s + round(float(e.get("dur", 0)) * 1e3)
        if cat == "user_annotation":
            ranges.append((s, t, str(e.get("name", "range"))))
        else:
            device.append((s, t))
    return device, ranges


def device_idle(records: List[Dict[str, Any]], trace: Dict[str, Any],
                from_round: int = 0) -> Dict[str, Any]:
    """The card's idle gaps of a profiled run by program phase.  The
    stream's last segment whose header carries ``clock_offset_ns`` is
    mapped onto the profiler's clock; the window runs from the first
    ``comm_round#<n>`` range's start to the last one's end, rounds before
    ``from_round`` left out (the round records' extent without ranges).
    Returns ``window_s``, ``busy_s``, ``idle_s``, ``gaps`` ({label:
    [seconds, count]}, labels with a round's index stripped) and
    ``clock_ms`` ({n: range start minus round n's ``t_start``, ms})."""
    seg = next((s for s in reversed(_segments(records))
                if isinstance(s[0].get("clock_offset_ns"), int)), None)
    if seg is None:
        raise SchemaError("no run_header with clock_offset_ns: the stream "
                          "cannot be placed on the profiler's clock")
    off = seg[0]["clock_offset_ns"]
    ns = lambda t: round(t * 1e9) + off
    spans, starts = [], {}
    for s in _spans_in(seg):
        if s["cat"] == "run":
            continue            # the run's extent, not a phase
        name = "round" if s["cat"] == "round" else s["name"]
        spans.append((ns(s["t_start"]), ns(s["t_end"]), name))
        if s["cat"] == "round":
            starts[s["round_index"]] = spans[-1][:2]
    device, ranges = _profile_events(trace)
    clock_ms, rounds = {}, []
    for s, t, name in ranges:
        m = _ROUND_RANGE.match(name)
        if m and int(m.group(1)) >= from_round:
            rounds.append((s, t))
            n = int(m.group(1))
            if n in starts:
                clock_ms[n] = (s - starts[n][0]) / 1e6
        spans.append((s, t, "comm_round" if m else name))
    extent = rounds or [se for n, se in starts.items() if n >= from_round]
    if not extent:
        raise SchemaError("neither comm_round ranges nor round records")
    w0, w1 = min(s for s, _ in extent), max(t for _, t in extent)
    busy = _union([(max(s, w0), min(t, w1)) for s, t in device
                   if t > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    by_label: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for (s, e), label in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        by_label[label][0] += (e - s) / 1e9
        by_label[label][1] += 1
    busy_s = sum(e - s for s, e in busy) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "idle_s": (w1 - w0) / 1e9 - busy_s,
            "gaps": dict(sorted(by_label.items(), key=lambda kv: -kv[1][0])),
            "clock_ms": clock_ms}


def print_device_idle(res: Dict[str, Any], file=None) -> None:
    """Print :func:`device_idle`'s result (to ``file``, default stdout)."""
    idle = res["idle_s"]
    print(f"window {res['window_s']:.6f} s, device busy {res['busy_s']:.6f} "
          f"s, idle {idle:.6f} s "
          f"({100.0 * idle / max(res['window_s'], 1e-12):.2f}%)", file=file)
    print("idle gaps by the innermost program span or range at their start:",
          file=file)
    print(f"  {'label':<24} {'seconds':>12} {'of idle':>8} {'gaps':>8}",
          file=file)
    for label, (sec, n) in res["gaps"].items():
        print(f"  {label:<24} {sec:12.6f} "
              f"{100.0 * sec / max(idle, 1e-12):7.2f}% {n:8d}", file=file)
    total = sum(v[0] for v in res["gaps"].values())
    print(f"  {'total':<24} {total:12.6f}", file=file)
    if res["clock_ms"]:
        d = res["clock_ms"]
        print(f"clock check: comm_round#<n> range start minus round n's "
              f"t_start, {len(d)} round(s): "
              + " ".join(f"{n}:{v:+.3f}" for n, v in sorted(d.items()))
              + f" ms (max |d| {max(abs(v) for v in d.values()):.3f} ms)",
              file=file)


def export(path: str, out_path: str, validate: bool = True) -> int:
    """Read a run JSONL, write Chrome trace JSON; returns #X events."""
    from federated_pytorch_test_tpu_torch.obs.report import read_records

    records = read_records(path)
    trace = to_chrome_trace(records)
    if validate:
        validate_chrome_trace(trace)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")


def selftest() -> None:
    """Recorder → JSONL → exporter round-trip on a resumed two-segment
    file; used by ``report --selftest``."""
    import os
    import tempfile

    from federated_pytorch_test_tpu_torch.obs.recorder import make_recorder

    with tempfile.TemporaryDirectory() as d:
        for seg in range(2):                      # second open() resumes
            rec = make_recorder("jsonl", d, run_name="trace_selftest",
                                engine="selftest")
            rec.open(resumed=seg > 0, rounds_prior=2 * seg)
            for i in range(2 * seg, 2 * seg + 2):
                t0 = 10.0 * seg + float(i)
                rid = f"r{i:04d}aaaaaaaa"
                rec.round({"round_index": i, "round_seconds": 0.8,
                           "loss": 1.0, "t_start": t0, "span_id": rid})
                rec.span("train", t0 + 0.01, t0 + 0.6, cat="phase",
                         round_index=i, parent_span=rid)
                rec.span("comm", t0 + 0.6, t0 + 0.75, cat="comm",
                         round_index=i, parent_span=rid)
            rec.close()
        src = os.path.join(d, "trace_selftest.jsonl")
        out = os.path.join(d, "trace.json")
        n = export(src, out)
        assert n == 14, f"expected 14 X events (2 segments), got {n}"
        with open(out) as f:
            trace = json.load(f)
        validate_chrome_trace(trace)
        rounds = [e for e in trace["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") == "round"]
        assert sorted(e["args"]["round_index"] for e in rounds) == [0, 1, 2, 3]
        pids = {e["pid"] for e in rounds}
        assert len(pids) == 2, f"resumed run must split segments: {pids}"
        names = {e["pid"]: e["args"]["name"]
                 for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert "segment-1" in names[1], names
        assert "segment-2 resumed" in names[2], names


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m federated_pytorch_test_tpu_torch.obs.trace",
        description="Export an obs run JSONL to Chrome trace-event JSON "
                    "(chrome://tracing / Perfetto)")
    p.add_argument("path", help="run JSONL file")
    p.add_argument("-o", "--output", help="output .json path "
                   "(default: <input>.trace.json)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the nesting/containment validation pass")
    p.add_argument("--device-trace", metavar="TRACE_JSON",
                   help="a --profile-dir capture's trace.json: print the "
                        "card's idle gaps by program phase (no export)")
    p.add_argument("--from-round", type=int, default=0,
                   help="with --device-trace: leave out the rounds before "
                        "this index (the first round's one-off set-up)")
    args = p.parse_args(argv)
    if args.device_trace:
        from federated_pytorch_test_tpu_torch.obs.report import read_records

        try:
            with open(args.device_trace) as f:
                trace = json.load(f)
            res = device_idle(read_records(args.path), trace,
                              from_round=args.from_round)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print_device_idle(res)
        return 0
    out = args.output or (args.path + ".trace.json")
    try:
        n = export(args.path, out, validate=not args.no_validate)
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {out}: {n} span event(s)")
    if n == 0:
        print("note: no spans found — the run predates schema v5 or ran "
              "with spans disabled", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
