"""The traced window, reduced from ``torch.profiler``'s device events.

The profiler records the card only (CUDA activity: kernels, copies, sets),
which keeps the host's own pace in the window; the window is the host
interval [t0, t1] on the profiler's clock (``time.time_ns``).  The busy
time is the union of the device events' intervals inside the window.  An
idle gap is named by what the host was doing when it began: the innermost
of the benchmark's spans around the program's calls that covers its start
(``drive.SPANS``), else ``round, outside the timed calls``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10
ELSEWHERE = "round, outside the timed calls"


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device event but annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU":
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


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


def reduce(prof, t0_ns: int, t1_ns: int,
           spans: List[Tuple[int, int, str]]) -> Dict:
    """busy_s, window_s, the device operations by time, the idle gaps by
    what the host did, and each device operation's (count, seconds)."""
    events = _device_events(prof)
    dev = [(n, max(s, t0_ns), min(e, t1_ns))
           for n, s, e in events if e > t0_ns and s < t1_ns]
    if events and not dev:
        raise RuntimeError("no device event lies in the window: the "
                           "profiler's clock is not time.time_ns")
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev:
        ops[n][0] += 1
        ops[n][1] += (e - s) / 1e9
    busy = _union([(s, e) for _, s, e in dev])
    gaps, t = [], t0_ns
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < t1_ns:
        gaps.append((t, t1_ns))
    idle: Dict[str, float] = defaultdict(float)
    for (s, e), label in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        idle[label] += (e - s) / 1e9
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "device_ops": [[n, v[1]] for n, v in
                       sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [[n, v] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "kernels": {n: (v[0], v[1]) for n, v in ops.items()},
    }
