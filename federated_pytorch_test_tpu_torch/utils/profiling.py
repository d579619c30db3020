"""The run's trace under ``--profile-dir``.

Port of ``federated_pytorch_test_tpu/utils/profiling.py``:
:func:`profile_ctx` wraps a run in ``torch.profiler.profile`` with the CPU
activity and, on a card, the CUDA one, and writes one Chrome trace
(``trace.json``) into the directory when the run ends;
:func:`round_trace` marks each communication round with one
``record_function`` span named ``comm_round#<round_index>``, the obs
stream's round index, so the trace's rounds line up with the JSONL round
records.  Without a directory both are no-ops.

Inside a round the engines time the local epoch's step phases with a
:class:`StepClock` (host clock, no sync), and, while any profiler records
(:func:`profiler_active`: the run's own or a caller's), mark the phases,
the comm step's parts and the evaluation with ``record_function`` ranges
of their names (:func:`ranged`), nested inside ``comm_round#<n>``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

#: the shared no-op context of :func:`ranged` without a profiler
_NO_RANGE = contextlib.nullcontext()

#: the trace file :func:`profile_ctx` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_ctx(profile_dir: Optional[str], device=None):
    """``torch.profiler.profile`` over the block, its Chrome trace written
    to ``<profile_dir>/trace.json`` at the end (also when the block
    raises); a no-op when ``profile_dir`` is unset.  ``device``: the
    trainer's, whose type adds the CUDA activity."""
    if not profile_dir:
        yield None
        return
    out = os.path.abspath(os.path.expanduser(profile_dir))
    os.makedirs(out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(out, TRACE_FILE))


def round_trace(step: int, enabled: bool = True, name: str = "comm_round"):
    """One ``record_function`` span ``<name>#<step>`` over a round (the
    global round index, the obs ``round_index``); a nullcontext when
    ``enabled`` is False (no ``--profile-dir``)."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"{name}#{int(step)}")


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` records now: the run's own
    (``--profile-dir``) or a caller's.  Read once a round."""
    return bool(torch._C._autograd._profiler_enabled())


def ranged(name: str, on: bool):
    """A ``record_function`` range ``name`` when ``on`` (a profiler
    records), else a shared no-op context."""
    return torch.profiler.record_function(name) if on else _NO_RANGE


class StepClock:
    """One round's host-clock sums of the local epoch: ``ns[i]`` the time
    in step phase :data:`PHASES` ``[i]`` over every client-step, and
    ``epoch_ns`` the host's whole stay in the local-epoch calls (its
    enqueue time; the rest of it is input normalisation, per-client
    slicing and the stacks).  :meth:`start` ends the running phase and
    starts phase ``i``, :meth:`stop` ends it: one ``time.perf_counter_ns``
    read each, no device sync, nothing allocated.  With ``ranges`` (a
    profiler records) each phase is also a ``record_function`` range of
    its name.

    The forward, backward and optimizer phases time eager client-steps;
    ``client_step`` times a replayed one (its input copies, the graph's
    launch and its loss's copy out, ``train/step_graph.py``).  The counts
    say which ran: ``graph_steps`` client-steps replayed, ``eager_steps``
    dispatched eagerly, ``graph_captures`` client-step graphs captured."""

    PHASES = ("forward", "backward", "optimizer", "client_step")
    FORWARD, BACKWARD, OPTIMIZER, REPLAY = range(4)

    __slots__ = ("ns", "epoch_ns", "ranges", "graph_steps", "eager_steps",
                 "graph_captures", "_cur", "_t", "_range")

    def __init__(self, ranges: bool = False):
        self.ns = [0, 0, 0, 0]
        self.epoch_ns = 0
        self.ranges = ranges
        self.graph_steps = self.eager_steps = self.graph_captures = 0
        self._cur = -1
        self._t = 0
        self._range = None

    def start(self, i: int) -> None:
        t = time.perf_counter_ns()
        if self._cur >= 0:
            self.ns[self._cur] += t - self._t
        self._cur, self._t = i, t
        if self.ranges:
            self._close_range()
            self._range = torch.profiler.record_function(self.PHASES[i])
            self._range.__enter__()

    def stop(self) -> None:
        if self._cur >= 0:
            self.ns[self._cur] += time.perf_counter_ns() - self._t
            self._cur = -1
        if self.ranges:
            self._close_range()

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def fields(self) -> dict:
        """The round record's fields: the times in seconds, the counts."""
        fwd, bwd, opt, replay = (n / 1e9 for n in self.ns)
        return {"step_forward_seconds": fwd, "step_backward_seconds": bwd,
                "step_optimizer_seconds": opt,
                "step_replay_seconds": replay,
                "epoch_host_seconds": self.epoch_ns / 1e9,
                "graph_steps": self.graph_steps,
                "eager_steps": self.eager_steps,
                "graph_captures": self.graph_captures}
