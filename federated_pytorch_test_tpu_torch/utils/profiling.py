"""The run's trace under ``--profile-dir``.

Port of ``federated_pytorch_test_tpu/utils/profiling.py``:
:func:`profile_ctx` wraps a run in ``torch.profiler.profile`` with the CPU
activity and, on a card, the CUDA one, and writes one Chrome trace
(``trace.json``) into the directory when the run ends;
:func:`round_trace` marks each communication round with one
``record_function`` span named ``comm_round#<round_index>``, the obs
stream's round index, so the trace's rounds line up with the JSONL round
records.  Without a directory both are no-ops.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

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
