"""Double-buffered round-boundary weight hot-swap.

Port of ``federated_pytorch_test_tpu/serve/swap.py``.  Training and
serving share one process; the swap is how a freshly trained consensus
reaches the request path without a restart.  Two invariants:

- **Never torn.**  ``publish`` installs ``(version, weights)`` with a
  single attribute assignment, under the lock, and ``acquire`` returns the
  whole tuple, so a request in flight during a swap is answered by exactly
  the old or exactly the new weights.
- **Replayable.**  Which version serves round r is not decided here: it is
  ``ServeSchedule.weights_version(r) = 1 + r // swap_every``, a pure
  function of the round index, so kill/resume and ``control/replay.py``
  re-derive the swap sequence with no serve state in the checkpoint.

``publish(block=True)`` first waits for the incoming tensors: for every
CUDA device a leaf lies on, that device's current stream is synchronised
(the consensus was computed there, so its copy has landed when the stream
is idle).  Host tensors have nothing to wait for.  ``swap_gap_seconds``
(the publish wall time, the wait included) is advisory telemetry.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Tuple

import torch

from federated_pytorch_test_tpu_torch.utils.tree import leaves


def version_for(round_index: int, swap_every: int) -> int:
    """Weights version serving round ``round_index`` (pure)."""
    return 1 + round_index // swap_every


def wait_ready(weights: Any) -> None:
    """Block until every CUDA leaf of ``weights`` is computed: synchronise
    the current stream of each CUDA device the leaves lie on."""
    devices = {t.device for t in leaves(weights)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class DoubleBuffer:
    """Holds the served weights; swap by atomic reference replacement."""

    def __init__(self) -> None:
        self._active: Optional[Tuple[int, Any]] = None
        # serialises concurrent publishers (and their swap/gap counters);
        # readers stay lock-free: acquire() snapshots the one tuple
        self._lock = threading.Lock()
        self.swaps = 0
        self.last_gap_seconds = 0.0

    def publish(self, version: int, weights: Any,
                block: bool = False) -> float:
        """Install ``weights`` as version ``version``; returns the swap gap
        in seconds.  ``block=True`` waits for the incoming tensors first
        (:func:`wait_ready`), so the gap covers their computation, not
        just the pointer flip.  Re-publishing the current version (a
        forced refresh from the control plane) counts as a swap but does
        not bump the version."""
        t0 = time.perf_counter()
        if block:
            wait_ready(weights)
        with self._lock:
            # the swap itself: one attribute assignment, so a lock-free
            # acquire() never sees a torn pair
            self._active = (int(version), weights)
            gap = time.perf_counter() - t0
            self.swaps += 1
            self.last_gap_seconds = gap
        return gap

    def acquire(self) -> Tuple[int, Any]:
        """Snapshot ``(version, weights)`` for one request batch; the
        caller keeps the tuple even if a publish lands mid-batch."""
        active = self._active
        if active is None:
            raise RuntimeError("DoubleBuffer.acquire before first publish")
        return active

    @property
    def version(self) -> int:
        active = self._active
        return -1 if active is None else active[0]
