"""LOFAR visibility data pipeline for CPC (reference federated_cpc.py:52-108).

Numpy mirror of ``federated_pytorch_test_tpu/data/lofar.py``: the same
minibatches, byte for byte, from the same ``(seed, round, client)``-keyed
draws.  A minibatch is a random baseline subset mapped to an 8-channel
image (4 pol x re/im, scale factors applied), unfolded into
``patch_size`` patches with 50% overlap and clamped to +-1e6, returned
NHWC as ``[batch*px*py, patch, patch, 8]``.

When a file is missing (the LOFAR extracts are not in the repository), a
deterministic synthetic visibility cube keyed on (file name, SAP) stands
in.  Unlike the JAX package, the cube is built once per (file name, SAP)
and kept: it depends on nothing else, so the arrays stay byte-equal, and a
full-width round no longer spends most of its host time rebuilding it.
``h5py`` is imported only when a file exists on disk.
"""

from __future__ import annotations

import functools
import hashlib
import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def _cached_cube(name: str, sap: str) -> Tuple[np.ndarray, np.ndarray]:
    vis, scale = _synthetic_cube(name, sap)
    vis.setflags(write=False)
    scale.setflags(write=False)
    return vis, scale


def _synthetic_cube(filename: str, sap: str, nbase: int = 64, ntime: int = 64,
                    nfreq: int = 64):
    """Deterministic synthetic (visibilities, scale_factors) for one SAP."""
    seed = int.from_bytes(
        hashlib.sha256(f"{os.path.basename(filename)}:{sap}".encode())
        .digest()[:4], "little")
    rng = np.random.default_rng(seed)
    t = np.arange(ntime)[:, None]
    f = np.arange(nfreq)[None, :]
    vis = np.zeros((nbase, ntime, nfreq, 4, 2), np.float32)
    for b in range(nbase):
        # per-baseline fringe rates/delays; per-pol amplitude
        rate = rng.uniform(0.02, 0.3)
        delay = rng.uniform(0.02, 0.3)
        amp = rng.uniform(0.5, 2.0, size=4)
        phase = 2 * np.pi * (rate * t + delay * f) + rng.uniform(0, 2 * np.pi)
        for p in range(4):
            vis[b, :, :, p, 0] = amp[p] * np.cos(phase)
            vis[b, :, :, p, 1] = amp[p] * np.sin(phase)
        # RFI-like narrowband spikes in a few channels
        for _ in range(rng.integers(1, 4)):
            ch = rng.integers(0, nfreq)
            vis[b, :, ch, :, :] += rng.normal(0, 10.0, size=(ntime, 4, 2))
    vis += rng.normal(0, 0.3, size=vis.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(nbase, nfreq, 4)).astype(np.float32)
    return vis.astype(np.float32), scale


def extract_patches(x: np.ndarray, patch_size: int, stride: int) -> Tuple[int, int, np.ndarray]:
    """Unfold [B, C, T, F] into [B*px*py, C, patch, patch], baseline-major:
    row r = b*px*py + ci*py + cj (the JAX package's documented order)."""
    B, C, T, F = x.shape
    px = (T - patch_size) // stride + 1
    py = (F - patch_size) // stride + 1
    s = np.lib.stride_tricks.sliding_window_view(
        x, (patch_size, patch_size), axis=(2, 3))[:, :, ::stride, ::stride]
    # s: [B, C, px, py, patch, patch] -> [B, px, py, C, patch, patch]
    out = s.transpose(0, 2, 3, 1, 4, 5).reshape(
        B * px * py, C, patch_size, patch_size)
    return px, py, out


def get_data_minibatch(filename: str, SAP: str = "0", batch_size: int = 2,
                       patch_size: int = 32,
                       rng: np.random.Generator | None = None
                       ) -> Tuple[int, int, np.ndarray]:
    """One CPC minibatch: (patchx, patchy, y) with y
    [batch*px*py, patch, patch, 8] float32 NHWC."""
    rng = rng or np.random.default_rng()

    def fill(x, g, h):
        baselines = rng.integers(0, g.shape[0], batch_size)
        for ck, mybase in enumerate(baselines):
            for ci in range(4):
                sf = np.asarray(h[mybase, :, ci])[None, :]   # [1, nfreq]
                x[ck, 2 * ci] = np.asarray(g[mybase, :, :, ci, 0]) * sf
                x[ck, 2 * ci + 1] = np.asarray(g[mybase, :, :, ci, 1]) * sf

    if os.path.isfile(filename):
        import h5py

        with h5py.File(filename, "r") as f:
            g = f["measurement"]["saps"][SAP]["visibilities"]
            h = f["measurement"]["saps"][SAP]["visibility_scale_factors"]
            nbase, ntime, nfreq, npol, _ = g.shape
            x = np.zeros((batch_size, 8, ntime, nfreq), np.float32)
            fill(x, g, h)
    else:
        vis, scale = _cached_cube(os.path.basename(filename), SAP)
        nbase, ntime, nfreq, npol, _ = vis.shape
        x = np.zeros((batch_size, 8, ntime, nfreq), np.float32)
        fill(x, vis, scale)

    px, py, y = extract_patches(x, patch_size, patch_size // 2)
    np.clip(y, -1e6, 1e6, out=y)
    return px, py, np.ascontiguousarray(y.transpose(0, 2, 3, 1))  # NHWC


class CPCDataSource:
    """Per-client (file, SAP) assignment — reference federated_cpc.py:137-145."""

    def __init__(self, file_list: List[str], sap_list: List[str],
                 batch_size: int = 128, patch_size: int = 32, seed: int = 0):
        if len(file_list) != len(sap_list):
            raise ValueError(f"{len(file_list)} files but {len(sap_list)} SAPs")
        self.file_list = file_list
        self.sap_list = sap_list
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.seed = seed
        # sequences the round counter between the caller's thread and a
        # RoundPrefetcher producer; every draw is keyed on (seed, round,
        # client), so the lock cannot change a sampled value
        self._lock = threading.Lock()
        self._round = 0

    @property
    def K(self) -> int:
        return len(self.file_list)

    def round_batches(self, niter: int,
                      clients: Optional[Sequence[int]] = None
                      ) -> Tuple[int, int, np.ndarray]:
        """[len(clients), niter, batch*px*py, patch, patch, 8] for one
        communication round (``clients`` defaults to all K), drawn from
        ``default_rng([seed, round, client])``."""
        clients = range(self.K) if clients is None else clients
        with self._lock:
            rnd = self._round
            self._round += 1
        out = []
        px = py = None
        for ck in clients:
            rng = np.random.default_rng([self.seed, rnd, ck])
            its = []
            for _ in range(niter):
                px, py, y = get_data_minibatch(
                    self.file_list[ck], self.sap_list[ck], self.batch_size,
                    self.patch_size, rng)
                its.append(y)
            out.append(np.stack(its))
        return px, py, np.stack(out)


class RoundPrefetcher:
    """Background producer over :meth:`CPCDataSource.round_batches`: builds
    round n+1's host tensor while round n trains.  ``Queue(maxsize=1)``
    bounds host memory at about two rounds in flight."""

    def __init__(self, source: CPCDataSource, niter: int, total_rounds: int,
                 clients: Optional[Sequence[int]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = False
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(source, niter, total_rounds, clients),
            daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer closed us."""
        while not self._stop:
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, source, niter, total, clients):
        try:
            for _ in range(total):
                if not self._put(source.round_batches(niter, clients)):
                    return
        except Exception as e:          # relayed to get()
            self._exc = e
            self._put(None)

    def get(self) -> Tuple[int, int, np.ndarray]:
        item = self._q.get()
        if item is None:
            raise RuntimeError("CPC prefetch producer failed") from self._exc
        return item

    def close(self) -> None:
        """Stop the producer and join it, so no producer is still advancing
        the source's round counter when the caller reuses the source."""
        self._stop = True
        self._thread.join()
