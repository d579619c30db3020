"""Checkpoints of the port: the end-of-run save and the mid-run slots.

Port of ``federated_pytorch_test_tpu/utils/checkpoint.py`` with a format
of its own (orbax belongs to JAX).  A checkpoint is a directory holding

* ``tree.pt``: a flat dict ``{name: CPU tensor}`` written by
  ``torch.save`` and read back with ``torch.load(weights_only=True)``
  (nested parameter dicts flatten to ``/``-joined names,
  :func:`flatten_dict`);
* ``meta.npz``: numpy arrays of the loop counters and host ledgers, read
  with ``allow_pickle=False`` (0-d arrays come back as Python numbers);
* ``fedtpu.sha256``: the sha256 over every other file, sorted by name.

The mid-run checkpoint is crash-safe as in the JAX package: a save goes to
``path.next`` and is then swapped into ``path``, the previous round parked
at ``path.old`` (:func:`save_checkpoint_swapped`); :func:`checkpoint_slots`
lists them newest first, and a resume walks that list past a slot that
fails its checksum.  The port reads no checkpoint of the JAX package.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: content-checksum sidecar written inside each checkpoint directory
CHECKSUM_FILE = "fedtpu.sha256"
TREE_FILE = "tree.pt"
META_FILE = "meta.npz"
#: marks the scratch directory of a save in progress
_TMP_TAG = ".ckpt-tmp-"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but fails validation (checksum
    mismatch / unreadable): truncated write, bit-rot, or tampering."""


class NoUsableCheckpointError(FileNotFoundError):
    """:func:`finalize_checkpoint` found no slot on disk at all."""


class CheckpointGeometryError(ValueError):
    """The checkpoint's stamped mesh geometry is incompatible with the mesh
    trying to resume it.  Not retried by the slot-fallback walk: an older
    slot was written on the same geometry."""


def mesh_geometry_meta(*, devices: int, processes: int, K: int,
                       members=None) -> Dict[str, Any]:
    """Mesh/roster geometry keys for checkpoint ``meta`` (0-d int64 arrays;
    ``members``, the churn ledger ``[K]`` bool, rides along when given)."""
    geom: Dict[str, Any] = {
        "geom_devices": np.int64(devices),
        "geom_processes": np.int64(processes),
        "geom_K": np.int64(K),
    }
    if members is not None:
        geom["members"] = np.asarray(members, bool)
    return geom


def validate_geometry(meta: Dict[str, Any], *, devices: int, processes: int,
                      K: int, elastic: bool = False) -> None:
    """Check a checkpoint's stamped geometry against the live mesh.

    Checkpoints without ``geom_*`` keys pass unchecked.  ``K`` must always
    match: the client stack's leading axis is saved per client.  A device
    or process count that differs is legal only under ``elastic``
    (``--elastic-resume``): the client axis is laid out again onto the new
    mesh, as long as ``K % D'`` == 0 (the engines enforce it at
    construction).  Raises :class:`CheckpointGeometryError`.
    """
    if "geom_devices" not in meta:
        return
    ck_d = int(meta["geom_devices"])
    ck_k = int(meta["geom_K"])
    if ck_k != K:
        raise CheckpointGeometryError(
            f"checkpoint was written with K={ck_k} clients but this run "
            f"has K={K}: the client stack's leading axis is saved per "
            "client, so K can never change across a resume")
    if ck_d != devices and not elastic:
        raise CheckpointGeometryError(
            f"checkpoint was written on a {ck_d}-device mesh but this "
            f"run has {devices} devices; pass --elastic-resume "
            "(cfg.elastic_resume=True) to restage the client axis onto "
            "the new mesh, or resume on the original device count for "
            "bitwise continuation")
    ck_p = int(meta.get("geom_processes", processes))
    if ck_p != processes and not elastic:
        raise CheckpointGeometryError(
            f"checkpoint was written by a {ck_p}-process job but this "
            f"run has {processes} processes; a process-count change "
            "reshards the global arrays, so it is only legal under "
            "--elastic-resume (cfg.elastic_resume=True)")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _dir_checksum(path: str) -> str:
    """sha256 over every file in the checkpoint dir (sorted relpath +
    content), excluding the checksum sidecar itself."""
    h = hashlib.sha256()
    root = _abspath(path)
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn == CHECKSUM_FILE or fn.endswith(".tmp"):
                continue
            full = os.path.join(dirpath, fn)
            h.update(os.path.relpath(full, root).encode())
            h.update(b"\0")
            with open(full, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            h.update(b"\0")
    return h.hexdigest()


def write_checksum(path: str) -> None:
    """Embed the content checksum in a finished checkpoint dir (temp file
    + ``os.replace``, so a kill leaves no truncated checksum)."""
    target = os.path.join(_abspath(path), CHECKSUM_FILE)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        f.write(_dir_checksum(path) + "\n")
    os.replace(tmp, target)


def verify_checkpoint(path: str) -> bool:
    """Validate ``path`` against its embedded checksum: True (verified) or
    False (no sidecar).  Raises :class:`CheckpointCorruptError` on a
    mismatch."""
    target = os.path.join(_abspath(path), CHECKSUM_FILE)
    if not os.path.isfile(target):
        return False
    with open(target) as f:
        want = f.read().strip()
    got = _dir_checksum(path)
    if got != want:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed its content checksum (stored "
            f"{want[:12]}.., recomputed {got[:12]}..): truncated or corrupt")
    return True


def flatten_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict of tensors as one flat dict of ``/``-joined names."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten_dict(flat: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The nested dict of the names of ``flat`` under ``prefix``."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        if not name.startswith(prefix):
            continue
        node = out
        parts = name[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_checkpoint(path: str, tree: Dict[str, torch.Tensor],
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Save the flat dict of tensors ``tree`` (+ the small ``meta`` dict)
    as the checkpoint directory ``path``, replacing one that exists.  The
    files are written into a scratch directory beside ``path`` and renamed
    into place once complete."""
    root = _abspath(path)
    os.makedirs(os.path.dirname(root), exist_ok=True)
    tmp = f"{root}{_TMP_TAG}{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    cpu = {k: v.detach().to("cpu").contiguous() for k, v in tree.items()}
    torch.save(cpu, os.path.join(tmp, TREE_FILE))
    with open(os.path.join(tmp, META_FILE), "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in (meta or {}).items()})
    write_checksum(tmp)
    for _ in range(10):
        if os.path.isdir(root):
            trash = f"{tmp}.old"
            try:
                os.rename(root, trash)
            except FileNotFoundError:
                continue
            shutil.rmtree(trash, ignore_errors=True)
        try:
            os.rename(tmp, root)
            return
        except OSError:                 # another writer landed first
            continue
    raise RuntimeError(f"could not move the checkpoint into {path}")


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, Any]]:
    """``(tree, meta)`` of a checkpoint saved by :func:`save_checkpoint`:
    the flat dict of CPU tensors and the meta (0-d arrays as Python
    numbers)."""
    root = _abspath(path)
    tree = torch.load(os.path.join(root, TREE_FILE), map_location="cpu",
                      weights_only=True)
    with np.load(os.path.join(root, META_FILE), allow_pickle=False) as z:
        meta = {k: z[k].item() if z[k].ndim == 0 else z[k] for k in z.files}
    return tree, meta


def newest_slot(path: str) -> Optional[str]:
    """The newest on-disk checkpoint among the swap slots."""
    slots = checkpoint_slots(path)
    return slots[0] if slots else None


def checkpoint_slots(path: str) -> List[str]:
    """All on-disk swap slots for ``path``, newest first.  The order is
    static: ``path.next`` survives only a crash after its save completed
    and before the swap, so it is the newest when present; ``path.old`` is
    the previous round's, always the oldest."""
    return [cand for cand in (path + ".next", path, path + ".old")
            if os.path.isdir(_abspath(cand))]


def finalize_checkpoint(path: str) -> str:
    """Resolve and checksum-verify the newest slot; returns its path.
    Raises :class:`CheckpointCorruptError` on a checksum mismatch and
    :class:`NoUsableCheckpointError` when no slot exists."""
    newest = newest_slot(path)
    if newest is None:
        raise NoUsableCheckpointError(
            f"no checkpoint slot on disk for {path!r} — nothing to "
            "finalize on abort")
    verify_checkpoint(newest)
    return newest


def _promote_and_sweep(path: str) -> None:
    """Pre-save slot surgery: a ``path.next`` stranded by a crash (save
    complete, swap never ran) is chained into the primary by renames only
    (the only directory removed is ``path.old``, by protocol the oldest),
    and scratch directories of saves killed mid-write are swept once an
    hour old."""
    nxt_path, old_path = _abspath(path + ".next"), _abspath(path + ".old")
    root = _abspath(path)
    if os.path.isdir(nxt_path):
        if os.path.isdir(root):
            shutil.rmtree(old_path, ignore_errors=True)
            os.rename(root, old_path)
        os.rename(nxt_path, root)
    now = time.time()
    for tmp in glob.glob(glob.escape(root) + "*" + _TMP_TAG + "*"):
        try:
            stale = now - os.path.getmtime(tmp) > 3600.0
        except OSError:
            continue
        if stale:
            shutil.rmtree(tmp, ignore_errors=True)
    if os.path.isdir(nxt_path):
        raise RuntimeError(
            f"checkpoint promote failed: {nxt_path} still present")


def save_checkpoint_swapped(path: str, tree: Dict[str, torch.Tensor],
                            meta: Optional[Dict[str, Any]] = None) -> None:
    """Crash-safe :func:`save_checkpoint`: never deletes the only complete
    checkpoint while the replacement is still being written (see
    :func:`checkpoint_slots`)."""
    nxt_path, old_path = _abspath(path + ".next"), _abspath(path + ".old")
    root = _abspath(path)
    _promote_and_sweep(path)
    save_checkpoint(nxt_path, tree, meta)
    shutil.rmtree(old_path, ignore_errors=True)
    if os.path.isdir(root):
        os.rename(root, old_path)
    os.rename(nxt_path, root)
    # path.old (the previous round) is kept: the fallback when the primary
    # later fails its checksum


def snapshot_to_host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copies on the host of a flat dict of tensors, aliasing nothing the
    next round may overwrite (safe to hand to a background writer)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


class AsyncCheckpointWriter:
    """Background serialize + sha256 + rotate for
    :func:`save_checkpoint_swapped`.  One worker thread drains the
    submissions in order, so slot surgery for save N completes before save
    N+1 touches the directory.  ``wait()`` is the write barrier; a failed
    background save re-raises there (and at the next ``submit``)."""

    def __init__(self, max_pending: int = 1):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Any] = []
        self._max_pending = max(1, int(max_pending))
        self._closed = False

    def _reap(self, block: bool) -> None:
        while self._pending:
            fut = self._pending[0]
            if not (block or fut.done()):
                return
            self._pending.pop(0)
            fut.result()          # re-raise a background failure here

    def submit(self, path: str, tree, meta=None) -> None:
        """Queue one swapped save of an already host-resident ``tree``;
        blocks only while more than ``max_pending`` saves are in flight."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        while len(self._pending) >= self._max_pending:
            self._reap(block=True)
        self._reap(block=False)
        self._pending.append(
            self._pool.submit(save_checkpoint_swapped, path, tree, meta))

    def wait(self) -> None:
        """Block until every queued save is durable (re-raising failures)."""
        self._reap(block=True)

    def close(self) -> None:
        """``wait()`` then shut the worker down; idempotent."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            self._pool.shutdown(wait=True)


def pack_history(history) -> np.ndarray:
    """History records -> a uint8 buffer for the meta."""
    return np.frombuffer(pickle.dumps(history), np.uint8)


def unpack_history(buf) -> Any:
    return pickle.loads(np.asarray(buf, np.uint8).tobytes())
