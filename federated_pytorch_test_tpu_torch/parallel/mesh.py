"""The client mesh: D logical shards of the K clients, on one process or
spread over the ranks of a ``torch.distributed`` process group.

Port of the client mesh of ``federated_pytorch_test_tpu/parallel/mesh.py``.
The JAX package lays the K clients over a 1-D mesh of D devices (axis
``'clients'``), each device holding a contiguous group of K/D clients, and
runs one program per device under ``shard_map``; its tests run D > 1 on
virtual CPU devices in one process, and a multi-host job spreads the same
mesh over processes.  Here the D shards are logical: the leading client
dimension of every stacked tensor cut into D contiguous groups, and the
collectives are tensor operations in a fixed order:

  * ``psum``: a sum over d = 0..D-1, in that order;
  * the tiled ``all_to_all`` over the coordinate axis: a split of the padded
    ``[K, D*seg]`` stack into D column slabs ``[K, seg]``;
  * the tiled ``all_gather``: a concatenation; the untiled one a stack;
  * ``ppermute``: a permutation of the per-device list.

A program that runs on every device (the packed reduce-scatter of
``ops/packed_reduce.py``) runs once per device index of
:meth:`ClientMesh.indices`, in index order, each step's sends gathered
before its receives are used.

:class:`ClientMesh` holds all D shards in one process.  :class:`RankMesh`
spreads them over the P ranks of the process group that
:func:`initialize_multihost` joins, D/P contiguous shards a rank: each rank
holds only its own ``[K/P, ...]`` rows, runs its own shards' programs, and
the collectives exchange the shards' parts across the ranks.  Every result
is bit for bit the one-process mesh's at the same D: ``psum`` gathers the
D partials and adds them in shard order (never a backend ``all_reduce``,
whose association order is the backend's), and every other collective
moves bytes only.  The backend is NCCL when each rank has a card of its
own; ranks that share a card, or run on the CPU, use gloo, and the mesh
hands gloo host copies of CUDA tensors (the arithmetic stays on the card).

The bounded collectives follow the JAX package: a positive
:func:`barrier_timeout` (``--barrier-timeout``, or the environment's
``FEDTPU_BARRIER_TIMEOUT``) bounds every cross-process barrier and fetch,
and a peer lost to preemption surfaces as :class:`CollectiveTimeoutError`
instead of a hang.  With one process every function here is what the
one-process port has always done.
"""

from __future__ import annotations

import datetime
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class CollectiveTimeoutError(RuntimeError):
    """A multi-process collective or barrier exceeded its bounded wait, or
    its transport failed because a peer process is gone: the signature of
    a peer lost to preemption.  The simulated ``preempt=`` fault family
    (``train/rounds.py``) raises it too.  ``round_index`` (when known) lets
    the restart supervisor attribute the failure to a round."""

    def __init__(self, message: str, round_index: Optional[int] = None):
        super().__init__(message)
        self.round_index = round_index


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

#: the joined group's backend ("gloo" or "nccl"), its gloo group for the
#: bounded barriers (the world group under gloo, a side group beside
#: NCCL), and the bytes this process has sent through the group
_GROUP: Dict[str, Any] = {"backend": None, "barrier": None, "bytes": 0}

_COORD_VARS = ("FEDTPU_COORDINATOR", "FEDTPU_NUM_PROCESSES",
               "FEDTPU_PROCESS_ID")
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _dist():
    import torch.distributed as dist

    return dist


def _group_ready() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes of the job: the process group's world size, 1 without
    one.  A module-level indirection (JAX's ``_process_count``) that tests
    may replace."""
    return _dist().get_world_size() if _group_ready() else 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return _dist().get_rank() if _group_ready() else 0


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else (one host) its rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def _choose_backend(device: Optional[str], world: int) -> str:
    """NCCL when each rank of this host has a card of its own; gloo when
    the ranks share a card or run on the CPU (NCCL refuses two ranks on
    one device)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and torch.cuda.device_count() >= per_host:
        return "nccl"
    return "gloo"


def initialize_multihost(device: Optional[str] = None) -> bool:
    """Join the job's process group when asked; returns True when running
    multi-process afterwards.

    Opt-in through ``FEDTPU_DISTRIBUTED=1``: unset, it returns False and
    touches nothing.  ``FEDTPU_COORDINATOR`` (``host:port``, or a store URL
    such as ``file:///path``), ``FEDTPU_NUM_PROCESSES`` and
    ``FEDTPU_PROCESS_ID`` name the group; set all three or none, a partial
    set raises ``ValueError``.  With none of them, torch's launcher
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    as ``torchrun`` sets them) are read.  ``device`` (the run's device
    name) picks the backend (:func:`_choose_backend`).  A failed init
    raises: a rank never goes on as one process while its peers wait at
    the first collective.  Call it before the first device query."""
    if os.environ.get("FEDTPU_DISTRIBUTED") != "1":
        return False
    dist = _dist()
    if not dist.is_initialized():
        coord, nproc, pid = (os.environ.get(v) for v in _COORD_VARS)
        explicit = (coord, nproc, pid)
        if any(v is not None for v in explicit) \
                and not all(v is not None for v in explicit):
            raise ValueError(
                "FEDTPU_COORDINATOR, FEDTPU_NUM_PROCESSES and "
                "FEDTPU_PROCESS_ID must be set together (got "
                f"coordinator={coord!r}, num_processes={nproc!r}, "
                f"process_id={pid!r})")
        if coord is not None:
            init = coord if "://" in coord else f"tcp://{coord}"
            world, rank = int(nproc), int(pid)
        else:
            missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
            if missing:
                raise ValueError(
                    "FEDTPU_DISTRIBUTED=1 needs FEDTPU_COORDINATOR, "
                    "FEDTPU_NUM_PROCESSES and FEDTPU_PROCESS_ID, or the "
                    f"launcher's {', '.join(_TORCHRUN_VARS)} (missing "
                    f"{', '.join(missing)})")
            init = "env://"
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        backend = _choose_backend(device, world)
        dist.init_process_group(backend, init_method=init,
                                world_size=world, rank=rank)
        _GROUP["backend"] = backend
        _GROUP["barrier"] = (dist.group.WORLD if backend == "gloo"
                             else dist.new_group(backend="gloo"))
    elif _GROUP["backend"] is None:
        # a group the caller made: read its backend
        _GROUP["backend"] = str(dist.get_backend())
        _GROUP["barrier"] = (dist.group.WORLD if _GROUP["backend"] == "gloo"
                             else dist.new_group(backend="gloo"))
    return dist.get_world_size() > 1


def distributed_backend() -> Optional[str]:
    """The process group's backend ("gloo", "nccl"), None without one."""
    return _GROUP["backend"] if _group_ready() else None


def rank_device(name: str) -> str:
    """The device this rank runs on for the run's device ``name``: under
    NCCL a bare ``"cuda"`` is the rank's own card ``cuda:LOCAL_RANK``;
    ranks that share a card keep ``name`` (``cuda`` is card 0); the CPU
    stays the CPU."""
    if name == "cuda" and distributed_backend() == "nccl":
        return f"cuda:{local_rank()}"
    return name


def transport_bytes() -> int:
    """Bytes of tensors this process has sent to its peers through the
    process group (the mesh's collectives, fetches and checkpoint gathers;
    ``gather_objects``' pickled L-BFGS states are not counted)."""
    return int(_GROUP["bytes"])


def _sent(nbytes: int) -> None:
    _GROUP["bytes"] += int(nbytes)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend sends: itself under NCCL or on the CPU, a
    host copy of a CUDA tensor under gloo."""
    t = t.detach()
    if t.is_cuda and _GROUP["backend"] != "nccl":
        t = t.to("cpu")
    return t.contiguous()


# ---------------------------------------------------------------------------
# preemption-tolerant collectives: a peer lost to preemption leaves every
# cross-process barrier and gather hung (or, under gloo, failing on a closed
# connection).  bounded_wait() turns the wedge into a typed error the restart
# supervisor acts on.  Default off: timeout 0 runs the literal call, no
# helper thread.
# ---------------------------------------------------------------------------

def _env_barrier_timeout() -> float:
    try:
        return float(os.environ.get("FEDTPU_BARRIER_TIMEOUT", "0") or 0.0)
    except ValueError:
        return 0.0


#: active bound in seconds; <= 0 disables.  Seeded from the environment so
#: bare scripts can arm it; the engines override it from cfg.barrier_timeout
_BARRIER_TIMEOUT: float = _env_barrier_timeout()

#: (monotonic stamp, site name) of the last collective that completed
_HEARTBEAT: Dict[str, Any] = {"stamp": None, "name": None}

#: the process-lifetime count of bounded waits that expired (or found a
#: peer gone), touched from the main thread and the checkpoint writer
_ELASTIC = {"timeouts": 0}
_ELASTIC_LOCK = threading.Lock()

#: what gloo and the barrier say when a peer process has gone away
_PEER_LOST = re.compile(
    r"connection (closed|reset)|broken pipe|failed to pass monitoredBarrier"
    r"|timed out|socket closed|end of file", re.IGNORECASE)


def configure_barrier_timeout(seconds: float) -> float:
    """Set the global bounded-wait deadline; returns the previous value.
    <= 0 disables (the literal unwrapped call)."""
    global _BARRIER_TIMEOUT
    prev = _BARRIER_TIMEOUT
    _BARRIER_TIMEOUT = float(seconds)
    return prev


def barrier_timeout() -> float:
    return _BARRIER_TIMEOUT


def collective_timeout_count() -> int:
    return _ELASTIC["timeouts"]


def heartbeat(name: str) -> None:
    """Record that collective site ``name`` just completed."""
    _HEARTBEAT["stamp"] = time.monotonic()
    _HEARTBEAT["name"] = name


def last_heartbeat_age() -> Optional[float]:
    """Seconds since any collective last completed (None: none yet)."""
    stamp = _HEARTBEAT["stamp"]
    return None if stamp is None else time.monotonic() - stamp


def _timeout_error(name: str, t: float, what: str) -> CollectiveTimeoutError:
    """Count one expired wait and build its typed error."""
    with _ELASTIC_LOCK:
        _ELASTIC["timeouts"] += 1
    age = last_heartbeat_age()
    last = ("no collective had completed yet" if age is None else
            f"last completed collective was {_HEARTBEAT['name']!r} "
            f"{age:.1f}s ago")
    return CollectiveTimeoutError(
        f"collective {name!r} {what} (bound {t:.1f}s; process "
        f"{process_index()}/{process_count()}; {last}) — peer lost to "
        "preemption?")


def bounded_wait(fn: Callable, *, name: str,
                 timeout: Optional[float] = None):
    """Run blocking collective ``fn()`` with a deadline.

    With the effective timeout <= 0 (the default) this IS ``fn()``: no
    thread, no wrapping.  Otherwise ``fn`` runs on a daemon thread and a
    ``join(timeout)`` bounds the wait: on expiry a
    :class:`CollectiveTimeoutError` names the site, the bound and the age
    of the last heartbeat.  The stuck thread is abandoned (the process is
    about to unwind to the restart supervisor).  An error ``fn`` raises is
    re-raised."""
    t = _BARRIER_TIMEOUT if timeout is None else float(timeout)
    if t <= 0:
        out = fn()
        heartbeat(name)
        return out
    box: dict = {}

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:          # surface peer-side failures too
            box["error"] = e

    th = threading.Thread(target=runner, name=f"bounded-{name}", daemon=True)
    th.start()
    th.join(t)
    if th.is_alive():
        raise _timeout_error(name, t, f"did not complete within {t:.1f}s")
    if "error" in box:
        raise box["error"]
    heartbeat(name)
    return box.get("value")


def _collective(name: str, fn: Callable):
    """A cross-process transport call: under the bounded wait, and with a
    transport failure caused by a peer that has gone away turned into
    :class:`CollectiveTimeoutError` (gloo fails on the closed connection
    where JAX's collectives hang)."""
    try:
        return bounded_wait(fn, name=name)
    except CollectiveTimeoutError:
        raise
    except RuntimeError as e:
        if not _PEER_LOST.search(str(e)):
            raise
        first = str(e).strip().splitlines()[0][:300]
        raise _timeout_error(name, _BARRIER_TIMEOUT,
                             f"failed: {first}") from e


def sync_global(tag: str, timeout: Optional[float] = None) -> None:
    """Cross-process barrier with the bounded wait applied: the shared
    entry point of every host-side barrier (checkpoint slot surgery, round
    fences).  A no-op with one process.

    With a positive bound the barrier is gloo's ``monitored_barrier`` on
    the gloo group (the world group, or the side group beside NCCL) with
    that bound: a missing peer surfaces as :class:`CollectiveTimeoutError`
    naming the site, and is counted.  A bound <= 0 runs the plain
    ``barrier``."""
    if process_count() == 1:
        return
    dist = _dist()
    t = _BARRIER_TIMEOUT if timeout is None else float(timeout)
    name = f"sync:{tag}"
    group = _GROUP["barrier"]
    if t > 0:
        try:
            dist.monitored_barrier(group=group,
                                   timeout=datetime.timedelta(seconds=t),
                                   wait_all_ranks=True)
        except RuntimeError as e:
            first = str(e).strip().splitlines()[0][:300]
            raise _timeout_error(name, t, f"failed: {first}") from e
        heartbeat(name)
        return
    _collective(name, lambda: dist.barrier(group=group))


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

class ClientMesh:
    """D logical shards of a K-client stack, all in this process."""

    #: processes the shards are spread over, and this process's rank
    processes = 1
    rank = 0

    def __init__(self, D: int = 1):
        if D < 1:
            raise ValueError(f"num_devices={D} must be >= 1")
        self.size = int(D)

    def rows(self, K: int) -> range:
        """The client rows this process holds: all K."""
        if K % self.size:
            raise ValueError(f"K={K} not divisible by device count {self.size}")
        return range(K)

    def shards(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """The D contiguous client groups of ``stack`` [K, ...] (views)."""
        K = stack.shape[0]
        if K % self.size:
            raise ValueError(f"K={K} not divisible by device count {self.size}")
        return list(stack.split(K // self.size))

    def per_shard(self, fn: Callable, *stacks: torch.Tensor) -> torch.Tensor:
        """``fn`` over each shard's rows of ``stacks``, concatenated: a
        per-client reduction computed as each device of the JAX mesh
        computes it, on its own ``[K/D, ...]`` rows, so that its numbers
        do not depend on how many shards a process holds."""
        return torch.cat([fn(*parts) for parts in
                          zip(*(self.shards(s) for s in stacks))])

    @staticmethod
    def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the per-shard values, in shard order."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def federated_sum(self, stack: torch.Tensor) -> torch.Tensor:
        """Sum over all clients: each shard's local sum, then ``psum``."""
        return self.psum([s.sum(dim=0) for s in self.shards(stack)])

    def all_to_all(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """The tiled ``all_to_all`` over the coordinate axis: the [K, n]
        stack padded with zero columns to [K, D*seg], seg = ceil(n / D), cut
        into D column slabs [K, seg]; slab d is what device d receives."""
        n = stack.shape[1]
        seg = -(-n // self.size)
        if self.size * seg != n:
            stack = torch.nn.functional.pad(stack, (0, self.size * seg - n))
        return list(stack.split(seg, dim=1))

    @staticmethod
    def all_gather(parts: Sequence[torch.Tensor],
                   tiled: bool = True) -> torch.Tensor:
        """``all_gather`` of the devices' pieces: concatenated (tiled) or
        stacked on a new leading device dimension."""
        return torch.cat(list(parts)) if tiled else torch.stack(list(parts))

    def reduce_scatter(self, bufs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The tiled ``psum_scatter`` of the devices' ``[D*seg]`` buffers
        (``bufs`` in :meth:`indices` order): device d gets segment d of
        the sum over all D buffers, added in shard order."""
        slabs = self.all_to_all(torch.stack(list(bufs)))
        return [ClientMesh.psum(list(s.unbind(0))) for s in slabs]

    def indices(self) -> range:
        """Each logical device's own index (``lax.axis_index``), in the
        order the per-device programs run.  Per-device lists (``parts`` of
        the collectives) follow this order."""
        return range(self.size)

    def _check_perm(self, perm: Sequence[Tuple[int, int]]) -> None:
        full = list(range(self.size))
        if sorted(d for _, d in perm) != full or \
                sorted(s for s, _ in perm) != full:
            raise ValueError(f"ppermute takes a permutation of the "
                             f"{self.size} devices; got {list(perm)}")

    def ppermute(self, parts: Sequence[Any],
                 perm: Sequence[Tuple[int, int]]) -> List[Any]:
        """``lax.ppermute``: device ``dst`` receives ``parts[src]`` for every
        ``(src, dst)`` of ``perm``, which must be a permutation of the D
        devices (the only kind the packed collectives use).  Returns a
        list indexed by global device index."""
        self._check_perm(perm)
        out: List[Any] = [None] * self.size
        for src, dst in perm:
            out[dst] = parts[src]
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The full ``[K, ...]`` stack of this process's client rows
        ``t``: ``t`` itself with one process."""
        return t

    def gather_objects(self, items: List[Any]) -> List[Any]:
        """The per-client Python objects of every process, in client
        order: ``items`` itself with one process."""
        return items


class RankMesh(ClientMesh):
    """D logical shards spread over the P ranks of the process group, D/P
    contiguous shards a rank: rank p holds shards ``p*D/P .. (p+1)*D/P-1``
    and their ``K/P`` client rows.  Same methods as :class:`ClientMesh`,
    each taking this rank's parts (in :meth:`indices` order) and
    exchanging them across the ranks; every result is bit for bit the
    one-process mesh's at the same D."""

    def __init__(self, D: int, group=None):
        super().__init__(D)
        dist = _dist()
        self.group = group
        self.processes = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.size % self.processes:
            raise ValueError(
                f"num_devices={self.size} must be a multiple of the "
                f"{self.processes} processes: each process holds D/P "
                "whole shards")
        self.local = self.size // self.processes

    # -- layout ----------------------------------------------------------
    def rows(self, K: int) -> range:
        super().rows(K)
        n = K // self.processes
        return range(self.rank * n, (self.rank + 1) * n)

    def indices(self) -> range:
        return range(self.rank * self.local, (self.rank + 1) * self.local)

    def owner(self, d: int) -> int:
        """The rank holding logical device ``d``."""
        return d // self.local

    def shards(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """This rank's D/P client groups of its ``[K/P, ...]`` rows."""
        n = stack.shape[0]
        if n % self.local:
            raise ValueError(f"{n} local rows not divisible by the "
                             f"{self.local} shards of this process")
        return list(stack.split(n // self.local))

    # -- transport ---------------------------------------------------------
    def _gather_ranks(self, t: torch.Tensor, name: str) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on each), in rank order,
        on ``t``'s device."""
        dist = _dist()
        src = _wire(t)
        out = [torch.empty_like(src) for _ in range(self.processes)]
        _collective(name, lambda: dist.all_gather(out, src, group=self.group))
        _sent(src.numel() * src.element_size() * (self.processes - 1))
        out[self.rank] = t
        return [o.to(t.device) for o in out]

    def _gather_parts(self, parts: Sequence[torch.Tensor],
                      name: str) -> List[torch.Tensor]:
        """The D devices' parts in device order, from each rank's own."""
        if len(parts) != self.local:
            raise ValueError(f"expected {self.local} parts (this process's "
                             f"shards), got {len(parts)}")
        got = self._gather_ranks(torch.stack(list(parts)), name)
        return [p for g in got for p in g.unbind(0)]

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the D devices' parts, in shard order: the partials are
        gathered, then added one after another, as with one process."""
        return ClientMesh.psum(self._gather_parts(parts, "mesh:psum"))

    def all_gather(self, parts: Sequence[torch.Tensor],
                   tiled: bool = True) -> torch.Tensor:
        return ClientMesh.all_gather(self._gather_parts(parts,
                                                        "mesh:all_gather"),
                                     tiled)

    def all_to_all(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """This rank's slabs of the tiled ``all_to_all``: for each own
        device d, column slab d of the full padded ``[K, D*seg]`` stack.
        Each rank sends every other rank its rows of that rank's slabs."""
        dist = _dist()
        n_loc, n = stack.shape
        seg = -(-n // self.size)
        if self.size * seg != n:
            stack = torch.nn.functional.pad(stack, (0, self.size * seg - n))
        P, w = self.processes, self.local * seg
        send = stack.reshape(n_loc, P, w).permute(1, 0, 2).contiguous()
        src = _wire(send)
        recv = torch.empty_like(src)
        _collective("mesh:all_to_all",
                    lambda: dist.all_to_all_single(recv, src,
                                                   group=self.group))
        _sent(src.numel() * src.element_size() * (P - 1) // P)
        full = recv.to(stack.device).reshape(P * n_loc, w)
        return list(full.split(seg, dim=1))

    def ppermute(self, parts: Sequence[Any],
                 perm: Sequence[Tuple[int, int]]) -> List[Any]:
        """``lax.ppermute`` over the ranks: a pair on this rank is a plain
        hand-over, a pair across ranks an ``isend``/``irecv`` of each
        tensor of the part.  ``parts`` follow :meth:`indices`; every part
        has the structure and shapes of this rank's first (the packed
        collectives send equal segments).  Returns a list indexed by
        global device index, filled at this rank's devices."""
        dist = _dist()
        self._check_perm(perm)
        own = {d: i for i, d in enumerate(self.indices())}
        out: List[Any] = [None] * self.size
        template = parts[0]
        single = isinstance(template, torch.Tensor)
        tmpl = [template] if single else list(template)
        device = tmpl[0].device
        works, recvs = [], []
        for src, dst in perm:
            if src in own and dst in own:
                out[dst] = parts[own[src]]
            elif src in own:
                piece = parts[own[src]]
                for i, t in enumerate([piece] if single else piece):
                    w = _wire(t)
                    works.append(dist.isend(
                        w, self.owner(dst), group=self.group,
                        tag=(src * self.size + dst) * 8 + i))
                    _sent(w.numel() * w.element_size())
            elif dst in own:
                bufs = [torch.empty_like(_wire(t)) for t in tmpl]
                for i, b in enumerate(bufs):
                    works.append(dist.irecv(
                        b, self.owner(src), group=self.group,
                        tag=(src * self.size + dst) * 8 + i))
                recvs.append((dst, bufs))

        def wait():
            for w in works:
                w.wait()

        _collective("mesh:ppermute", wait)
        for dst, bufs in recvs:
            got = [b.to(device) for b in bufs]
            out[dst] = got[0] if single else tuple(got)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The full ``[K, ...]`` stack from each rank's ``[K/P, ...]``
        rows (``fetch``'s all-gather, under the bounded wait)."""
        return torch.cat(self._gather_ranks(t, "fetch:allgather"))

    def gather_objects(self, items: List[Any]) -> List[Any]:
        """Every rank's per-client objects (tensors moved through the
        host), concatenated in client order."""
        dist = _dist()
        device = next((t.device for t in _tensors(items)), None)
        host = _map_tensors(lambda t: t.detach().to("cpu"), items)
        out: List[Any] = [None] * self.processes
        _collective("fetch:allgather_objects",
                    lambda: dist.all_gather_object(out, host,
                                                   group=self.group))
        full = [x for part in out for x in part]
        if device is None:
            return full
        return _map_tensors(lambda t: t.to(device), full)


def _map_tensors(fn: Callable, tree):
    """``fn`` over the tensors of a tree of dicts, lists, tuples and
    NamedTuples (other leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def client_mesh(D: int) -> ClientMesh:
    """The client mesh of D shards for this job: one process holds them
    all, a process group spreads them over its ranks."""
    return ClientMesh(D) if process_count() == 1 else RankMesh(D)


def usable_device_count(K: int, n_devices: Optional[int] = None) -> int:
    """Largest D <= n_devices with K % D == 0 (``usable_device_count`` of
    the JAX package).  Without ``n_devices`` the mesh has one shard a
    process, as JAX's has one device a process."""
    n = process_count() if n_devices is None else n_devices
    d = max(1, min(n, K))
    while K % d:
        d -= 1
    return d


# ---------------------------------------------------------------------------
# per-process staging and fetch: every rank holds the same full host arrays
# (the pipelines are seeded) and stages only its own client rows
# ---------------------------------------------------------------------------

def local_client_rows(mesh: ClientMesh, K: int) -> List[int]:
    """The sorted client rows whose shards live in THIS process: all K
    with one process."""
    return list(mesh.rows(K))


def stage_global(x, device, mesh: Optional[ClientMesh] = None
                 ) -> torch.Tensor:
    """Host array -> tensor on ``device``.  ``mesh`` None: the whole array
    (replicated).  With a mesh the leading axis is the client axis, and
    only this process's rows are staged (every process holds the same
    full array)."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if mesh is not None and mesh.processes > 1:
        r = mesh.rows(t.shape[0])
        t = t[r.start:r.stop]
    return t.to(device)


def stage_tree_global(tree, device, mesh: Optional[ClientMesh] = None):
    """:func:`stage_global` over every tensor leaf of ``tree``."""
    return _map_tensors(lambda v: stage_global(v, device, mesh), tree)


def stage_client_rows(x_local, device) -> torch.Tensor:
    """A host array holding ONLY this process's client rows (in
    :func:`local_client_rows` order) -> tensor on ``device``."""
    return torch.as_tensor(np.asarray(x_local)).to(device)


def fetch(x: torch.Tensor, mesh: Optional[ClientMesh] = None) -> np.ndarray:
    """Tensor -> host numpy, the same on every process.  With a
    multi-process ``mesh`` ``x`` is this rank's client rows, all-gathered
    first (under the bounded wait) to the full ``[K, ...]``."""
    if mesh is not None and mesh.processes > 1:
        x = mesh.gather_rows(x)
    return x.detach().cpu().numpy()
