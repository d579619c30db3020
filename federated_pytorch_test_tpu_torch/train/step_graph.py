"""The local epoch's Adam client-steps replayed from CUDA graphs.

An eager client-step of ``train/engine.py`` (the input's normalisation,
the forward, the algorithm's penalty, ``torch.autograd.grad``, Adam and
the new BatchNorm statistics) launches about a thousand kernels from
Python, and on a card the host's dispatch of them paces the round.
:class:`ClientStepGraphs` holds one CUDA graph a client row, each one
whole client-step, captured once after an eager epoch has warmed cuDNN,
autograd and the allocator, and replayed ``steps`` times for each client
that trains.  A graph replays the eager step's kernels in the eager order:
the arithmetic is the eager step's.

A replay reads and writes only fixed addresses:

* the slots (:class:`Slots`), one client wide and shared by the graphs:
  the step's images, labels, pad weights and normalisation, the block
  vector, Adam's moments and step count, the client's dual row, ``z``,
  ``rho`` and the step's loss.  The engine copies a step's rows in before
  each replay, a client's rows in before its first and out after its
  last, ``z`` and ``rho`` once an epoch;
* the BatchNorm statistics of every client, ``[rows, C]`` buffers whose
  row ``j`` graph ``j`` reads and writes, copied in and out once an epoch;
* the frozen leaves, read in place from the rows of the state's
  parameters: their addresses are part of the graphs' key, so a new
  parameter tree (a block switch, a restore, a reshape) captures anew;
* Adam's bias corrections by step count, a table built by the eager
  formula (:meth:`ClientStepGraphs.reserve`), which a graph indexes with
  the count it advances on the card, so no step count crosses from the
  host.

The graphs share one memory pool: they replay in order on one stream.
Nothing the engine hands out of an epoch aliases a slot or a buffer that a
later replay writes.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Slots:
    """The fixed inputs and outputs of a client-step graph."""

    images: torch.Tensor    # [B, H, W, C] uint8: the step's images
    labels: torch.Tensor    # [B]
    weights: torch.Tensor   # [B]: the pad weights
    norm: torch.Tensor      # [2, C]: the client's (mean, std)
    x: torch.Tensor         # [N]: the block vector
    mu: torch.Tensor        # [N]: Adam's first moment
    nu: torch.Tensor        # [N]: Adam's second moment
    count: torch.Tensor     # []: Adam's step count (int64)
    y: torch.Tensor         # the client's dual row
    z: torch.Tensor         # [N]: the consensus
    rho: torch.Tensor       # []
    loss: torch.Tensor      # []: the step's loss

    @classmethod
    def like(cls, x, y, rho, norm, xb, yb, wb) -> "Slots":
        """Slots shaped for the block vectors ``x`` [rows, N], the duals
        ``y`` [rows, M], the normalisation ``norm`` [rows, 2, C] and one
        step of the epoch's ``xb``, ``yb``, ``wb`` [rows, steps, B, ...]."""
        z = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        return cls(images=z(xb[0, 0]), labels=z(yb[0, 0]),
                   weights=z(wb[0, 0]), norm=z(norm[0]), x=z(x[0]),
                   mu=z(x[0]), nu=z(x[0]),
                   count=torch.zeros((), dtype=torch.int64, device=x.device),
                   y=z(y[0]), z=z(x[0]), rho=z(rho),
                   loss=torch.zeros((), dtype=torch.float32,
                                    device=x.device))


class ClientStepGraphs:
    """One captured client-step graph a client row, with its slots, the
    statistics buffers and the bias-correction table; ``key`` says what
    the graphs were captured for (None: nothing captured)."""

    #: the bias-correction table's first size, in step counts; a block
    #: whose counts outgrow it doubles it, and its graphs are captured anew
    TABLE0 = 1 << 14

    def __init__(self, device, bias_corrections: Callable):
        self.device = torch.device(device)
        #: ``(count, device) -> (bc1, bc2)``: the eager step's formula
        self._bias = bias_corrections
        self.key = None
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.slots: Optional[Slots] = None
        self.stats = None
        self.table: Optional[torch.Tensor] = None
        self.filled = 0

    def release(self) -> None:
        """Drop the graphs, their pool, the slots and the buffers."""
        self.key = None
        self.graphs, self.slots, self.stats = [], None, None

    def ready(self, key) -> bool:
        """Whether graphs captured for ``key`` are held."""
        return self.key is not None and self.key == key

    def reserve(self, top: int) -> None:
        """Make the table hold the bias corrections of every step count up
        to ``top``, each computed by the eager formula on the card; a
        table that has to grow is replaced, which drops the graphs that
        index the old one."""
        cap = 0 if self.table is None else self.table.shape[1]
        if top >= cap:
            table = torch.empty((2, max(self.TABLE0, 2 * cap, top + 1)),
                                dtype=torch.float32, device=self.device)
            if self.filled:
                table[:, :self.filled].copy_(self.table[:, :self.filled])
            self.table = table
            self.release()
        if top >= self.filled:
            b1, b2 = zip(*(self._bias(c, self.device)
                           for c in range(self.filled, top + 1)))
            self.table[:, self.filled:top + 1].copy_(
                torch.stack([torch.stack(b1), torch.stack(b2)]))
            self.filled = top + 1

    def bias(self, count: torch.Tensor):
        """The bias corrections at the device step count ``count`` (a
        gather from the table, inside a graph)."""
        bc = self.table.index_select(1, count.view(1))
        return bc[0, 0], bc[1, 0]

    def capture(self, key, rows: int, slots: Slots, stats,
                step: Callable[[int], None]) -> int:
        """Capture ``step(j)``, one client-step of row ``j`` over
        ``slots`` and ``stats``, for every row, on a side stream into one
        shared pool; returns the number of graphs captured.  Capture
        launches nothing on the card, but it waits for the card once
        first: as ``torch.cuda.graph`` does, it frees the allocator's
        cached blocks and the pools of graphs released before, which an
        allocation that fails during a capture cannot do."""
        self.release()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        _clear_cublas_workspaces()
        with torch.cuda.stream(stream):
            for j in range(rows):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                try:
                    step(j)
                finally:
                    g.capture_end()
                graphs.append(g)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        _clear_cublas_workspaces()
        self.graphs, self.slots, self.stats, self.key = (graphs, slots,
                                                          stats, key)
        return rows


def _clear_cublas_workspaces() -> None:
    """Give back the cuBLAS workspaces PyTorch holds, one a (thread's
    handle, stream) pair, each taken anew at the pair's next cuBLAS call.

    Around a capture: the capture stream's pairs take theirs from the
    graphs' pool, whose memory only the graphs use, and the graphs keep
    using them after they are given back; the eager streams' are given
    back first, so that no more workspaces are held during the capture
    than during an eager step, and taken again at their next use."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
