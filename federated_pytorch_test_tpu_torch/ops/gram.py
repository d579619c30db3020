"""Krum's Gram matrix ``A·Aᵀ`` with a hand-written CUDA kernel.

Port of ``gram_matrix`` of ``federated_pytorch_test_tpu/ops/comm_kernels.py``.
The kernel ``gram`` of ``csrc/gram.cu`` replaces the Pallas TPU kernel
``_gram_kernel`` (launched by ``_gram_pallas``): the ``[K, K]`` Gram matrix
of a ``[K, n]`` float32 client slab, krum's distance pass under
``--robust-chunked`` (``parallel/comm.py``).

The kernel is one launch per call: persistent blocks stream contiguous
column chunks (:func:`plan`) through a ring of shared-memory stages, and
the last block to finish sums the chunks' partials in chunk order.  The
wrapper keeps that sum's workspace per (device, stream); its only
allocation per call is G.

Dispatch is by the tensor's device, as in ``ops/infonce.py``: a CPU tensor
takes :func:`gram_plain`, a CUDA tensor launches the kernel or raises.  The
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from federated_pytorch_test_tpu_torch.ops import cuda_build

#: launches of the kernel in this process (the wrapper adds one per launch)
LAUNCHES = {"gram": 0}

#: contraction slab of the plain version (the Pallas kernel's ``_GRAM_CHUNK``)
SLAB = 512
#: largest client count the kernel takes
MAX_K = 128

#: block size, columns of one pipeline stage (a float4 a thread) and block
#: budget of ``csrc/gram.cu``: one persistent block on each of the H100's
#: 132 SMs
THREADS = 256
STAGE_COLS = 4 * THREADS
MAX_BLOCKS = 132


def gram_plain(a: torch.Tensor) -> torch.Tensor:
    """``A·Aᵀ`` as the Pallas kernel computes it: the sum over 512-column
    slabs of ``slab @ slabᵀ`` in float32, in slab order."""
    K, n = a.shape
    g = torch.zeros((K, K), dtype=torch.float32, device=a.device)
    for c in range(0, n, SLAB):
        s = a[:, c: c + SLAB]
        g = g + s @ s.t()
    return g


def _pairs(K: int) -> int:
    """Row-tile pairs a column chunk is cut into: 1 for K <= 16 (one tile of
    K rows), else the pairs ti <= tj of ceil(K/8) tiles of 8 rows."""
    if K <= 16:
        return 1
    tiles = -(-K // 8)
    return tiles * (tiles + 1) // 2


@functools.lru_cache(maxsize=None)
def plan(K: int, n: int) -> Tuple[int, int]:
    """(chunk, nchunks): the kernel's split of the n columns into contiguous
    chunks, one block per chunk and tile pair, at most :data:`MAX_BLOCKS`
    blocks (one pair set of chunks when the pairs alone exceed it).  A chunk
    is a whole number of :data:`STAGE_COLS`-column stages.  A pure function
    of (K, n): the summation order, and so the result, repeats from run to
    run."""
    stages = -(-n // STAGE_COLS)
    nchunks = max(1, min(stages, MAX_BLOCKS // _pairs(K)))
    chunk = -(-stages // nchunks) * STAGE_COLS
    return chunk, -(-n // chunk)


#: floats of the cross-block workspace: the most that any plan needs,
#: nchunks * K * K over every K the kernel takes
WORK_FLOATS = max(max(1, MAX_BLOCKS // _pairs(K)) * K * K
                  for K in range(1, MAX_K + 1))


def vector_path(addr: int, lda: int, n: int) -> bool:
    """Whether the kernel streams ``A`` with 16-byte copies: every row must
    start 16-byte aligned (the base address ``addr`` and the row stride
    ``lda``, in floats), and a row must hold one 16-byte vector.  Otherwise
    4-byte copies into the same layout, with the same arithmetic."""
    return addr % 16 == 0 and lda % 4 == 0 and n >= 4


#: the launch path: (C function, raw stream of a device index, current
#: device), bound at the first launch (``cuda_build``'s lean path)
_gram_c = None
#: per (device index, raw stream): the data pointers of the cross-block
#: workspace and of its counter (zeroed once; the kernel leaves it 0), then
#: the two tensors
_WORKSPACE: Dict[Tuple[int, int], tuple] = {}
_F32 = torch.float32


def _bind():
    global _gram_c
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    _gram_c = (cuda_build.bind("gram", "gram",
                               [vp, ll, i, ll, ll, i, i, vp, vp, vp, vp]),
               *cuda_build.cuda_runtime())
    return _gram_c


def _workspace(idx: int, stream: int) -> tuple:
    """The data pointers of the cross-block workspace and its zeroed
    counter for (device, stream), allocated at the stream's first call and
    kept (with the tensors) for the process."""
    dev = torch.device("cuda", idx)
    work = torch.empty(WORK_FLOATS, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    ws = _WORKSPACE[(idx, stream)] = (work.data_ptr(), counter.data_ptr(),
                                      work, counter)
    return ws


def gram(a: torch.Tensor) -> torch.Tensor:
    """``A·Aᵀ`` [K, K] of ``a`` [K, n] float32 — the kernel on a CUDA
    tensor, :func:`gram_plain` on a CPU tensor.  The columns must be
    contiguous (``a.stride(1) == 1``); the rows may be strided, so a
    column slab of a wider matrix is read in place."""
    if not a.is_cuda:
        if a.is_cpu:
            return gram_plain(a)
        raise ValueError(f"gram takes a CUDA or a CPU tensor, got {a.device}")
    fn, raw_stream, current_device = _gram_c or _bind()
    shape = a.shape
    if a.dtype != _F32 or len(shape) != 2:
        raise TypeError(f"gram takes a 2-D float32 tensor, got {a.dtype} "
                        f"of shape {tuple(shape)}")
    K, n = shape
    if not (1 <= K <= MAX_K and n >= 1):
        raise ValueError(f"gram takes 1 <= K <= {MAX_K} rows and n >= 1 "
                         f"columns; got K={K}, n={n}")
    lda, step = a.stride()
    if step != 1 or (K > 1 and lda < n):
        raise ValueError("gram needs contiguous columns (stride(1) == 1) "
                         f"and non-overlapping rows; got strides {a.stride()}")
    idx = a.get_device()
    if idx != current_device():
        raise ValueError(f"tensor lies on {a.device} but the current CUDA "
                         f"device is cuda:{current_device()}")
    chunk, nchunks = plan(K, n)
    stream = raw_stream(idx)
    ws = _WORKSPACE.get((idx, stream)) or _workspace(idx, stream)
    ptr = a.data_ptr()
    g = a.new_empty((K, K))
    # one row: its stride does not matter to the alignment
    err = fn(ptr, lda, K, n, chunk, nchunks,
             vector_path(ptr, lda if K > 1 else 0, n), ws[0], ws[1],
             g.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    LAUNCHES["gram"] += 1
    return g
