"""Krum's Gram matrix ``A·Aᵀ`` with a hand-written CUDA kernel.

Port of ``gram_matrix`` of ``federated_pytorch_test_tpu/ops/comm_kernels.py``.
The kernel ``gram`` of ``csrc/gram.cu`` replaces the Pallas TPU kernel
``_gram_kernel`` (launched by ``_gram_pallas``): the ``[K, K]`` Gram matrix
of a ``[K, n]`` float32 client slab, krum's distance pass under
``--robust-chunked`` (``parallel/comm.py``).

Dispatch is by the tensor's device, as in ``ops/infonce.py``: a CPU tensor
takes :func:`gram_plain`, a CUDA tensor launches the kernel or raises.  The
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from federated_pytorch_test_tpu_torch.ops.cuda_build import load_library

#: launches of the kernel in this process (the wrapper adds one per launch)
LAUNCHES = {"gram": 0}

#: contraction slab of the plain version (the Pallas kernel's ``_GRAM_CHUNK``)
SLAB = 512
#: largest client count the kernel takes
MAX_K = 128

#: pass-1 block size and block budget of ``csrc/gram.cu``: two blocks for
#: each of the H100's 132 SMs
THREADS = 256
MAX_BLOCKS = 264


def gram_plain(a: torch.Tensor) -> torch.Tensor:
    """``A·Aᵀ`` as the Pallas kernel computes it: the sum over 512-column
    slabs of ``slab @ slabᵀ`` in float32, in slab order."""
    K, n = a.shape
    g = torch.zeros((K, K), dtype=torch.float32, device=a.device)
    for c in range(0, n, SLAB):
        s = a[:, c: c + SLAB]
        g = g + s @ s.t()
    return g


def plan(K: int, n: int) -> Tuple[int, int]:
    """(chunk, nchunks): the kernel's split of the n columns over blocks.

    K <= 16 is one row tile; above that, tiles of 8 rows and one block per
    pair of tiles, so fewer column chunks.  A pure function of (K, n): the
    summation order, and so the result, repeats from run to run."""
    if K <= 16:
        pairs = 1
    else:
        tiles = -(-K // 8)
        pairs = tiles * (tiles + 1) // 2
    nchunks = max(1, min(-(-n // (4 * THREADS)), MAX_BLOCKS // pairs))
    chunk = -(-n // nchunks)
    chunk = -(-chunk // 128) * 128
    return chunk, -(-n // chunk)


def _lib() -> ctypes.CDLL:
    lib = load_library("gram")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gram.argtypes = [vp, ll, i, ll, ll, i, vp, vp, vp]
        lib.gram.restype = i
        lib._typed = True
    return lib


def gram(a: torch.Tensor) -> torch.Tensor:
    """``A·Aᵀ`` [K, K] of ``a`` [K, n] float32 — the kernel on a CUDA
    tensor, :func:`gram_plain` on a CPU tensor.  The columns must be
    contiguous (``a.stride(1) == 1``); the rows may be strided, so a
    column slab of a wider matrix is read in place."""
    if a.device.type == "cpu":
        return gram_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"gram takes a CUDA or a CPU tensor, got {a.device}")
    if a.dtype != torch.float32 or a.dim() != 2:
        raise TypeError(f"gram takes a 2-D float32 tensor, got {a.dtype} "
                        f"of shape {tuple(a.shape)}")
    K, n = a.shape
    if not (1 <= K <= MAX_K and n >= 1):
        raise ValueError(f"gram takes 1 <= K <= {MAX_K} rows and n >= 1 "
                         f"columns; got K={K}, n={n}")
    if a.stride(1) != 1 or (K > 1 and a.stride(0) < n):
        raise ValueError("gram needs contiguous columns (stride(1) == 1) "
                         f"and non-overlapping rows; got strides {a.stride()}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor lies on {a.device} but the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    chunk, nchunks = plan(K, n)
    lib = _lib()
    g = torch.empty((K, K), dtype=torch.float32, device=a.device)
    work = torch.empty(nchunks * K * K, dtype=torch.float32, device=a.device)
    err = lib.gram(a.data_ptr(), a.stride(0), K, n, chunk, nchunks,
                   work.data_ptr(), g.data_ptr(),
                   torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    LAUNCHES["gram"] += 1
    return g
