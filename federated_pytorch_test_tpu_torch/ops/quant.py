"""The fused collective's transport codec with hand-written CUDA kernels.

Port of ``quantize_chunks`` and ``dequant_add`` of
``federated_pytorch_test_tpu/ops/comm_kernels.py``.  Two kernels from
``csrc/quant.cu`` replace the two Pallas TPU kernels:

  * :func:`quantize_chunks` — per-row ``scale = max|row| / qmax`` and the
    round-half-even int8 ``q = clip(round(row / safe), ±qmax)`` of a
    ``[c, chunk]`` float32 row matrix (replaces ``_quantize_kernel``);
  * :func:`dequant_add` — ``acc + q * safe(scale)`` row by row, the
    reduce-scatter hop's accumulate (replaces ``_dequant_add_kernel``),
    into a new tensor or into ``out``, which may be ``acc`` itself (the hop
    accumulates in place).

Dispatch is by the tensors' device, as in ``ops/infonce.py``: CPU tensors
take the plain versions (:func:`quantize_plain`, :func:`dequant_add_plain`),
CUDA tensors launch the kernel or raise.  Each wrapper counts its launches
in :data:`LAUNCHES` and passes each launch's float output to the
sanitizer (``analysis/sanitize.py`` ``report``).

Both sides are pinned to one arithmetic: IEEE division by a tensor on the
tensors' own device (a CUDA tensor divided by a Python number is computed
as a product with the reciprocal), and a separate multiply and add in the
accumulate (no fused multiply-add), so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from federated_pytorch_test_tpu_torch.analysis import sanitize
from federated_pytorch_test_tpu_torch.ops import cuda_build

#: launches of each kernel in this process (the wrappers add one per launch)
LAUNCHES = {"quantize_chunks": 0, "dequant_add": 0}


def _safe(scale: torch.Tensor) -> torch.Tensor:
    """``where(scale > 0, scale, 1)``: an all-zero row divides by 1."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_plain(v: torch.Tensor, qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q [c, chunk] int8, scale [c] float32)`` of ``v [c, chunk]`` — the
    JAX package's ``_quantize_xla``, with both divisions IEEE on any
    device."""
    qm = torch.full((), float(qmax), dtype=v.dtype, device=v.device)
    scale = v.abs().amax(dim=1) / qm
    q = torch.clamp(torch.round(v / _safe(scale)[:, None]), -qmax, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def _check_out(out: torch.Tensor, acc: torch.Tensor) -> None:
    """``out`` must be a contiguous float32 tensor of ``acc``'s shape on its
    device; it may be ``acc`` itself, but not overlap it otherwise."""
    if out.dtype != torch.float32:
        raise TypeError(f"out: expected torch.float32, got {out.dtype}")
    if out.shape != acc.shape or out.device != acc.device:
        raise ValueError(f"out: expected shape {tuple(acc.shape)} on "
                         f"{acc.device}, got {tuple(out.shape)} on {out.device}")
    if not out.is_contiguous():
        raise ValueError("out: expected a contiguous tensor")
    o, a, nb = out.data_ptr(), acc.data_ptr(), acc.numel() * 4
    if o != a and a - nb < o < a + nb:
        raise ValueError("out overlaps acc without being acc itself")


def dequant_add_plain(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + q * safe(scale)[:, None]`` — the JAX package's
    ``_dequant_add_xla``: a multiply and an add, each rounded.  With ``out``
    the sum is written there (``out`` may be ``acc``: in place)."""
    prod = q.to(torch.float32) * _safe(scale)[:, None]
    if out is None:
        return acc + prod
    _check_out(out, acc)
    return torch.add(acc, prod, out=out)


def _on_card(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors on the
    current device; raises otherwise."""
    if x.device.type == "cpu" and all(t.device.type == "cpu" for t in others):
        return False
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError("the quantize kernels take tensors that all lie on "
                         f"one CUDA device (or all on the CPU); got {x.device} "
                         f"and {[str(t.device) for t in others]}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {x.device} but the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    return True


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("quant")
    if not getattr(lib, "_typed", False):
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.quantize_rows.argtypes = [vp, ll, i, f, vp, vp, vp]
        lib.quantize_rows.restype = i
        lib._typed = True
    return lib


def quantize_chunks(v: torch.Tensor, qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of the ``[c, chunk]`` float32 row matrix ``v`` — the
    kernel on a CUDA tensor, :func:`quantize_plain` on a CPU tensor."""
    if not _on_card(v):
        return quantize_plain(v, qmax)
    if v.dim() != 2:
        raise ValueError(f"v: expected [c, chunk], got shape {tuple(v.shape)}")
    c, w = v.shape
    _check("v", v, torch.float32, (c, w))
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax={qmax} must be in [1, 127] (int8 payload)")
    q = torch.empty((c, w), dtype=torch.int8, device=v.device)
    scale = torch.empty(c, dtype=torch.float32, device=v.device)
    if c == 0 or w == 0:
        return q, scale.zero_()
    err = _lib().quantize_rows(v.data_ptr(), c, w, float(qmax), q.data_ptr(),
                               scale.data_ptr(),
                               torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA error {err}")
    LAUNCHES["quantize_chunks"] += 1
    sanitize.report("quantize_rows", scale)
    return q, scale


_F32, _I8 = torch.float32, torch.int8

#: B2's launch path: (C function, raw stream of a device index, current
#: device), bound at the first launch (``cuda_build``'s lean path)
_dequant_c = None


def _bind_dequant():
    global _dequant_c
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    _dequant_c = (cuda_build.bind("quant", "dequant_add",
                                  [vp, vp, vp, ll, i, vp, vp]),
                  *cuda_build.cuda_runtime())
    return _dequant_c


def dequant_add(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + q * safe(scale)`` for ``[c, chunk]`` rows — the kernel on CUDA
    tensors, :func:`dequant_add_plain` on CPU tensors.  ``q`` is int8 rows
    (q4 payloads are nibble-unfolded by the caller).  The result goes to a
    new tensor, or to ``out`` when given; ``out=acc`` accumulates in place."""
    if not acc.is_cuda:
        if acc.is_cpu and q.is_cpu and scale.is_cpu:
            return dequant_add_plain(acc, q, scale, out)
        raise ValueError("the quantize kernels take tensors that all lie on "
                         f"one CUDA device (or all on the CPU); got {acc.device}, "
                         f"{q.device} and {scale.device}")
    fn, raw_stream, current_device = _dequant_c or _bind_dequant()
    idx = acc.get_device()
    if (idx != current_device() or q.get_device() != idx
            or scale.get_device() != idx):
        raise ValueError("the quantize kernels take tensors that all lie on "
                         f"the current CUDA device; got {acc.device}, "
                         f"{q.device} and {scale.device}, current "
                         f"cuda:{current_device()}")
    if acc.dtype != _F32 or q.dtype != _I8 or scale.dtype != _F32:
        raise TypeError(f"dequant_add takes float32 acc, int8 q and float32 "
                        f"scale; got {acc.dtype}, {q.dtype}, {scale.dtype}")
    shape = acc.shape
    if len(shape) != 2 or q.shape != shape or scale.shape != shape[:1]:
        raise ValueError(f"dequant_add takes acc and q [c, chunk] and scale "
                         f"[c]; got {tuple(shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}")
    if not (acc.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("dequant_add takes contiguous tensors")
    if out is None:
        out = torch.empty_like(acc)
    elif out is not acc:
        _check_out(out, acc)
    c, w = shape
    if c and w:
        err = fn(acc.data_ptr(), q.data_ptr(), scale.data_ptr(), c, w,
                 out.data_ptr(), raw_stream(idx))
        if err:
            raise RuntimeError(f"dequant_add kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["dequant_add"] += 1
        sanitize.report("dequant_add", out)
    return out


class QuantImpl(NamedTuple):
    """The quantize and the accumulate a packed collective runs."""

    quantize: Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]
    #: ``(acc, q, scale, out=None)``; ``out=acc`` accumulates in place
    dequant_add: Callable[..., torch.Tensor]


#: the kernels (plain versions for CPU tensors) — the training path
KERNELS = QuantImpl(quantize_chunks, dequant_add)
#: the plain versions on any device — what the kernels are held against
PLAIN = QuantImpl(quantize_plain, dequant_add_plain)
