"""InfoNCE (CPC contrastive loss) with hand-written CUDA kernels.

Port of ``federated_pytorch_test_tpu/ops/infonce.py``.  Two kernels from
``csrc/infonce.cu`` replace the two Pallas TPU kernels:

  * :func:`infonce_fwd` — ``log_p [P]`` from Z, Zhat ``[D, P]``
    (replaces ``_log_p_kernel``);
  * :func:`infonce_bwd` — dZ, dZhat from the saved ``log_p`` and ``ghat``
    (replaces ``_grad_kernel``).

Both are wrapped in one ``torch.autograd.Function`` that saves
``(Z, Zhat, log_p)``, as the JAX ``custom_vjp`` does.  Dispatch is by the
tensors' device: a CPU tensor takes the plain version
(:func:`~federated_pytorch_test_tpu_torch.ops.infonce_core.log_p_flat`,
:func:`grads_plain`), a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import torch

from federated_pytorch_test_tpu_torch.ops.cuda_build import load_library
from federated_pytorch_test_tpu_torch.ops.infonce_core import (
    flat_patch_matrix,
    log_p_flat,
    loss_from_log_p,
    safe_norms,
)

#: launches of each kernel in this process (the wrappers add one per launch)
LAUNCHES = {"infonce_fwd": 0, "infonce_bwd": 0}

#: largest P the kernels take: the backward keeps 2P floats of a score row
#: in shared memory, under the 48 KB a block gets without opting in
MAX_P = 4096


def grads_plain(Z: torch.Tensor, Zhat: torch.Tensor, log_p: torch.Tensor,
                ghat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel — the hand-derived formula of
    the JAX package's ``_grads_xla``, not autograd.  With the zero-norm
    guard a zero column has zz = 0, so its norm-path terms vanish."""
    zn = safe_norms(Z)
    zhn = safe_norms(Zhat)
    denom = zn[:, None] * zhn[None, :]
    zz = (Z.t() @ Zhat) / denom
    lse = torch.diagonal(zz) - log_p
    s = torch.exp(zz - lse[:, None])                  # softmax rows
    eye = torch.eye(zz.shape[0], dtype=zz.dtype, device=zz.device)
    G = ghat[:, None] * (eye - s)
    Gn = G / denom
    dzn = -torch.sum(G * zz, dim=1) / zn
    dzhn = -torch.sum(G * zz, dim=0) / zhn
    dZ = Zhat @ Gn.t() + Z * (dzn / zn)[None, :]
    dZhat = Z @ Gn + Zhat * (dzhn / zhn)[None, :]
    return dZ, dZhat


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_card(Z: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors on one
    device; raises otherwise."""
    if Z.device.type == "cpu" and all(t.device.type == "cpu" for t in others):
        return False
    if Z.device.type != "cuda" or any(t.device != Z.device for t in others):
        raise ValueError("InfoNCE kernels take tensors that all lie on one "
                         f"CUDA device (or all on the CPU); got {Z.device} "
                         f"and {[str(t.device) for t in others]}")
    return True


def _lib() -> ctypes.CDLL:
    lib = load_library("infonce")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.infonce_fwd.argtypes = [vp, vp, vp, ll, i, vp]
        lib.infonce_fwd.restype = i
        lib.infonce_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, i, vp]
        lib.infonce_bwd.restype = i
        lib._typed = True
    return lib


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev``, which must be the current CUDA
    device (the kernels launch on the current device)."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {dev} but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}; call under "
                         f"torch.cuda.device({dev.index})")
    return torch.cuda.current_stream(dev).cuda_stream


def _check_flat(Z: torch.Tensor, Zhat: torch.Tensor) -> Tuple[int, int]:
    if Z.dim() != 2:
        raise ValueError(f"Z: expected [D, P], got shape {tuple(Z.shape)}")
    D, P = Z.shape
    if not (D >= 1 and 1 <= P <= MAX_P):
        raise ValueError(f"InfoNCE kernels take D >= 1 and 1 <= P <= {MAX_P}; "
                         f"got D={D}, P={P}")
    _check("Z", Z, (D, P))
    _check("Zhat", Zhat, (D, P))
    return D, P


def infonce_fwd(Z: torch.Tensor, Zhat: torch.Tensor) -> torch.Tensor:
    """``log_p [P]`` — the forward kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not _on_card(Z, Zhat):
        return log_p_flat(Z, Zhat)
    D, P = _check_flat(Z, Zhat)
    lib = _lib()
    log_p = torch.empty(P, dtype=torch.float32, device=Z.device)
    err = lib.infonce_fwd(Z.data_ptr(), Zhat.data_ptr(), log_p.data_ptr(),
                          D, P, _stream(Z.device))
    if err != 0:
        raise RuntimeError(f"infonce_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES["infonce_fwd"] += 1
    return log_p


def infonce_bwd(Z: torch.Tensor, Zhat: torch.Tensor, log_p: torch.Tensor,
                ghat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dZ, dZhat)`` — the backward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not _on_card(Z, Zhat, log_p, ghat):
        return grads_plain(Z, Zhat, log_p, ghat)
    D, P = _check_flat(Z, Zhat)
    _check("log_p", log_p, (P,))
    _check("ghat", ghat, (P,))
    lib = _lib()
    dZ, dZhat = torch.empty((2, D, P), dtype=torch.float32, device=Z.device)
    scratch = torch.empty(3 * P * P + 2 * P, dtype=torch.float32,
                          device=Z.device)
    err = lib.infonce_bwd(Z.data_ptr(), Zhat.data_ptr(), log_p.data_ptr(),
                          ghat.data_ptr(), dZ.data_ptr(), dZhat.data_ptr(),
                          scratch.data_ptr(), D, P, _stream(Z.device))
    if err != 0:
        raise RuntimeError(f"infonce_bwd kernel launch failed: CUDA error {err}")
    LAUNCHES["infonce_bwd"] += 1
    return dZ, dZhat


class InfoNCEImpl(NamedTuple):
    """The forward and backward a :class:`_FusedInfoNCE` call runs."""

    log_p: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grads: Callable[..., Tuple[torch.Tensor, torch.Tensor]]


#: the kernels (plain versions for CPU tensors) — the training path
KERNELS = InfoNCEImpl(infonce_fwd, infonce_bwd)
#: the plain versions on any device — what the kernels are held against
PLAIN = InfoNCEImpl(log_p_flat, grads_plain)


class _FusedInfoNCE(torch.autograd.Function):
    """loss = -sum log(exp(log_p) + 1e-6), with the hand-derived backward
    from the saved ``log_p`` (the JAX package's ``_fused_flat``)."""

    @staticmethod
    def forward(ctx, Z, Zhat, impl: InfoNCEImpl):
        log_p = impl.log_p(Z, Zhat)
        ctx.save_for_backward(Z, Zhat, log_p)
        ctx.impl = impl
        return loss_from_log_p(log_p)

    @staticmethod
    def backward(ctx, ct):
        Z, Zhat, log_p = ctx.saved_tensors
        c = torch.exp(log_p)
        ghat = (-ct * c / (c + 1e-6)).contiguous()
        dZ, dZhat = ctx.impl.grads(Z, Zhat, log_p, ghat)
        return dZ, dZhat, None


def info_nce_fused(z: torch.Tensor, zhat: torch.Tensor,
                   impl: InfoNCEImpl = KERNELS) -> torch.Tensor:
    """InfoNCE over patch positions; z, zhat: [B, R, px, py] NCHW.  Runs
    the CUDA kernels for CUDA tensors (``impl=PLAIN`` runs the plain
    versions instead, for comparison)."""
    return _FusedInfoNCE.apply(flat_patch_matrix(z).contiguous(),
                               flat_patch_matrix(zhat).contiguous(), impl)
