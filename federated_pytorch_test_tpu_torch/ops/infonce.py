"""InfoNCE (CPC contrastive loss) with hand-written CUDA kernels.

Port of ``federated_pytorch_test_tpu/ops/infonce.py``.  Two kernels from
``csrc/infonce.cu`` replace the two Pallas TPU kernels:

  * :func:`infonce_fwd` — ``log_p [P]`` from Z, Zhat ``[D, P]``
    (replaces ``_log_p_kernel``);
  * :func:`infonce_bwd` — dZ, dZhat from the saved ``log_p`` and ``ghat``
    (replaces ``_grad_kernel``).

Each is one launch of one cluster of 16 blocks that split the rows of D
and sum their partials in rank order through distributed shared memory
(:func:`plan`, P <= 32; the path has P = 9).  Above that the wrappers take
the rows branch, one block per score row.

Both are wrapped in one ``torch.autograd.Function`` that saves
``(Z, Zhat, log_p)``, as the JAX ``custom_vjp`` does.  Dispatch is by the
tensors' device: a CPU tensor takes the plain version
(:func:`~federated_pytorch_test_tpu_torch.ops.infonce_core.log_p_flat`,
:func:`grads_plain`), a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from federated_pytorch_test_tpu_torch.ops import cuda_build
from federated_pytorch_test_tpu_torch.ops.infonce_core import (
    flat_patch_matrix,
    log_p_flat,
    loss_from_log_p,
    safe_norms,
)

#: launches of each kernel in this process (the wrappers add one per launch)
LAUNCHES = {"infonce_fwd": 0, "infonce_bwd": 0}

#: largest P the kernels take: the rows branch's backward keeps 2P floats
#: of a score row in shared memory, under the 48 KB a block gets without
#: opting in
MAX_P = 4096

#: blocks of the cluster (``csrc/infonce.cu`` ``kCluster``): 16, the
#: non-portable cluster size, on which the rows' work halves against the
#: portable 8 (a cluster of 8 read slower on the H100: PERF.md)
CLUSTER = 16
#: largest P of the cluster branch: its kernels are compiled for P exactly
#: up to 16 and padded to a multiple of 4 up to 32
CLUSTER_MAX_P = 32
#: threads of a block (``kThreads``)
THREADS = 512
#: shared memory a block may stage rows of Z, Zhat, dZ and dZhat in
STAGE_BYTES = 128 * 1024
#: shared memory a block may use on the H100 (227 KB), as ``csrc/infonce.cu``
SMEM_LIMIT = 232_448
#: the branches of the kernels
BRANCHES = ("cluster", "rows")


class Plan(NamedTuple):
    """How the kernels split a ``[D, P]`` problem.  ``csrc/infonce.cu``
    ``cluster_plan`` computes the same split from (D, P) for its launch;
    the wrappers take only the branch from here, the tests the rest."""

    #: "cluster" (one launch of one cluster, P <= CLUSTER_MAX_P) or "rows"
    #: (one block per score row; the backward in two launches)
    branch: str
    #: blocks of the cluster; 0 on the rows branch
    cluster: int
    #: block r owns rows [r * rows_per_block, (r + 1) * rows_per_block) of D
    rows_per_block: int
    #: rows staged in shared memory at a time (a block's rows in tiles)
    tile_rows: int
    #: rows of a tile one backward thread forms at once (``RB``): 2 up to
    #: P = 12, 1 above (what 128 registers a thread hold)
    rows_per_thread: int
    #: dynamic shared memory of a block, bytes
    smem_bytes: int


def cluster_smem_bytes(P: int, tile_rows: int) -> int:
    """Shared memory of a cluster block (``csrc/infonce.cu``
    ``cluster_smem_floats``): the staged rows of Z, Zhat, dZ and dZhat
    [tile_rows, P] each (padded to a multiple of 4 floats); every rank's
    pushed partials, this block's and the totals [CLUSTER + 2, P, PS + 4];
    Gn and Gn^T [P, PS] each (PS: P padded to a multiple of 4); each warp's
    sums of its lanes' partials [16, 3, PS + 2]; four [P] vectors and two
    mbarriers (5 floats, with their alignment)."""
    staged = -(-tile_rows * P // 4) * 4
    ps = -(-P // 4) * 4
    floats = (4 * staged + (CLUSTER + 2) * P * (ps + 4) + 2 * P * ps
              + 16 * 3 * (ps + 2) + 4 * P + 5)
    return 4 * floats


@functools.lru_cache(maxsize=None)
def plan(D: int, P: int) -> Plan:
    """The kernels' split of ``[D, P]``: a pure function of (D, P), so the
    order of every sum, and so the result, repeats from run to run.  P up to
    :data:`CLUSTER_MAX_P` takes the cluster branch (what the shared memory
    and the registers of a block hold: :func:`cluster_smem_bytes` stays
    under 227 KB); above it the rows branch.  Blocks own and stage whole
    multiples of 4 rows, so a tile's source is 16-byte aligned whenever the
    tensor is (the kernels then stage it with one bulk copy)."""
    if P > CLUSTER_MAX_P:
        return Plan("rows", 0, D, 0, 0, 0)
    rows_per_block = -(-D // (4 * CLUSTER)) * 4
    tile_rows = min(rows_per_block, STAGE_BYTES // (16 * P) // 4 * 4)
    return Plan("cluster", CLUSTER, rows_per_block, tile_rows,
                2 if P <= 12 else 1, cluster_smem_bytes(P, tile_rows))


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


_F32 = torch.float32

#: the launch path: (forward C function, backward C function, raw stream of
#: a device index, current device), bound at the first launch
#: (``cuda_build``'s lean path)
_infonce_c = None


def _bind():
    global _infonce_c
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    _infonce_c = (cuda_build.bind("infonce", "infonce_fwd",
                                  [vp, vp, vp, ll, i, i, vp]),
                  cuda_build.bind("infonce", "infonce_bwd",
                                  [vp, vp, vp, vp, vp, vp, vp, ll, i, i, vp]),
                  *cuda_build.cuda_runtime())
    return _infonce_c


def _on_card(Z: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors on one
    device; raises otherwise."""
    if Z.is_cuda and all(t.device == Z.device for t in others):
        return True
    if Z.is_cpu and all(t.is_cpu for t in others):
        return False
    raise ValueError("InfoNCE kernels take tensors that all lie on one "
                     f"CUDA device (or all on the CPU); got {Z.device} "
                     f"and {[str(t.device) for t in others]}")


def _check_flat(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != _F32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_card(Z: torch.Tensor, Zhat: torch.Tensor, current_device) -> tuple:
    """(D, P, device index) of a launch: Z and Zhat [D, P] float32 and
    contiguous, on the current CUDA device."""
    shape = Z.shape
    if len(shape) != 2:
        raise ValueError(f"Z: expected [D, P], got shape {tuple(shape)}")
    D, P = shape
    if not (D >= 1 and 1 <= P <= MAX_P):
        raise ValueError(f"InfoNCE kernels take D >= 1 and 1 <= P <= {MAX_P}; "
                         f"got D={D}, P={P}")
    _check_flat("Z", Z, shape)
    _check_flat("Zhat", Zhat, shape)
    idx = Z.get_device()
    if idx != current_device():
        raise ValueError(f"tensors lie on {Z.device} but the current CUDA "
                         f"device is cuda:{current_device()}; call under "
                         f"torch.cuda.device({idx})")
    return D, P, idx


def _branch(D: int, P: int, branch) -> str:
    """The branch a launch takes: :func:`plan`'s, or ``branch`` when given
    (to time one design against the other on the same inputs)."""
    if branch is None:
        return plan(D, P).branch
    if branch not in BRANCHES or (branch == "cluster" and P > CLUSTER_MAX_P):
        raise ValueError(f"branch {branch!r} does not take P={P}; the "
                         f"cluster branch takes P <= {CLUSTER_MAX_P}, the "
                         f"rows branch any P")
    return branch


def infonce_fwd(Z: torch.Tensor, Zhat: torch.Tensor,
                branch=None) -> torch.Tensor:
    """``log_p [P]`` — the forward kernel on a CUDA tensor, the plain
    version on a CPU tensor.  ``branch`` ("cluster" or "rows") overrides
    :func:`plan`'s choice of kernel."""
    if not _on_card(Z, Zhat):
        return log_p_flat(Z, Zhat)
    fwd, _, raw_stream, current_device = _infonce_c or _bind()
    D, P, idx = _check_card(Z, Zhat, current_device)
    rows = _branch(D, P, branch) == "rows"
    log_p = Z.new_empty(P)
    err = fwd(Z.data_ptr(), Zhat.data_ptr(), log_p.data_ptr(), D, P, rows,
              raw_stream(idx))
    if err:
        raise RuntimeError(f"infonce_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES["infonce_fwd"] += 1
    return log_p


def infonce_bwd(Z: torch.Tensor, Zhat: torch.Tensor, log_p: torch.Tensor,
                ghat: torch.Tensor,
                branch=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dZ, dZhat)`` — the backward kernel on CUDA tensors, the plain
    version on CPU tensors.  The cluster branch takes no scratch; the rows
    branch's ``[3P^2 + 2P]`` scratch shares the outputs' allocation.
    ``branch`` as for :func:`infonce_fwd`."""
    if not _on_card(Z, Zhat, log_p, ghat):
        return grads_plain(Z, Zhat, log_p, ghat)
    _, bwd, raw_stream, current_device = _infonce_c or _bind()
    D, P, idx = _check_card(Z, Zhat, current_device)
    _check_flat("log_p", log_p, (P,))
    _check_flat("ghat", ghat, (P,))
    rows = _branch(D, P, branch) == "rows"
    if not rows:
        dZ, dZhat = Z.new_empty((2, D, P))
        scratch = 0
    else:
        buf = Z.new_empty(2 * D * P + 3 * P * P + 2 * P)
        dZ, dZhat = buf[:2 * D * P].view(2, D, P)
        scratch = buf.data_ptr() + 4 * 2 * D * P
    err = bwd(Z.data_ptr(), Zhat.data_ptr(), log_p.data_ptr(), ghat.data_ptr(),
              dZ.data_ptr(), dZhat.data_ptr(), scratch, D, P, rows,
              raw_stream(idx))
    if err:
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
