"""InfoNCE loss core for CPC — the plain PyTorch version.

Mirror of ``federated_pytorch_test_tpu/ops/infonce_core.py``.  These are
the plain versions of the two InfoNCE kernels in ``ops/infonce.py``: the
CPU tests run them against the JAX package, and ``chip_smoke.py`` holds
the kernels against them on the card.
"""

from __future__ import annotations

import torch


def flat_patch_matrix(z: torch.Tensor) -> torch.Tensor:
    """[B, R, px, py] NCHW -> [B*R, P]: rows ordered (b, r), column p the
    patch position p = x*py + y (the JAX package's NHWC
    ``z.transpose(0, 3, 1, 2).reshape(-1, px*py)``)."""
    B, R, px, py = z.shape
    return z.reshape(B * R, px * py)


def safe_norms(Z: torch.Tensor) -> torch.Tensor:
    """Column L2 norms with zero columns mapped to 1 (the guard sits inside
    the sqrt, so autograd through it stays finite at a zero column)."""
    sq = torch.sum(Z * Z, dim=0)
    return torch.sqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq))


def log_p_flat(Z: torch.Tensor, Zhat: torch.Tensor) -> torch.Tensor:
    """Per-position log softmax-diagonal [P] from flat [D, P] matrices:
    ``zz = Z^T Zhat / (|z_i| |zhat_j|)``, ``log_p_i = zz_ii - lse_j zz_ij``."""
    zz = (Z.t() @ Zhat) / (safe_norms(Z)[:, None] * safe_norms(Zhat)[None, :])
    return torch.diagonal(zz) - torch.logsumexp(zz, dim=1)


def loss_from_log_p(log_p: torch.Tensor) -> torch.Tensor:
    """-sum log(softmax_diag + 1e-6) — the reference adds 1e-6 inside the
    log (federated_cpc.py:178)."""
    return -torch.sum(torch.log(torch.exp(log_p) + 1e-6))


def info_nce(z: torch.Tensor, zhat: torch.Tensor) -> torch.Tensor:
    """z, zhat: [B, R, px, py] NCHW -> scalar loss (autograd through the
    plain ops)."""
    return loss_from_log_p(log_p_flat(flat_patch_matrix(z),
                                      flat_patch_matrix(zhat)))
