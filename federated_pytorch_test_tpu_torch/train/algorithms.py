"""Federated algorithm strategies: FedAvg, FedProx, ADMM consensus, none.

Port of ``federated_pytorch_test_tpu/train/algorithms.py``.  Each strategy
supplies the per-client penalty added to the local loss and the global
update of a communication round, on the flat masked block vectors.  Here
``x``/``y`` are the process's ``[K, N]`` client stacks (all K with one
process, this rank's rows on a rank mesh) and ``mesh`` the client mesh,
whose shards and fixed-order ``psum`` stand for the JAX package's
``shard_map`` over the ``'clients'`` axis.  Per-client reductions run
shard by shard (``ClientMesh.per_shard``), as each JAX device reduces its
own rows, so the numbers do not depend on how the shards are spread over
processes.

Write-back: FedAvg overwrites every client with z; FedProx and ADMM never
write back (consensus only through the penalty).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from federated_pytorch_test_tpu_torch.parallel.comm import federated_mean
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh


def _active_mean(x: torch.Tensor, w: Optional[torch.Tensor], K: int,
                 mesh: ClientMesh) -> torch.Tensor:
    """Mean of x [K, N] over the active clients (``w`` [K] participation
    weights; ``None`` = every client).  An all-rejected round (no weight)
    gives the zero vector, not 0/0."""
    if w is None:
        return federated_mean(x, K, mesh)
    n_act = mesh.psum([s.sum() for s in mesh.shards(w)])
    return (mesh.federated_sum(w[:, None] * x)
            / torch.where(n_act > 0, n_act, torch.ones_like(n_act)))


def _primal(per_client: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """Sum over all clients of a per-client [K] quantity: local sums, psum."""
    return mesh.psum([s.sum() for s in mesh.shards(per_client)])


class Algorithm:
    """Base strategy (also the `no_consensus` strategy: train, never talk)."""

    name = "none"
    needs_dual = False   # per-client y state
    writeback = False    # overwrite client params with z after the round
    communicates = False

    def penalty(self, x: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                rho: torch.Tensor) -> torch.Tensor:
        """Extra local-loss term of one client; x is its flat block."""
        return torch.zeros((), dtype=x.dtype, device=x.device)

    def global_update(self, x, z, y, rho, K: int, mesh: ClientMesh, w=None,
                      mean_fn=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """(z_new, y_new, diagnostics) from the stacks x, y [K, N].
        ``mean_fn`` (``(stack, w) -> aggregate``) replaces the plain mean:
        the robust-aggregation hook."""
        return z, y, {}

    @staticmethod
    def _agg(stack, w, K, mesh, mean_fn):
        """The one chokepoint every strategy averages through."""
        if mean_fn is None:
            return _active_mean(stack, w, K, mesh)
        return mean_fn(stack, w)


class NoConsensus(Algorithm):
    """K independent models, no exchange ever (no_consensus_multi.py)."""


class FedAvg(Algorithm):
    """Blockwise federated averaging (federated_multi.py:203-217)."""

    name = "fedavg"
    writeback = True
    communicates = True

    def global_update(self, x, z, y, rho, K, mesh, w=None, mean_fn=None):
        znew = self._agg(x, w, K, mesh, mean_fn)
        dual = torch.linalg.vector_norm(z - znew) / x.shape[-1]
        return znew, y, {"dual_residual": dual}


class FedProx(Algorithm):
    """Proximal local objective, averaging only (fedprox_multi.py):
    local loss += (rho/2)||x - z||^2; z is never sent back."""

    name = "fedprox"
    communicates = True

    def penalty(self, x, z, y, rho):
        d = x - z
        return 0.5 * rho * torch.dot(d, d)

    def global_update(self, x, z, y, rho, K, mesh, w=None, mean_fn=None):
        znew = self._agg(x, w, K, mesh, mean_fn)
        n = x.shape[-1]
        dual = torch.linalg.vector_norm(z - znew) / n
        per = mesh.per_shard(
            lambda s: torch.linalg.vector_norm(rho * (s - znew), dim=1), x)
        if w is not None:
            per = per * w
        return znew, y, {"primal_residual": _primal(per, mesh) / n,
                         "dual_residual": dual}


class AdmmConsensus(Algorithm):
    """Scaled-ADMM consensus (consensus_multi.py:209-299): local loss +=
    y^T (x - z) + (rho/2)||x - z||^2; z = sum_k (y_k + rho x_k) / (K rho);
    y_k += rho (x_k - z)."""

    name = "consensus"
    needs_dual = True
    communicates = True

    def penalty(self, x, z, y, rho):
        d = x - z
        return torch.dot(y, d) + 0.5 * rho * torch.dot(d, d)

    def global_update(self, x, z, y, rho, K, mesh, w=None, mean_fn=None):
        znew = self._agg(y + rho * x, w, K, mesh, mean_fn) / rho
        n = x.shape[-1]
        dual = torch.linalg.vector_norm(z - znew) / n      # before the y update
        ydelta = rho * (x - znew)
        if w is not None:
            ydelta = w[:, None] * ydelta
        primal = _primal(mesh.per_shard(
            lambda s: torch.linalg.vector_norm(s, dim=1), ydelta), mesh) / n
        return znew, y + ydelta, {"primal_residual": primal,
                                  "dual_residual": dual}


@dataclasses.dataclass(frozen=True)
class BBConfig:
    period_T: int = 2
    alphacorrmin: float = 0.2
    epsilon: float = 1e-3
    rhomax: float = 0.1


def bb_rho_update(x, z, y, rho, x0, yhat0, bb: BBConfig,
                  mesh: Optional[ClientMesh] = None):
    """Barzilai-Borwein spectral rho update (consensus_multi.py:242-278).

    Per client: yhat = y + rho(x - z); dy = yhat - yhat0; dx = x - x0;
    d11 = dy.dy, d12 = dy.dx, d22 = dx.dx; alpha = d12/sqrt(d11 d22),
    alpha_SD = d11/d22, alpha_MG = d12/d22; alphahat = alpha_MG if
    2 alpha_MG > alpha_SD else alpha_SD - alpha_MG/2; accepted iff alpha >=
    alphacorrmin and alphahat < rhomax.  As in the JAX package, every client
    evaluates with the round's incoming rho and the last client's (k = K-1)
    decision is adopted (on a rank mesh, gathered from the last rank).
    Returns (rho_new, x0_new, yhat0_new)."""
    mesh = mesh or ClientMesh(1)
    yhat = y + rho * (x - z)
    dy = yhat - yhat0
    dx = x - x0
    rowdot = lambda a, b: (a * b).sum(dim=1)
    d11 = mesh.per_shard(rowdot, dy, dy)
    d12 = mesh.per_shard(rowdot, dy, dx)
    d22 = mesh.per_shard(rowdot, dx, dx)
    ok_den = (d12.abs() > bb.epsilon) & (d11 > bb.epsilon) & (d22 > bb.epsilon)
    alpha = d12 / torch.sqrt(d11 * d22 + 1e-30)
    alpha_sd = d11 / (d22 + 1e-30)
    alpha_mg = d12 / (d22 + 1e-30)
    alphahat = torch.where(2.0 * alpha_mg > alpha_sd, alpha_mg,
                           alpha_sd - 0.5 * alpha_mg)
    accept = ok_den & (alpha >= bb.alphacorrmin) & (alphahat < bb.rhomax)
    cand = torch.where(accept, alphahat, rho.expand_as(alphahat))
    return mesh.gather_rows(cand)[-1], x, yhat
