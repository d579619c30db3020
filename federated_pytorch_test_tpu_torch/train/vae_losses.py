"""VAE and clustering-VAE losses.

Port of ``federated_pytorch_test_tpu/train/vae_losses.py``: the plain VAE
ELBO, sum-MSE + KLD (federated_vae.py:96-108), and the clustering ELBO
(arXiv:2005.04613), ``sum_k c1 + ALPHA*(c2 + c3) + BETA*c21``
(federated_vae_cl.py:101-162).

Every function takes an optional per-sample weight ``w`` [B]: the pad rows
of the wrap-padded last minibatch carry weight 0, and every
mean-over-batch divisor is ``sum(w)``, the true size of the partial batch;
``w=None`` means all ones.  The clustering costs accept responsibilities
``pk`` of shape [B] (one cluster) or [Kc, B] (every cluster at once, the
per-cluster tensors then [Kc, B, ...]) and return one value per cluster.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_TWO_PI = 2.0 * math.pi
ALPHA, BETA = 10.0, 1.0              # the reference's weights


def _weights(pk: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones(pk.shape[-1], dtype=pk.dtype, device=pk.device) \
        if w is None else w


def _per_sample_sum(t: torch.Tensor, lead: int) -> torch.Tensor:
    """Sum over every dimension after the first ``lead`` ones."""
    return t.reshape(*t.shape[:lead], -1).sum(dim=-1)


def vae_loss(recon_x, x, mu, logvar, w=None):
    """sum-MSE + KLD, KLD = -0.5 sum(1 + logvar - mu^2 - exp(logvar))
    (reduction 'sum' on both terms); with ``w``, each sample's terms
    weighted."""
    mse = _per_sample_sum((recon_x - x) ** 2, 1)
    kld = -0.5 * _per_sample_sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), 1)
    if w is None:
        return mse.sum() + kld.sum()
    return (w * mse).sum() + (w * kld).sum()


def cost1(pk, mu_th, sig2_th, x, w=None):
    """Weighted reconstruction -E_qk[log p(x|theta)]
    (federated_vae_cl.py:101-109): the mean over the batch of
    pk_i * sum(err + err1)."""
    w = _weights(pk, w)
    err = (x - mu_th) ** 2 / (2.0 * sig2_th)
    err1 = 0.5 * torch.log(sig2_th * _TWO_PI)
    per_sample = _per_sample_sum(err + err1, pk.dim())
    return (w * pk * per_sample).sum(dim=-1) / w.sum()


def cost2(pk, w=None):
    """Sample-wise entropy -E[log q(k|x)] (federated_vae_cl.py:113-118)."""
    w = _weights(pk, w)
    return (-w * pk * torch.log(pk + 1e-9)).sum(dim=-1) / w.sum()


def cost21(pk, w=None):
    """Inverse batch entropy, against cluster collapse
    (federated_vae_cl.py:122-126)."""
    w = _weights(pk, w)
    pbar = (w * pk).sum(dim=-1) / w.sum()
    return 1.0 / (-pbar * torch.log(pbar + 1e-9) + 1e-9)


def cost3(pk, q_z_mu, q_z_sig2, p_z_mu, p_z_sig2, w=None):
    """KL(q(z|x,k) || p(z|k)) weighted by pk (federated_vae_cl.py:131-140)."""
    w = _weights(pk, w)
    mudiff = (p_z_mu - q_z_mu) ** 2 / p_z_sig2
    sigratio = q_z_sig2 / p_z_sig2
    per_sample = 0.5 * _per_sample_sum(
        sigratio - torch.log(sigratio) + mudiff - 1.0, pk.dim())
    return (w * pk * per_sample).sum(dim=-1) / w.sum()


def vae_cl_loss(ekhat, mu_xi, sig2_xi, mu_b, sig2_b, mu_th, sig2_th, x,
                w=None):
    """The clustering ELBO (federated_vae_cl.py:142-162): ``ekhat`` [B,
    Kc], the per-cluster tensors [Kc, B, ...] (the model's output order),
    summed over the clusters."""
    pk = ekhat.t()                                               # [Kc, B]
    per_k = (cost1(pk, mu_th, sig2_th, x, w)
             + ALPHA * (cost2(pk, w) + cost3(pk, mu_xi, sig2_xi, mu_b,
                                             sig2_b, w))
             + BETA * cost21(pk, w))
    return per_k.sum()
