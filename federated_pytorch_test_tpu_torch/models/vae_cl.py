"""Variational clustering autoencoder (arXiv:2005.04613), functional, NCHW.

Mirror of ``federated_pytorch_test_tpu/models/vae_cl.py`` (reference
``AutoEncoderCNNCL``, simple_models.py:309-432): the cluster head q(k|x)
(softmax), the per-cluster encoder q(z|x,k) with a softplus variance, the
prior p(z|k) and the likelihood p(x|z).  The conv stack is computed once
and shared by every cluster, as in the JAX package; the Kc clusters then
run as one batch of Kc*B rows (cluster k's one-hot ``e_k`` and its own
noise ``eps[k]`` on rows k*B..k*B+B-1), and every per-cluster output comes
back with a leading [Kc] axis in the JAX order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from federated_pytorch_test_tpu_torch.models.base import (
    FunctionalModel,
    conv_leaf,
    conv_transpose,
    dense,
    dense_leaf,
    elu,
    pairs,
)
from federated_pytorch_test_tpu_torch.models.vae import (
    conv_stack,
    conv_stack_shapes,
    unflatten_nhwc,
)

softplus = F.softplus


class AutoEncoderCNNCL(FunctionalModel):
    def __init__(self, K: int = 10, L: int = 32):
        super().__init__()
        self.K = K                    # clusters
        self.L = L                    # latent dimension

    def param_shapes(self):
        K, L = self.K, self.L
        return {**conv_stack_shapes(),
                "fc11": dense_leaf(128, 384), "fc12": dense_leaf(64, 128),
                "fc13": dense_leaf(K, 64), "fc21": dense_leaf(128, 384 + K),
                "fc22": dense_leaf(128, 128), "fc23": dense_leaf(L, 128),
                "fc24": dense_leaf(L, 128), "fc14": dense_leaf(64, K),
                "fc15": dense_leaf(64, 64), "fc16": dense_leaf(L, 64),
                "fc17": dense_leaf(L, 64), "fc25": dense_leaf(384, L),
                "tconv1": conv_leaf(48, 96, 4), "tconv2": conv_leaf(24, 48, 4),
                "tconv3": conv_leaf(12, 24, 4), "tconv4": conv_leaf(3, 12, 4),
                "tconv5": conv_leaf(3, 12, 4)}

    def noise_shape(self, batch: int) -> Tuple[int, ...]:
        return (self.K, batch, self.L)

    def apply(self, params, x: torch.Tensor, eps: torch.Tensor):
        """``(ekhat, mu_xi, sig2_xi, mu_b, sig2_b, mu_th, sig2_th)`` of NCHW
        ``x`` [B, 3, 32, 32] with the noise ``eps`` [Kc, B, L]: ``ekhat``
        [B, Kc], the rest [Kc, B, ...] (``mu_th``, ``sig2_th`` NCHW).
        Always reparametrised: the reference's ``disable_repr()`` is a
        no-op."""
        K, B = self.K, x.shape[0]
        h = conv_stack(params, x)                                 # [B, 384]
        c = elu(dense(h, params["fc11"]))
        c = elu(dense(c, params["fc12"]))
        ekhat = torch.softmax(elu(dense(c, params["fc13"])), dim=1)
        # cluster k's rows: k*B .. k*B + B - 1
        ek = torch.eye(K, dtype=x.dtype, device=x.device).repeat_interleave(
            B, dim=0)                                             # [K*B, K]
        y = elu(dense(torch.cat([h.repeat(K, 1), ek], dim=1), params["fc21"]))
        y = elu(dense(y, params["fc22"]))
        mu_xi = elu(dense(y, params["fc23"]))
        sig2_xi = softplus(elu(dense(y, params["fc24"])))
        z = eps.reshape(K * B, self.L) * torch.sqrt(sig2_xi) + mu_xi
        d = elu(dense(ek, params["fc14"]))
        d = elu(dense(d, params["fc15"]))
        mu_b = dense(d, params["fc16"])
        sig2_b = softplus(dense(d, params["fc17"]))
        g = unflatten_nhwc(elu(dense(z, params["fc25"])))
        for name in ("tconv1", "tconv2", "tconv3"):
            g = elu(conv_transpose(g, params[name]))
        mu_th = elu(conv_transpose(g, params["tconv4"]))
        sig2_th = softplus(elu(conv_transpose(g, params["tconv5"])))
        per_cluster = (mu_xi, sig2_xi, mu_b, sig2_b, mu_th, sig2_th)
        return (ekhat,) + tuple(t.reshape(K, B, *t.shape[1:])
                                for t in per_cluster)

    def param_order(self) -> List[str]:
        return pairs("conv1", "conv2", "conv3", "conv4",
                     "fc11", "fc12", "fc13", "fc21", "fc22", "fc23", "fc24",
                     "fc14", "fc15", "fc16", "fc17", "fc25",
                     "tconv1", "tconv2", "tconv3", "tconv4", "tconv5")

    def train_order_block_ids(self) -> List[List[int]]:
        # reference simple_models.py:430-432: encoder, decoder, latent space
        return [[0, 7], [32, 41], [8, 31]]
