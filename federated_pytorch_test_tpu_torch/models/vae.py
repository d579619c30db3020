"""Variational autoencoder for CIFAR-10 (functional, NCHW).

Mirror of ``federated_pytorch_test_tpu/models/vae.py`` (reference
``AutoEncoderCNN``, simple_models.py:243-305): four stride-2 4x4 convs
32 -> 2 px, fc 384 -> 16 -> (mu, logvar), decode fc 384 -> four transposed
convs -> sigmoid; the JAX parameter order and training blocks.  The
reparametrisation noise ``eps`` is the caller's (the trainer draws it per
client and step), where the JAX package draws it from a PRNG key.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from federated_pytorch_test_tpu_torch.models.base import (
    FunctionalModel,
    conv,
    conv_leaf,
    conv_transpose,
    dense,
    dense_leaf,
    elu,
    flatten_nhwc,
    pairs,
)


def conv_stack(params, x: torch.Tensor) -> torch.Tensor:
    """conv1..conv4 (4x4, stride 2, padding 1) with ELU, flattened in the
    NHWC order: [B, 3, 32, 32] -> [B, 384]."""
    for name in ("conv1", "conv2", "conv3", "conv4"):
        x = elu(conv(x, params[name], stride=2, padding=1))
    return flatten_nhwc(x)


def conv_stack_shapes() -> dict:
    return {"conv1": conv_leaf(12, 3, 4), "conv2": conv_leaf(24, 12, 4),
            "conv3": conv_leaf(48, 24, 4), "conv4": conv_leaf(96, 48, 4)}


def unflatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, 384] in the JAX order ``reshape(-1, 2, 2, 96)`` -> NCHW."""
    return x.reshape(-1, 2, 2, 96).permute(0, 3, 1, 2)


#: the latent dimension (the JAX model's default)
LATENT = 10


class AutoEncoderCNN(FunctionalModel):
    def param_shapes(self):
        L = LATENT
        return {**conv_stack_shapes(), "fc1": dense_leaf(16, 384),
                "fc21": dense_leaf(L, 16), "fc22": dense_leaf(L, 16),
                # a transposed conv's flax kernel in the conv layout
                # [out, in, kh, kw] (models/base.py conv_transpose)
                "fc3": dense_leaf(384, L), "tconv1": conv_leaf(48, 96, 4),
                "tconv2": conv_leaf(24, 48, 4), "tconv3": conv_leaf(12, 24, 4),
                "tconv4": conv_leaf(3, 12, 4)}

    def noise_shape(self, batch: int) -> Tuple[int, ...]:
        return (batch, LATENT)

    def encode(self, params, x: torch.Tensor):
        h = elu(dense(conv_stack(params, x), params["fc1"]))   # 16
        return dense(h, params["fc21"]), dense(h, params["fc22"])

    def decode(self, params, z: torch.Tensor) -> torch.Tensor:
        x = unflatten_nhwc(dense(z, params["fc3"]))            # 96x2x2
        for name in ("tconv1", "tconv2", "tconv3", "tconv4"):
            x = elu(conv_transpose(x, params[name]))           # -> 3x32x32
        return torch.sigmoid(x)

    def apply(self, params, x: torch.Tensor, eps: torch.Tensor):
        """(recon, mu, logvar) of NCHW ``x`` with the noise ``eps`` [B,
        LATENT]."""
        mu, logvar = self.encode(params, x)
        z = eps * torch.exp(0.5 * logvar) + mu
        return self.decode(params, z), mu, logvar

    def param_order(self) -> List[str]:
        return pairs("conv1", "conv2", "conv3", "conv4", "fc1", "fc21", "fc22",
                     "fc3", "tconv1", "tconv2", "tconv3", "tconv4")

    def train_order_block_ids(self) -> List[List[int]]:
        # reference simple_models.py:304-305
        return [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [14, 15], [16, 17],
                [18, 19], [20, 21], [22, 23], [10, 11], [12, 13]]
