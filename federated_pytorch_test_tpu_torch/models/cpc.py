"""CPC models for LOFAR visibility patches (arXiv:1905.09272).

Mirror of ``federated_pytorch_test_tpu/models/cpc.py`` in NCHW:

  * ``EncoderCNN``    — 8-channel input (4 pol x re/im), 5 parallel dilated
    4x4 stride-2 convs (dilation 1, 2, 4, 8, 16) concatenated, 3 strided
    convs to ``latent_dim``, 2x2 average pool;
  * ``ContextgenCNN`` — four bias-free convs, latents -> context, shape
    preserving (the 2x2 conv padded by 1 gives px+1, the next VALID 2x2
    brings it back to px);
  * ``PredictorCNN``  — two bias-free 1x1 convs projecting latents and
    context to ``reduced_dim``.

The JAX encoder lowers its dilated convs through ``TapConv`` (an im2col
workaround for XLA:TPU); here they are plain ``nn.Conv2d(dilation=d)``,
held against ``dilated_conv_taps`` in the tests.  Parameter names, order
and blocks are the JAX package's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from federated_pytorch_test_tpu_torch.models.base import BlockModule, elu, pairs

#: (dilation, padding) of the encoder's five parallel stem convs
STEM = ((1, 1), (2, 3), (4, 6), (8, 12), (16, 24))


class EncoderCNN(BlockModule):
    def __init__(self, latent_dim: int = 1024):
        super().__init__()
        self.latent_dim = latent_dim
        for d, p in STEM:
            self.add_module(f"conv1_{d}", nn.Conv2d(
                8, 8, 4, stride=2, dilation=d, padding=p))
        self.conv2 = nn.Conv2d(8 * len(STEM), latent_dim // 4, 4, stride=2,
                               padding=1)
        self.conv3 = nn.Conv2d(latent_dim // 4, latent_dim // 2, 4, stride=2,
                               padding=1)
        self.conv4 = nn.Conv2d(latent_dim // 2, latent_dim, 4, stride=2,
                               padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 8, 32, 32] -> [B, latent_dim]."""
        x = torch.cat([elu(getattr(self, f"conv1_{d}")(x)) for d, _ in STEM],
                      dim=1)                       # [B, 40, 16, 16]
        x = elu(self.conv2(x))                      # 8x8
        x = elu(self.conv3(x))                      # 4x4
        x = elu(self.conv4(x))                      # 2x2
        x = F.avg_pool2d(x, 2)                      # 1x1
        return x.reshape(x.shape[0], -1)

    def param_order(self) -> List[str]:
        return pairs(*(f"conv1_{d}" for d, _ in STEM), "conv2", "conv3",
                     "conv4")

    def train_order_block_ids(self) -> List[List[int]]:
        return [[0, 9], [10, 15]]


class ContextgenCNN(BlockModule):
    def __init__(self, latent_dim: int = 1024):
        super().__init__()
        L = latent_dim
        self.conv1 = nn.Conv2d(L, L // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(L // 4, L // 4, 2, padding=1, bias=False)
        self.conv3 = nn.Conv2d(L // 4, L // 2, 2, bias=False)
        self.conv4 = nn.Conv2d(L // 2, L, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, latent_dim, px, py] -> same shape."""
        x = elu(self.conv1(x))
        x = elu(self.conv2(x))                      # px+1
        x = elu(self.conv3(x))                      # px
        return elu(self.conv4(x))

    def param_order(self) -> List[str]:
        return ["conv1/kernel", "conv2/kernel", "conv3/kernel", "conv4/kernel"]

    def train_order_block_ids(self) -> List[List[int]]:
        return [[0, 3]]


class PredictorCNN(BlockModule):
    def __init__(self, latent_dim: int = 1024, reduced_dim: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(latent_dim, reduced_dim, 1, bias=False)
        self.conv2 = nn.Conv2d(latent_dim, reduced_dim, 1, bias=False)

    def forward(self, latents: torch.Tensor, context: torch.Tensor):
        """[B, latent, px, py] x2 -> ([B, reduced, px, py] x2)."""
        return self.conv1(latents), self.conv2(context)

    def param_order(self) -> List[str]:
        return ["conv1/kernel", "conv2/kernel"]

    def train_order_block_ids(self) -> List[List[int]]:
        return [[0, 1]]
