"""Client aggregation over a stacked client dimension.

Port of the dense FedAvg mean of ``federated_pytorch_test_tpu/parallel/comm.py``.
On one card the K clients are the leading dimension of one tensor, so the
JAX ``psum`` over the client mesh axis becomes a sum over that dimension.
"""

from __future__ import annotations

import torch


def federated_mean(stack: torch.Tensor, K: int) -> torch.Tensor:
    """``z = sum_k x_k / K`` over the leading [K, ...] client dimension —
    the FedAvg global update (reference federated_multi.py:208-211)."""
    return torch.sum(stack, dim=0) / K
