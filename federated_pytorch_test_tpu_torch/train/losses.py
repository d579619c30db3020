"""Classifier losses.

Port of ``federated_pytorch_test_tpu/train/losses.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy; with 0/1 ``weights`` (the pad rows of
    the last partial minibatch) the mean over the real rows."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def l1_l2(x: torch.Tensor, lambda1: float, lambda2: float) -> torch.Tensor:
    """``lambda1 ||x||_1 + lambda2 ||x||_2^2`` on the flat trainable vector
    (federated_multi.py:183-186)."""
    return lambda1 * x.abs().sum() + lambda2 * torch.dot(x, x)


def accuracy_count(logits: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of correct top-1 predictions; pad rows (weight 0) excluded."""
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if weights is None:
        return correct.sum()
    return (correct * weights).sum()
