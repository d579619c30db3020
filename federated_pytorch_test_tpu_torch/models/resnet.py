"""CIFAR ResNet9/18 with ELU activations (functional, NCHW).

Mirror of ``federated_pytorch_test_tpu/models/resnet.py`` (reference
simple_models.py:132-237): 3x3 stem, four stages of BasicBlocks, ELU, 4x4
average pool, linear head; the same parameter names, order and hand-made
blocks.  BatchNorm scale/bias are ordinary parameters; the running
statistics are per-client state that ``apply`` returns, never averaged.

:func:`masked_batch_norm` is the JAX package's ``MaskedBatchNorm``, not
``nn.BatchNorm2d``: the biased batch variance, ``ra = 0.9*ra + 0.1*batch``,
and with per-sample pad weights the statistics exclude the wrap-pad rows.
torch's own BatchNorm would update the running variance with the unbiased
variance and mutate shared buffers.  ``norm="group"`` swaps every
BatchNorm for GroupNorm(32) under the same name (no running statistics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from federated_pytorch_test_tpu_torch.models.base import (
    Classifier,
    conv,
    conv_leaf,
    dense_leaf,
    elu,
)

MOMENTUM = 0.9
EPSILON = 1e-5

_STAGE_PLANES = (64, 128, 256, 512)
_STAGE_STRIDES = (1, 2, 2, 2)


def masked_batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      stats: Dict[str, torch.Tensor], train: bool,
                      w: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm of NCHW ``x`` in float32 -> (y, new running stats).

    Train mode normalises with the batch statistics (over rows with
    ``w > 0`` when pad weights ``w`` [B] are given) and returns the EMA-
    updated running mean and biased variance; eval mode uses the running
    statistics and returns them unchanged."""
    x = x.float()
    if train:
        axes = (0, 2, 3)
        if w is None:
            mean = x.mean(axes)
            mean2 = (x * x).mean(axes)
        else:
            wf = w.float().reshape(-1, 1, 1, 1)
            denom = wf.sum() * (x.shape[2] * x.shape[3])
            mean = (x * wf).sum(axes) / denom
            mean2 = ((x * x) * wf).sum(axes) / denom
        var = mean2 - mean * mean
        new = {"mean": (MOMENTUM * stats["mean"] + (1 - MOMENTUM) * mean).detach(),
               "var": (MOMENTUM * stats["var"] + (1 - MOMENTUM) * var).detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var + EPSILON)[None, :, None, None]
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None], new


def _bn_stats(params: dict) -> dict:
    """Fresh running statistics (mean 0, var 1) for every BatchNorm (a
    leaf dict with a ``scale``) of ``params``."""
    out = {}
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if "scale" in v:
            out[k] = {"mean": torch.zeros_like(v["scale"]),
                      "var": torch.ones_like(v["scale"])}
        elif _bn_stats(v):
            out[k] = _bn_stats(v)
    return out


class ResNet(Classifier):
    """Reference simple_models.py:185-230 (CIFAR stem, ELU, avg pool 4)."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 qualifier: int = 18, num_classes: int = 10,
                 dtype: Optional[torch.dtype] = None, norm: str = "batch"):
        super().__init__(num_classes, dtype)
        if norm not in ("batch", "group"):
            raise ValueError(f"norm={norm!r}: expected 'batch' or 'group'")
        self.num_blocks = tuple(num_blocks)
        self.qualifier = qualifier
        self.norm = norm

    def _units(self):
        """(name, in_planes, planes, stride) of every BasicBlock."""
        in_planes = 64
        for stage, (planes, stride, n) in enumerate(
                zip(_STAGE_PLANES, _STAGE_STRIDES, self.num_blocks), start=1):
            for i, s in enumerate([stride] + [1] * (n - 1)):
                yield f"layer{stage}_{i}", in_planes, planes, s
                in_planes = planes

    def param_shapes(self):
        def bn(c):
            return {"scale": (c,), "bias": (c,)}

        shapes = {"conv1": conv_leaf(64, 3, 3, bias=False), "bn1": bn(64)}
        for name, cin, planes, s in self._units():
            unit = {"conv1": conv_leaf(planes, cin, 3, bias=False),
                    "bn1": bn(planes),
                    "conv2": conv_leaf(planes, planes, 3, bias=False),
                    "bn2": bn(planes)}
            if s != 1 or cin != planes:
                unit["shortcut_conv"] = conv_leaf(planes, cin, 1, bias=False)
                unit["shortcut_bn"] = bn(planes)
            shapes[name] = unit
        shapes["linear"] = dense_leaf(self.num_classes, 512)
        return shapes

    def init_variables(self, gen: torch.Generator, init_model: bool = True):
        params, _ = super().init_variables(gen, init_model)
        return params, ({} if self.norm == "group" else _bn_stats(params))

    def _norm(self, x, p, stats, train, w):
        if self.norm == "group":
            return F.group_norm(x.float(), 32, p["scale"], p["bias"],
                                EPSILON), None
        return masked_batch_norm(x, p, stats, train, w)

    def apply(self, params, batch_stats, x, train: bool = True,
              sample_weight=None):
        """NCHW images -> (logits [B, classes], new batch_stats)."""
        d, w = self.dtype, sample_weight
        new: Dict[str, dict] = {}

        def norm(x, p, bs, key):
            return self._norm(x, p[key], bs[key] if bs else None, train, w)

        out = conv(x, params["conv1"], padding=1, dtype=d)
        out, new["bn1"] = norm(out, params, batch_stats, "bn1")
        out = elu(out)
        for name, cin, planes, s in self._units():
            p = params[name]
            bs = batch_stats.get(name) if batch_stats else None
            unit: Dict[str, dict] = {}
            y = conv(out, p["conv1"], stride=s, padding=1, dtype=d)
            y, unit["bn1"] = norm(y, p, bs, "bn1")
            y = conv(elu(y), p["conv2"], padding=1, dtype=d)
            y, unit["bn2"] = norm(y, p, bs, "bn2")
            if s != 1 or cin != planes:
                sc = conv(out, p["shortcut_conv"], stride=s, dtype=d)
                sc, unit["shortcut_bn"] = norm(sc, p, bs, "shortcut_bn")
            else:
                sc = out
            out = elu(y + sc)
            new[name] = unit
        out = F.avg_pool2d(out, 4).reshape(out.shape[0], -1)
        logits = self.head(out, params["linear"])
        return logits, ({} if self.norm == "group" else new)

    # -- federation metadata ------------------------------------------------
    def param_order(self) -> List[str]:
        """The reference ResNet's ``net.parameters()`` order: per
        BasicBlock conv1, bn1.{scale,bias}, conv2, bn2.{scale,bias}, then
        the projection shortcut's conv and bn if any."""
        order: List[str] = ["conv1/kernel", "bn1/scale", "bn1/bias"]
        for name, cin, planes, s in self._units():
            for j, c in enumerate(("conv1", "conv2"), start=1):
                order += [f"{name}/{c}/kernel", f"{name}/bn{j}/scale",
                          f"{name}/bn{j}/bias"]
            if s != 1 or cin != planes:
                order += [f"{name}/shortcut_conv/kernel",
                          f"{name}/shortcut_bn/scale",
                          f"{name}/shortcut_bn/bias"]
        return order + ["linear/kernel", "linear/bias"]

    def train_order_block_ids(self) -> List[List[int]]:
        # reference simple_models.py:222-226 — hand-made partitions
        if self.qualifier == 18:
            return [[0, 2], [3, 8], [9, 14], [15, 23], [24, 29], [30, 38],
                    [39, 44], [45, 53], [54, 59], [60, 61]]
        return [[0, 2], [3, 8], [9, 14], [15, 17], [18, 23], [24, 29],
                [30, 32], [33, 37]]


def ResNet18(dtype=None, norm: str = "batch") -> ResNet:
    """Reference simple_models.py:233-234."""
    return ResNet(num_blocks=(2, 2, 2, 2), qualifier=18, dtype=dtype, norm=norm)


def ResNet9(dtype=None, norm: str = "batch") -> ResNet:
    """Reference simple_models.py:236-237."""
    return ResNet(num_blocks=(1, 1, 1, 1), qualifier=9, dtype=dtype, norm=norm)
