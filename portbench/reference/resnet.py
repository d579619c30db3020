"""The CIFAR ResNet9/18 of the source, in plain PyTorch, on a flat dict of
named tensors.

Source: SarodYatawatta/federated-pytorch-test ``src/simple_models.py``
(``BasicBlock``, ``ResNet``, ``ResNet18``, ``ResNet9``): a 3x3 stem of 64
channels, four stages of BasicBlocks at widths 64/128/256/512 (strides
1, 2, 2, 2), ELU activations, a 4x4 average pool and a linear head.  A
BasicBlock is ``elu(bn2(conv2(elu(bn1(conv1(x))))) + shortcut(x))``; the
shortcut is a 1x1 convolution and a BatchNorm where the stride or the width
changes, else the identity.  No convolution has a bias.

Names: ``conv1/kernel``, ``bn1/scale``, ``bn1/bias``, ``layer<s>_<i>/...``,
``linear/kernel``, ``linear/bias``: the source's module names
(``layer1.0.conv1.weight`` is ``layer1_0/conv1/kernel``), in the source's
``net.parameters()`` order, kernels in PyTorch layout (OIHW, [out, in]).

Departures from ``torch.nn.BatchNorm2d``, kept because the configuration
states them (the federated drivers carry each client's statistics as its
state): the running variance is updated with the biased batch variance,
``ra = 0.9 ra + 0.1 batch``; the batch variance is ``E[x^2] - E[x]^2``, the
configuration's (flax-derived) BatchNorm formula, whose float32 rounding
differs from a two-pass variance by up to ``2^-24 mean^2 / var`` relative
where a channel's mean dwarfs its spread; and a batch may carry per-row
weights, 0 on the wrap-padding rows of an epoch's last partial minibatch,
which are then left out of the batch statistics.

Imports torch only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

STAGE_PLANES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 2, 2)
STEM_PLANES = 64
MOMENTUM = 0.9
EPSILON = 1e-5


def units(num_blocks: Sequence[int]) -> Iterator[Tuple[str, int, int, int]]:
    """(name, in_planes, planes, stride) of every BasicBlock."""
    cin = STEM_PLANES
    for stage, (planes, stride, n) in enumerate(
            zip(STAGE_PLANES, STAGE_STRIDES, num_blocks), start=1):
        for i in range(n):
            yield f"layer{stage}_{i}", cin, planes, stride if i == 0 else 1
            cin = planes


def has_shortcut(cin: int, planes: int, stride: int) -> bool:
    return stride != 1 or cin != planes


def param_shapes(num_blocks: Sequence[int], num_classes: int = 10
                 ) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every parameter's shape, in the source's parameter order."""
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def conv_bn(prefix: str, cout: int, cin: int, k: int, bn: str) -> None:
        out[f"{prefix}/kernel"] = (cout, cin, k, k)
        out[f"{bn}/scale"] = (cout,)
        out[f"{bn}/bias"] = (cout,)

    conv_bn("conv1", STEM_PLANES, 3, 3, "bn1")
    for name, cin, planes, s in units(num_blocks):
        conv_bn(f"{name}/conv1", planes, cin, 3, f"{name}/bn1")
        conv_bn(f"{name}/conv2", planes, planes, 3, f"{name}/bn2")
        if has_shortcut(cin, planes, s):
            conv_bn(f"{name}/shortcut_conv", planes, cin, 1,
                    f"{name}/shortcut_bn")
    out["linear/kernel"] = (num_classes, STAGE_PLANES[-1])
    out["linear/bias"] = (num_classes,)
    return out


def bn_names(num_blocks: Sequence[int]) -> List[str]:
    """The BatchNorms' names, in forward order."""
    names = ["bn1"]
    for name, cin, planes, s in units(num_blocks):
        names += [f"{name}/bn1", f"{name}/bn2"]
        if has_shortcut(cin, planes, s):
            names.append(f"{name}/shortcut_bn")
    return names


def init_stats(num_blocks: Sequence[int], device=None) -> Dict[str, torch.Tensor]:
    """Fresh running statistics: ``<bn>/mean`` 0 and ``<bn>/var`` 1."""
    shapes = param_shapes(num_blocks)
    out = {}
    for bn in bn_names(num_blocks):
        c = shapes[f"{bn}/scale"][0]
        out[f"{bn}/mean"] = torch.zeros(c, device=device)
        out[f"{bn}/var"] = torch.ones(c, device=device)
    return out


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean_r: torch.Tensor, var_r: torch.Tensor, train: bool,
               w: Optional[torch.Tensor]):
    """(y, new running mean, new running var) of NCHW ``x``; ``w`` [B]
    row weights (None: every row counts)."""
    if train:
        if w is None:
            mean = x.mean((0, 2, 3))
            mean2 = (x * x).mean((0, 2, 3))
        else:
            wf = w.reshape(-1, 1, 1, 1)
            count = w.sum() * (x.shape[2] * x.shape[3])
            mean = (x * wf).sum((0, 2, 3)) / count
            mean2 = (x * x * wf).sum((0, 2, 3)) / count
        var = mean2 - mean * mean
        new_mean = (MOMENTUM * mean_r + (1 - MOMENTUM) * mean).detach()
        new_var = (MOMENTUM * var_r + (1 - MOMENTUM) * var).detach()
    else:
        mean, var, new_mean, new_var = mean_r, var_r, mean_r, var_r
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var[None, :, None, None] + EPSILON)
    return (y * scale[None, :, None, None] + bias[None, :, None, None],
            new_mean, new_var)


def forward(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            x: torch.Tensor, num_blocks: Sequence[int], train: bool = True,
            w: Optional[torch.Tensor] = None):
    """NCHW float32 images -> (logits, new running statistics)."""
    new: Dict[str, torch.Tensor] = {}

    def bn(t: torch.Tensor, name: str) -> torch.Tensor:
        y, new[f"{name}/mean"], new[f"{name}/var"] = batch_norm(
            t, params[f"{name}/scale"], params[f"{name}/bias"],
            stats[f"{name}/mean"], stats[f"{name}/var"], train, w)
        return y

    out = F.elu(bn(F.conv2d(x, params["conv1/kernel"], padding=1), "bn1"))
    for name, cin, planes, s in units(num_blocks):
        y = F.elu(bn(F.conv2d(out, params[f"{name}/conv1/kernel"], stride=s,
                              padding=1), f"{name}/bn1"))
        y = bn(F.conv2d(y, params[f"{name}/conv2/kernel"], padding=1),
               f"{name}/bn2")
        if has_shortcut(cin, planes, s):
            sc = bn(F.conv2d(out, params[f"{name}/shortcut_conv/kernel"],
                             stride=s), f"{name}/shortcut_bn")
        else:
            sc = out
        out = F.elu(y + sc)
    out = F.avg_pool2d(out, 4).flatten(1)
    return F.linear(out, params["linear/kernel"], params["linear/bias"]), new
