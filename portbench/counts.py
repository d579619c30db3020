"""Operations and bytes from shapes, and the card's peaks: the yardstick
of ``step_mfu`` and ``quant_roofline``.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the
tensor cores.  The float32 rate is the peak of a float32 run with TF32 off,
as every configuration here states.

ResNet9/18 FLOPs count the convolutions and the linear head only, two per
multiply-add: batch norm, ELU, pooling and the loss are elementwise and
left out (``torch.utils.flop_counter.FlopCounterMode`` counts the same
operations, which the tests hold it to).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, List, Sequence, Tuple

from portbench.reference import resnet

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


@dataclass(frozen=True)
class Layer:
    """A convolution or the linear layer of the forward pass."""

    name: str
    macs: int                 # multiply-adds of one image
    weight: int               # the parameter id of its kernel
    upstream: FrozenSet[int]  # parameter ids its input depends on


def layers(num_blocks: Sequence[int], image: int = 32,
           num_classes: int = 10) -> List[Layer]:
    """The convolutions and the linear head of one image's forward pass,
    each with the parameters (by id in the source's order) that its input
    depends on."""
    ids = {n: i for i, n in enumerate(resnet.param_shapes(num_blocks,
                                                          num_classes))}
    out: List[Layer] = []

    def conv(name: str, cin: int, cout: int, k: int, size: int,
             up: FrozenSet[int], bn: str) -> FrozenSet[int]:
        # one image: cout * size^2 outputs, each cin * k^2 multiply-adds
        out.append(Layer(name, cout * size * size * cin * k * k,
                         ids[f"{name}/kernel"], up))
        return up | {ids[f"{name}/kernel"], ids[f"{bn}/scale"],
                     ids[f"{bn}/bias"]}

    size = image
    x = conv("conv1", 3, resnet.STEM_PLANES, 3, size, frozenset(), "bn1")
    for name, cin, planes, s in resnet.units(num_blocks):
        size_out = size // s
        y = conv(f"{name}/conv1", cin, planes, 3, size_out, x, f"{name}/bn1")
        y = conv(f"{name}/conv2", planes, planes, 3, size_out, y,
                 f"{name}/bn2")
        if resnet.has_shortcut(cin, planes, s):
            y = y | conv(f"{name}/shortcut_conv", cin, planes, 1, size_out,
                         x, f"{name}/shortcut_bn")
        else:
            y = y | x
        x, size = y, size_out
    out.append(Layer("linear", resnet.STAGE_PLANES[-1] * num_classes,
                     ids["linear/kernel"], x))
    return out


def step_flops(num_blocks: Sequence[int], block: Tuple[int, int],
               num_classes: int = 10) -> Tuple[int, int]:
    """(forward, backward) FLOPs of one image in a local step that trains
    the parameters ``block`` (an inclusive id range).  Forward: every
    layer once.  Backward, nothing recomputed: the gradient with respect
    to a layer's input wherever that input depends on a trained parameter
    (the layers above the block, and those inside it above its first
    layer), and the gradient of a layer's kernel where the kernel trains.
    Each is a product of the forward's size."""
    trained = frozenset(range(block[0], block[1] + 1))
    fwd = bwd = 0
    for layer in layers(num_blocks, num_classes=num_classes):
        fwd += 2 * layer.macs
        if layer.upstream & trained:
            bwd += 2 * layer.macs
        if layer.weight in trained:
            bwd += 2 * layer.macs
    return fwd, bwd


def quant_bound(kernel: str, c: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel B1 (``quantize_rows``) or B2
    (``dequant_add``) on [c, w] rows, each input read once and each output
    written once.  B1 reads v (float32) and writes q (int8) and the c
    scales; per element abs, max, divide, round and two clamps.  B2 reads
    acc (float32), q (int8) and the scales and writes out (float32); per
    element a multiply and an add."""
    if kernel == "quantize_rows":
        return c * w * 4 + c * w + c * 4, 6 * c * w
    if kernel == "dequant_add":
        return c * w * 4 + c * w + c * 4 + c * w * 4, 2 * c * w
    raise ValueError(f"no bound for kernel {kernel!r}")


def least_seconds(nbytes: int, flops: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
