"""Common interface for blockwise-federated models.

Mirror of ``federated_pytorch_test_tpu/models/base.py``.  Every model
publishes ``param_order()`` (parameter paths in the reference's
``net.parameters()`` order, weight and bias as separate entries) and
``train_order_block_ids()`` (the partition of that order into training
blocks).  Paths keep the JAX names (``"conv2/kernel"``, ``"conv2/bias"``);
the leaves hold PyTorch-layout tensors, and :func:`module_state` maps a
path tree onto the module's ``state_dict`` names for
``torch.func.functional_call``.

The classifier models (``models/simple.py``, ``models/resnet.py``) and
the VAEs (``models/vae.py``, ``models/vae_cl.py``) are functional instead:
they hold no parameters, and ``apply(params, ...)`` runs them on a nested
dict of tensors (a classifier also returns the new BatchNorm statistics),
so that K clients' parameters and running statistics stay separate
tensors.  The helpers below are their layers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from federated_pytorch_test_tpu_torch.utils.initializers import init_tree

elu = F.elu

_TORCH_LEAF = {"kernel": "weight", "bias": "bias"}


class BlockModule(nn.Module):
    """``nn.Module`` with blockwise-federation metadata."""

    def param_order(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def train_order_block_ids(self) -> List[List[int]]:  # pragma: no cover
        raise NotImplementedError

    def linear_layer_ids(self) -> List[int]:
        """Parameter-enumeration ids of the fc weights (reference
        simple_models.py:29-30); the drivers test the *block* index against
        them, a reference quirk kept for parity."""
        return []

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The module's parameters as a nested ``{module: {kernel, bias}}``
        dict (detached), keyed like the JAX package's flax tree."""
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        leaf_of = {v: k for k, v in _TORCH_LEAF.items()}
        for name, p in self.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            tree.setdefault(mod, {})[leaf_of[leaf]] = p.detach()
        return tree


class FunctionalModel(BlockModule):
    """A functional model: no parameters of its own; ``param_shapes()``
    gives the leaves' shapes and ``init_variables`` draws them."""

    def param_shapes(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    def init_variables(self, gen: torch.Generator, init_model: bool = True):
        """(params, batch_stats) on the CPU, from ``gen``."""
        return init_tree(self.param_shapes(), gen, init_model), {}


class Classifier(FunctionalModel):
    """A functional classifier."""

    def __init__(self, num_classes: int = 10,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype

    def head(self, x: torch.Tensor, p) -> torch.Tensor:
        return dense(x.float(), p)


def pairs(*names: str) -> List[str]:
    """Expand module names into kernel/bias path pairs (torch w,b order)."""
    out: List[str] = []
    for n in names:
        out.append(f"{n}/kernel")
        out.append(f"{n}/bias")
    return out


def module_state(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{"conv2/kernel": w}``-style tree -> ``{"conv2.weight": w}`` for
    ``torch.func.functional_call``."""
    return {f"{mod}.{_TORCH_LEAF[leaf]}": t
            for mod, leaves in tree.items() for leaf, t in leaves.items()}


def conv(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
         padding: int = 0, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NCHW convolution with the OIHW ``p["kernel"]`` (and ``p["bias"]`` if
    present), computed in ``dtype`` when given (flax ``nn.Conv(dtype=)``:
    input, kernel and bias cast to it)."""
    w, b = p["kernel"], p.get("bias")
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """flax ``nn.ConvTranspose(out, (4, 4), strides=(2, 2), padding="SAME")``
    on NCHW: doubles H and W.  ``p["kernel"]`` is the flax ``(kh, kw, in,
    out)`` kernel in the port's layout (``codec.from_jax_layout``: [out, in,
    kh, kw]).  flax does not flip the kernel (``transpose_kernel=False``)
    and ``F.conv_transpose2d`` does, so the kernel is flipped here, and
    [in, out, kh, kw] is the layout ``F.conv_transpose2d`` takes."""
    w = p["kernel"].flip(2, 3).transpose(0, 1)
    return F.conv_transpose2d(x, w, p["bias"], stride=2, padding=1)


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor],
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ kernel.T + bias`` with the [out, in] ``p["kernel"]``."""
    w, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.linear(x, w, b)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW activation in the JAX (NHWC) element order, so the
    following dense kernel is the JAX one transposed."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def conv_leaf(cout: int, cin: int, k: int, bias: bool = True) -> Dict[str, Any]:
    """Shapes of one conv layer's leaves (OIHW kernel)."""
    out: Dict[str, Any] = {"kernel": (cout, cin, k, k)}
    if bias:
        out["bias"] = (cout,)
    return out


def dense_leaf(cout: int, cin: int) -> Dict[str, Any]:
    """Shapes of one dense layer's leaves ([out, in] kernel)."""
    return {"kernel": (cout, cin), "bias": (cout,)}
