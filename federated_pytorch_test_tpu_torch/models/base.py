"""Common interface for blockwise-federated models.

Mirror of ``federated_pytorch_test_tpu/models/base.py``.  Every model
publishes ``param_order()`` (parameter paths in the reference's
``net.parameters()`` order, weight and bias as separate entries) and
``train_order_block_ids()`` (the partition of that order into training
blocks).  Paths keep the JAX names (``"conv2/kernel"``, ``"conv2/bias"``);
the leaves hold PyTorch-layout tensors, and :func:`module_state` maps a
path tree onto the module's ``state_dict`` names for
``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

elu = F.elu

_TORCH_LEAF = {"kernel": "weight", "bias": "bias"}


class BlockModule(nn.Module):
    """``nn.Module`` with blockwise-federation metadata."""

    def param_order(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def train_order_block_ids(self) -> List[List[int]]:  # pragma: no cover
        raise NotImplementedError

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The module's parameters as a nested ``{module: {kernel, bias}}``
        dict (detached), keyed like the JAX package's flax tree."""
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        leaf_of = {v: k for k, v in _TORCH_LEAF.items()}
        for name, p in self.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            tree.setdefault(mod, {})[leaf_of[leaf]] = p.detach()
        return tree


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
