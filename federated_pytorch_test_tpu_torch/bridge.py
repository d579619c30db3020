"""Carry parameters between the JAX package and the port.

The JAX package keeps flax trees (conv kernels HWIO, dense kernels
[in, out]); the port keeps the same nested dicts with PyTorch-layout tensors
(OIHW, [out, in]).  BatchNorm scales, biases and running statistics are
vectors and cross unchanged.  These helpers take
the JAX side as numpy arrays (``np.asarray`` of ``CPCTrainer.state0``
leaves, or one client's flax dict) and return the port's stacked client
state or loaded modules, and back — so that a test can start both sides
from the same weights.  Flat block vectors need no conversion: the port's
codec keeps the JAX element order.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.models.base import BlockModule, module_state
from federated_pytorch_test_tpu_torch.utils.codec import from_jax_layout, to_jax_layout

SUBMODELS = ("encoder", "contextgen", "predictor")


def _to_torch(a, stacked: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    t = torch.stack([from_jax_layout(r) for r in t]) if stacked else from_jax_layout(t)
    return t.contiguous().to(device)


def _to_numpy(t: torch.Tensor, stacked: bool) -> np.ndarray:
    t = t.detach().cpu()
    t = torch.stack([to_jax_layout(r) for r in t]) if stacked else to_jax_layout(t)
    return t.contiguous().numpy()


def tree_from_jax(tree: Mapping[str, Any], stacked: bool = False,
                  device="cpu") -> dict:
    """Flax param tree (numpy leaves) -> port tree of tensors.  ``stacked``:
    every leaf has a leading client dimension."""
    return {k: tree_from_jax(v, stacked, device) if isinstance(v, Mapping)
            else _to_torch(v, stacked, device) for k, v in tree.items()}


def tree_to_jax(tree: Mapping[str, Any], stacked: bool = False) -> dict:
    """Port tree of tensors -> flax-layout tree of numpy arrays."""
    return {k: tree_to_jax(v, stacked) if isinstance(v, Mapping)
            else _to_numpy(v, stacked) for k, v in tree.items()}


def cpc_state_from_jax(state: Any, device="cpu") -> dict:
    """The JAX ``CPCState`` (stacked [K, ...] leaves; a namedtuple or a
    mapping with encoder/contextgen/predictor) -> the port's stacked state."""
    parts = state._asdict() if hasattr(state, "_asdict") else state
    return {m: tree_from_jax(parts[m], stacked=True, device=device)
            for m in SUBMODELS}


def cpc_state_to_jax(state: Mapping[str, Any]) -> dict:
    """The port's stacked state -> flax-layout numpy trees per sub-model."""
    return {m: tree_to_jax(state[m], stacked=True) for m in SUBMODELS}


def load_module(module: BlockModule, flax_params: Mapping[str, Any]) -> BlockModule:
    """Copy one client's flax params (numpy leaves) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(module_state(tree_from_jax(flax_params,
                                                      device=device)))
    return module



def classifier_state_from_jax(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any],
                              device="cpu") -> tuple:
    """The JAX classifier's stacked ([K, ...]) ``params`` and
    ``batch_stats`` (numpy leaves) -> the port's stacked trees."""
    return (tree_from_jax(params, stacked=True, device=device),
            tree_from_jax(batch_stats, stacked=True, device=device))


def classifier_state_to_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]) -> tuple:
    """The port's stacked classifier trees -> flax-layout numpy trees."""
    return (tree_to_jax(params, stacked=True),
            tree_to_jax(batch_stats, stacked=True))
