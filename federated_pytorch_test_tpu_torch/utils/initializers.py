"""Weight initialisation: Xavier-uniform kernels, 0.01 biases.

Mirror of ``federated_pytorch_test_tpu/utils/initializers.py`` (reference
``init_weights``, simple_utils.py:9-14).  The draws come from an explicit
``torch.Generator``, so they differ from the JAX package's ``jax.random``
draws; runs that must start from the JAX weights carry them across with
:mod:`federated_pytorch_test_tpu_torch.bridge`.
"""

from __future__ import annotations

import math

import torch


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """In-place Xavier-uniform on a PyTorch-layout kernel ([O, I, kh, kw]
    or [O, I]): bound sqrt(6 / (fan_in + fan_out)), fans over the receptive
    field — the same bound as ``jax.nn.initializers.xavier_uniform`` on the
    HWIO / [I, O] layout."""
    receptive = math.prod(t.shape[2:])
    fan_in, fan_out = t.shape[1] * receptive, t.shape[0] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    # drawn on the generator's device (the trainer uses a CPU generator, so
    # the initial weights are the same whichever device trains them)
    draw = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    with torch.no_grad():
        t.copy_((draw * 2.0 - 1.0) * bound)
    return t


def init_weights(params: dict, gen: torch.Generator) -> dict:
    """Re-initialise a nested param dict in place of its leaves: every
    ``kernel`` Xavier-uniform, every ``bias`` beside a kernel 0.01.
    Modules are visited in sorted name order."""
    out = {}
    for name in sorted(params):
        leaf = params[name]
        if isinstance(leaf, dict):
            out[name] = init_weights(leaf, gen)
        elif name == "kernel":
            out[name] = xavier_uniform_(torch.empty_like(leaf), gen)
        elif name == "bias" and "kernel" in params:
            out[name] = torch.full_like(leaf, 0.01)
        else:
            out[name] = leaf
    return out
