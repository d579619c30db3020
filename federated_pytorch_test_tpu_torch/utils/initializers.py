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


def lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """In-place flax default kernel init (``lecun_normal``): a normal
    truncated to [-2, 2] standard deviations, scaled to variance 1/fan_in
    (fan_in over the receptive field: I*kh*kw of an OIHW kernel, I of an
    [O, I] dense kernel)."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(t.shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
    with torch.no_grad():
        t.copy_(draw * std)
    return t


def init_tree(shapes: dict, gen: torch.Generator, init_model: bool = True) -> dict:
    """Parameters from a nested dict of leaf shapes: the flax defaults
    (kernels ``lecun_normal``, biases 0, norm scales 1), then, with
    ``init_model`` (the reference's ``init_weights``), Xavier-uniform
    kernels and 0.01 biases beside every kernel."""
    def build(node):
        out = {}
        for name in sorted(node):
            v = node[name]
            if isinstance(v, dict):
                out[name] = build(v)
            elif name == "kernel":
                t = torch.empty(v, dtype=torch.float32)
                out[name] = t if init_model else lecun_normal_(t, gen)
            elif name == "scale":
                out[name] = torch.ones(v, dtype=torch.float32)
            else:
                out[name] = torch.zeros(v, dtype=torch.float32)
        return out

    params = build(shapes)
    return init_weights(params, gen) if init_model else params
