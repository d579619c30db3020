"""Hand the JAX package's quantizer draws to the port's quantizer.

The JAX ``StochasticQuantizer`` draws ``jax.random.uniform`` from a
per-client key that is split every round; the port's draws its own stream
from ``(seed, count)``.  :func:`replay` builds a ``uniform`` function for
the port's quantizer (its test seam) that returns, for the client whose
port seed is ``seeds[k]``, the JAX draw of the client whose raw key is
``keys[k]`` at round ``count``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def replay(seeds, keys):
    """``uniform(seed, count, shape, device)`` replaying the JAX stream of
    ``keys[k]`` (raw uint32[2] key data) for the port's ``seeds[k]``."""
    table = {int(s): np.asarray(k, np.uint32) for s, k in zip(seeds, keys)}

    def uniform(seed, count, shape, device):
        key = jnp.asarray(table[int(seed)], jnp.uint32)
        for _ in range(count + 1):
            key, sub = jax.random.split(key)
        u = np.array(jax.random.uniform(sub, tuple(shape)))
        return torch.from_numpy(u).to(device)

    return uniform


def jax_block_keys(seed: int, K: int):
    """The raw keys the JAX package's ``stacked_init`` gives K clients."""
    return np.asarray(jax.random.key_data(
        jax.random.split(jax.random.PRNGKey(seed), K)))
