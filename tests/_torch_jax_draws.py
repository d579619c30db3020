"""Hand the JAX package's random draws to the port: the quantizer's and
the VAE trainers' reparametrisation noise.

The JAX ``StochasticQuantizer`` draws ``jax.random.uniform`` from a
per-client key that is split every round; the port's draws its own stream
from ``(seed, count)``.  :func:`replay` builds a ``uniform`` function for
the port's quantizer (its test seam) that returns, for the client whose
port seed is ``seeds[k]``, the JAX draw of the client whose raw key is
``keys[k]`` at round ``count``.  :func:`replay_noise` does the same for
the trainers' ``normal`` seam.
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


def jax_epoch_key(seed: int, counter: int, K: int, k: int):
    """Client ``k``'s key of epoch ``counter`` in the JAX engine:
    ``split(PRNGKey(_epoch_seed(counter, 1)), K)[k]``."""
    s = int(np.random.default_rng([seed, counter, 1]).integers(2**31))
    return jax.random.split(jax.random.PRNGKey(s), K)[k]


def replay_noise(K: int, eval_words=(0,)):
    """``normal(words, shape, device)`` for the port's trainers (their
    ``normal`` seam) that returns the JAX engine's reparametrisation draw:
    for the words ``(seed, counter, k, step)`` the draw of
    ``fold_in(jax_epoch_key(seed, counter, K, k), step)``, for
    ``eval_words`` the draw of ``PRNGKey(0)``.  A shape [Kc, B, L] is
    VAE-CL's: cluster j draws from ``split(key, Kc)[j]``."""
    def normal(words, shape, device):
        words = tuple(int(w) for w in words)
        if words == tuple(eval_words):
            key = jax.random.PRNGKey(0)
        else:
            seed, counter, k, step = words
            key = jax.random.fold_in(jax_epoch_key(seed, counter, K, k), step)
        if len(shape) == 3:
            eps = np.stack([np.array(jax.random.normal(kj, tuple(shape[1:])))
                            for kj in jax.random.split(key, shape[0])])
        else:
            eps = np.array(jax.random.normal(key, tuple(shape)))
        return torch.from_numpy(eps).to(device)

    return normal
