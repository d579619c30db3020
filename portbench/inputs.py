"""The general generator: a cell's inputs from its configuration, its
traffic file and ``--seed``.

Everything here is made on the run's device with a seeded
``torch.Generator``, in a few large calls:

* the initial weights of the configuration's model (Xavier-uniform
  kernels, 0.01 linear bias, BatchNorm scale 1 and bias 0: the source's
  ``init_weights``), handed to the program and to the reference alike;
* synthetic CIFAR-10-shaped images: each class has a fixed low-frequency
  template (4x4x3 uniform values in [40, 215] upsampled 8x), an image is
  its class's template plus pixel noise of standard deviation 48, clipped
  to uint8; labels uniform over the classes.  K client shards of the
  traffic's size and one test set.

The program's own seeded streams, which the reference replays, are the
data order of each epoch (one numpy permutation per client a counter) and
the clients' quantizer draws (one torch generator a client a round):
:func:`epoch_rows`, :func:`quant_draws`.

A traffic file (``traffic/<name>.json``) holds only parameters; this one
module reads them all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import resnet

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed from ``--seed`` (any whole number) and ``tags``."""
    words = [int(seed) % (1 << 64), *tags]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


#: derive() tags of the inputs
WEIGHTS, IMAGES, PROGRAM = 1, 2, 3


def program_seed(seed: int) -> int:
    """The data-order seed handed to the program (its ``cfg.seed``)."""
    return derive(seed, PROGRAM) % (1 << 31)


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights, by name, in PyTorch layout on ``device``."""
    shapes = resnet.param_shapes(config["num_blocks"], config["num_classes"])
    kernels = [n for n in shapes if n.endswith("/kernel")]
    sizes = [math.prod(shapes[n]) for n in kernels]
    draw = torch.rand(sum(sizes), generator=generator(seed, WEIGHTS, device),
                      device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    for name, piece in zip(kernels, draw.split(sizes)):
        shape = shapes[name]
        receptive = math.prod(shape[2:])
        bound = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
        out[name] = (piece * bound).reshape(shape)
    for name, shape in shapes.items():
        if name.endswith("/scale"):
            out[name] = torch.ones(shape, device=device)
        elif name == "linear/bias":
            out[name] = torch.full(shape, 0.01, device=device)
        elif name.endswith("/bias"):
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name in shapes}


@dataclass
class Images:
    train_x: torch.Tensor   # [K, n, 32, 32, 3] uint8
    train_y: torch.Tensor   # [K, n] int64
    test_x: torch.Tensor    # [T, 32, 32, 3] uint8
    test_y: torch.Tensor    # [T] int64


def make_images(traffic: dict, seed: int, device) -> Images:
    K, n, T = traffic["K"], traffic["train_images_per_client"], \
        traffic["test_images"]
    g = generator(seed, IMAGES, device)
    coarse = torch.rand((NUM_CLASSES, 4, 4, 3), generator=g,
                        device=device) * 175.0 + 40.0
    templates = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2)
    total = K * n + T
    y = torch.randint(0, NUM_CLASSES, (total,), generator=g, device=device)
    x = templates[y] + torch.randn((total, *IMAGE_SHAPE), generator=g,
                                   device=device) * 48.0
    x = x.clamp_(0.0, 255.0).to(torch.uint8)
    return Images(x[:K * n].reshape(K, n, *IMAGE_SHAPE), y[:K * n].reshape(K, n),
                  x[K * n:], y[K * n:])


def steps_and_remainder(n: int, batch: int):
    """(minibatches an epoch, real rows of the last one; 0: all full)."""
    full, rem = divmod(n, batch)
    return full + (1 if rem else 0), rem


def epoch_rows(prog_seed: int, counter: int, K: int, n: int,
               batch: int) -> np.ndarray:
    """Epoch ``counter``'s [K, steps * batch] row indices into each
    client's shard, as the program draws them: a seed from
    ``default_rng([seed, counter, 0])``, then one ``default_rng`` stream
    giving each client a permutation in client order, the last minibatch
    wrap-padded from the permutation's start."""
    epoch_seed = int(np.random.default_rng(
        [prog_seed, counter, 0]).integers(2**31))
    rng = np.random.default_rng(epoch_seed)
    steps, _ = steps_and_remainder(n, batch)
    m = steps * batch
    out = np.empty((K, m), np.int64)
    for k in range(K):
        perm = rng.permutation(n)
        out[k] = np.concatenate([perm, perm[:m - n]]) if m > n else perm[:m]
    return out


def quant_streams(prog_seed: int, block: int, K: int) -> List[int]:
    """The clients' quantizer stream seeds of a block, as the program
    draws them (a block seed from ``default_rng([seed, 23, block])``, then
    K draws below 2**62)."""
    block_seed = int(np.random.default_rng(
        [prog_seed, 23, block]).integers(2**31))
    return [int(s) for s in np.random.default_rng(block_seed).integers(
        0, 2**62, size=K)]


def quant_draws(streams: List[int], round_index: int, chunks: int,
                chunk: int, device) -> torch.Tensor:
    """[K, chunks, chunk] float32 uniform draws of round ``round_index``:
    client k's generator on ``device`` seeded from its stream and the
    round."""
    out = []
    for s in streams:
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([s, round_index])
                          .generate_state(1, np.uint64)[0] >> np.uint64(1)))
        out.append(torch.rand((chunks, chunk), generator=g, device=device))
    return torch.stack(out)
