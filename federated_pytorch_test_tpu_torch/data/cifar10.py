"""CIFAR-10 federated data pipeline (numpy only).

Port of ``federated_pytorch_test_tpu/data/cifar10.py``, byte for byte on the
arrays it produces:

  * 50,000 training images split into K contiguous shards with
    ``per = ceil(50000 / K)``; ``drop_last_sample`` reproduces the
    reference's exclusive upper bound that drops one sample per shard;
  * per-client normalisation ``(x/255 - m_k) / m_k`` with the biased
    triple ``m_k = (0.5 + k/100, 0.5 - k/100, 0.5)`` under
    ``biased_input`` (the reference biases mean and std alike), applied on
    the device by the trainer;
  * every client evaluates on the whole test set;
  * the last partial minibatch of an epoch is wrap-padded to the batch
    size from the shuffled permutation, and its pad rows carry weight 0.

Data source: the CIFAR-10 python pickle batches (``data_batch_1..5``,
``test_batch``) in ``data_dir`` or ``$CIFAR10_DIR`` if present, else the
JAX package's deterministic synthetic stand-in (class templates plus pixel
noise, same shapes and counts).  Nothing is downloaded.
"""

from __future__ import annotations

import functools
import os
import pickle
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

TRAIN_SIZE = 50000
TEST_SIZE = 10000
NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)


def _load_pickle_batches(dirname: str):
    """Read the standard CIFAR-10 python pickle batches into NHWC uint8."""

    def read(name):
        with open(os.path.join(dirname, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d[b"labels"], dtype=np.int32)
        return x, y

    xs, ys = zip(*(read(f"data_batch_{i}") for i in range(1, 6)))
    xte, yte = read("test_batch")
    return np.concatenate(xs), np.concatenate(ys), xte, yte


@functools.lru_cache(maxsize=4)
def _synthetic_cifar10(seed: int = 0, noise: float = 48.0, prototypes: int = 1):
    """Deterministic CIFAR-10 stand-in: each class gets ``prototypes`` fixed
    low-frequency templates (4x4 random patterns upsampled 8x); a sample is
    a random class prototype plus pixel noise of std ``noise``, clipped to
    uint8.  The arrays are read-only (cached and shared)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(40.0, 215.0, size=(NUM_CLASSES, prototypes, 4, 4, 3))
    templates = np.repeat(np.repeat(coarse, 8, axis=2), 8, axis=3)

    def make(n, rng):
        y = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        proto = rng.integers(0, prototypes, size=n)
        nz = rng.normal(0.0, noise, size=(n,) + IMAGE_SHAPE)
        x = np.clip(templates[y, proto] + nz, 0, 255).astype(np.uint8)
        return x, y

    xtr, ytr = make(TRAIN_SIZE, rng)
    xte, yte = make(TEST_SIZE, rng)
    for a in (xtr, ytr, xte, yte):
        a.setflags(write=False)
    return xtr, ytr, xte, yte


def load_cifar10_arrays(data_dir: Optional[str] = None, synthetic_seed: int = 0,
                        synthetic_noise: float = 48.0,
                        synthetic_prototypes: int = 1):
    """(train_x, train_y, test_x, test_y, source): uint8 NHWC and int32
    arrays from ``data_dir`` or ``$CIFAR10_DIR`` when they hold the pickle
    batches ('disk'), else the synthetic set ('synthetic')."""
    candidates: List[str] = []
    if data_dir:
        candidates.append(data_dir)
    if os.environ.get("CIFAR10_DIR"):
        candidates.append(os.environ["CIFAR10_DIR"])
    for d in candidates:
        if os.path.isfile(os.path.join(d, "data_batch_1")):
            return (*_load_pickle_batches(d), "disk")
    return (*_synthetic_cifar10(synthetic_seed, synthetic_noise,
                                synthetic_prototypes), "synthetic")


def client_means(K: int, biased_input: bool) -> np.ndarray:
    """Per-client normalisation means [K, 3] (federated_multi.py:60-71)."""
    if not biased_input:
        return np.tile(np.float32([0.5, 0.5, 0.5]), (K, 1))
    ks = np.arange(K, dtype=np.float32)
    return np.stack([0.5 + ks / 100.0, 0.5 - ks / 100.0,
                     np.full(K, 0.5, np.float32)], axis=1)


def client_norm_stats(K: int, biased_input: bool) -> np.ndarray:
    """Per-client (mean, std) pairs [K, 2, 3]: the same triple for both."""
    m = client_means(K, biased_input)
    return np.stack([m, m], axis=1)


def shard_indices(K: int, n: int = TRAIN_SIZE,
                  drop_last_sample: bool = True) -> List[np.ndarray]:
    """Contiguous 1/K index ranges (federated_multi.py:52-58)."""
    per = (n + K - 1) // K
    out = []
    for ck in range(K):
        hi = min(per * (ck + 1), n)
        if drop_last_sample:
            hi = min(per * (ck + 1) - 1, n)
        out.append(np.arange(per * ck, hi))
    return out


@dataclass
class FederatedCifar10:
    """K-client CIFAR-10 as dense per-epoch uint8 arrays.

    ``epoch_batches_raw(seed)`` gives ``[K, steps, B, 32, 32, 3]`` uint8,
    ``[K, steps, B]`` int32 labels and float32 pad weights, the rows of
    ``epoch_indices(seed)``;
    ``test_batches_raw()`` the whole test set once, wrap-padded to whole
    batches.  ``steps`` counts the wrap-padded remainder batch.
    """

    K: int = 10
    batch: int = 128
    biased_input: bool = False
    drop_last_sample: bool = True
    include_remainder: bool = True
    data_dir: Optional[str] = None
    synthetic_seed: int = 0
    synthetic_noise: float = 48.0
    synthetic_prototypes: int = 1
    limit_per_client: Optional[int] = None  # cap shard size (tests, smoke runs)
    limit_test: Optional[int] = None        # cap test-set size
    source: str = field(init=False, default="")

    def __post_init__(self):
        xtr, ytr, xte, yte, src = load_cifar10_arrays(
            self.data_dir, self.synthetic_seed, self.synthetic_noise,
            self.synthetic_prototypes)
        self.source = src
        self._norm = client_norm_stats(self.K, self.biased_input)
        idx = shard_indices(self.K, len(xtr), self.drop_last_sample)
        n_min = min(len(i) for i in idx)
        if self.limit_per_client:
            n_min = min(n_min, self.limit_per_client)
        if self.limit_test:
            xte, yte = xte[: self.limit_test], yte[: self.limit_test]
        full = n_min // self.batch
        self.remainder = n_min - full * self.batch if self.include_remainder else 0
        self.steps = full + (1 if self.remainder else 0)
        self._train_x = np.stack([xtr[i[:n_min]] for i in idx])
        self._train_y = np.stack([ytr[i[:n_min]] for i in idx]).astype(np.int32)
        self._test_x = xte
        self._test_y = yte.astype(np.int32)

    @property
    def samples_per_client(self) -> int:
        return self._train_x.shape[1]

    @property
    def norm_stats(self) -> np.ndarray:
        """Per-client (mean, std) [K, 2, 3]."""
        return self._norm

    def train_shards_raw(self, rows: Optional[range] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The raw per-client shards ([K, n, 32, 32, 3] uint8, [K, n]
        int32): what the engine's device-resident path puts on the device
        once (``train/engine.py`` ``_setup_device_data``).  ``rows``: only
        those clients' shards (a process's rows of the client mesh)."""
        if rows is None:
            return self._train_x, self._train_y
        return self._train_x[rows.start:rows.stop], \
            self._train_y[rows.start:rows.stop]

    def epoch_indices(self, seed: int, rows: Optional[range] = None
                      ) -> np.ndarray:
        """One shuffled epoch's ``[K, steps * B]`` int64 row indices into
        each client's shard: client k's permutation from one
        ``default_rng(seed)`` stream, in client order, wrap-padded to whole
        batches.  Both the host gather (:meth:`epoch_batches_raw`) and the
        engine's device gather read these rows.  ``rows``: only those
        clients' indices (the stream still runs over all K, so they do
        not depend on how the clients are spread over processes)."""
        rng = np.random.default_rng(seed)
        n = self.steps * self.batch
        idx = np.empty((self.K, n), np.int64)
        for ck in range(self.K):
            perm = rng.permutation(self.samples_per_client)
            if n > len(perm):                 # wrap-pad the remainder batch
                perm = np.concatenate([perm, perm[: n - len(perm)]])
            idx[ck] = perm[:n]
        return idx if rows is None else idx[rows.start:rows.stop]

    def pad_weights(self, rows: Optional[range] = None) -> np.ndarray:
        """[K, steps, B] float32 (``rows``: those clients' rows): 0 on the
        wrap-pad rows of the last partial minibatch, 1 elsewhere (the same
        every epoch)."""
        n = self.K if rows is None else len(rows)
        w = np.ones((n, self.steps, self.batch), np.float32)
        if self.remainder:
            w[:, -1, self.remainder:] = 0.0
        return w

    def epoch_batches_raw(self, seed: int, rows: Optional[range] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One shuffled epoch: ([K, steps, B, 32, 32, 3] uint8,
        [K, steps, B] int32 labels, [K, steps, B] float32 pad weights);
        ``rows``: only those clients' batches, the same rows of the same
        draw."""
        idx = self.epoch_indices(seed, rows)
        clients = (np.arange(self.K) if rows is None
                   else np.arange(rows.start, rows.stop))[:, None]
        shape = (len(clients), self.steps, self.batch)
        return (self._train_x[clients, idx].reshape(*shape, *IMAGE_SHAPE),
                self._train_y[clients, idx].reshape(shape),
                self.pad_weights(rows))

    def test_batches_raw(self, batch: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The test set once: [tsteps, B, 32, 32, 3] uint8, [tsteps, B]
        labels and float32 weights (wrap-pad rows weighted 0)."""
        b = batch or self.batch
        n_test = len(self._test_x)
        if self.include_remainder:
            tsteps = -(-n_test // b)
            n = tsteps * b
            pad = np.arange(n) % n_test
            w = np.ones(n, np.float32)
            w[n_test:] = 0.0
            return (self._test_x[pad].reshape(tsteps, b, *IMAGE_SHAPE),
                    self._test_y[pad].reshape(tsteps, b),
                    w.reshape(tsteps, b))
        tsteps = n_test // b
        n = tsteps * b
        return (self._test_x[:n].reshape(tsteps, b, *IMAGE_SHAPE),
                self._test_y[:n].reshape(tsteps, b),
                np.ones((tsteps, b), np.float32))
