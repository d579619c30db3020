"""The port's CIFAR-10 pipeline (``data/cifar10.py``) against the JAX
package's: every array byte-equal (integers and the same float32 ops on
the same inputs)."""

import numpy as np
import pytest

from federated_pytorch_test_tpu.data import cifar10 as jdata
from federated_pytorch_test_tpu.train.engine import (
    BlockwiseFederatedTrainer as JTrainer,
)
from federated_pytorch_test_tpu_torch.data import cifar10 as tdata
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,prototypes", [(0, 1), (3, 4)])
def test_synthetic_set_byte_equal(seed, prototypes):
    for a, b in zip(jdata._synthetic_cifar10(seed, 48.0, prototypes),
                    tdata._synthetic_cifar10(seed, 48.0, prototypes)):
        _equal(a, b)


@pytest.mark.parametrize("K,biased", [(1, False), (4, True), (10, True),
                                      (10, False)])
def test_client_stats_byte_equal(K, biased):
    _equal(jdata.client_means(K, biased), tdata.client_means(K, biased))
    _equal(jdata.client_norm_stats(K, biased),
           tdata.client_norm_stats(K, biased))


@pytest.mark.parametrize("K,drop", [(3, True), (10, True), (7, False)])
def test_shard_indices_equal(K, drop):
    for a, b in zip(jdata.shard_indices(K, drop_last_sample=drop),
                    tdata.shard_indices(K, drop_last_sample=drop)):
        _equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(K=4, batch=16, limit_per_client=40, limit_test=50, biased_input=True),
    dict(K=3, batch=8, limit_per_client=32, limit_test=17),
    dict(K=2, batch=16, limit_per_client=40, include_remainder=False,
         limit_test=40),
])
def test_federated_arrays_byte_equal(kw):
    j, t = jdata.FederatedCifar10(**kw), tdata.FederatedCifar10(**kw)
    assert (j.steps, j.remainder, j.samples_per_client, j.source) == (
        t.steps, t.remainder, t.samples_per_client, t.source)
    _equal(j.norm_stats, t.norm_stats)
    for seed in (0, 12345):
        for a, b in zip(j.epoch_batches_raw(seed), t.epoch_batches_raw(seed)):
            _equal(a, b)
    for a, b in zip(j.test_batches_raw(), t.test_batches_raw()):
        _equal(a, b)


def test_pad_weights_mark_the_remainder():
    t = tdata.FederatedCifar10(K=2, batch=16, limit_per_client=40, limit_test=8)
    _, _, w = t.epoch_batches_raw(0)
    assert t.steps == 3 and t.remainder == 8
    assert w[:, :2].all() and w[:, 2, :8].all() and not w[:, 2, 8:].any()


def test_epoch_seed_matches_jax_engine():
    cfg = FederatedConfig(seed=69)
    port = TTrainer.__new__(TTrainer)
    port.cfg = cfg
    jax_side = JTrainer.__new__(JTrainer)
    jax_side.cfg = cfg
    for c in (0, 1, 7, 1000):
        for stream in (0, 1):
            assert port._epoch_seed(c, stream) == jax_side._epoch_seed(c, stream)


def test_missing_data_dir_falls_back_to_synthetic(tmp_path):
    *_, src = tdata.load_cifar10_arrays(str(tmp_path))
    assert src == "synthetic"
