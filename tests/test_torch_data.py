"""The port's LOFAR data pipeline (``federated_pytorch_test_tpu_torch/data/lofar.py``)
against the JAX package's: byte-equal arrays (tolerance: none — both are
the same numpy code on the same ``(seed, round, client)``-keyed draws)."""

import numpy as np
import pytest

from federated_pytorch_test_tpu.data import lofar as jlofar
from federated_pytorch_test_tpu_torch.data import lofar as tlofar

FILES = ["L785751.MS_extract.h5", "L785751.MS_extract.h5", "a.h5"]
SAPS = ["1", "2", "0"]


@pytest.mark.parametrize("batch_size,patch_size", [(2, 32), (3, 16)])
def test_round_batches_byte_equal(batch_size, patch_size):
    j = jlofar.CPCDataSource(FILES, SAPS, batch_size=batch_size,
                             patch_size=patch_size, seed=11)
    t = tlofar.CPCDataSource(FILES, SAPS, batch_size=batch_size,
                             patch_size=patch_size, seed=11)
    for clients in (None, [2, 0], None):
        jpx, jpy, jb = j.round_batches(2, clients=clients)
        tpx, tpy, tb = t.round_batches(2, clients=clients)
        assert (jpx, jpy) == (tpx, tpy)
        assert jb.dtype == tb.dtype == np.float32
        assert jb.shape == tb.shape
        assert jb.tobytes() == tb.tobytes()


def test_synthetic_cube_byte_equal_and_cached_cube_read_only():
    jv, js = jlofar._synthetic_cube("dir/L785747.MS_extract.h5", "0")
    tv, ts = tlofar._cached_cube("L785747.MS_extract.h5", "0")
    assert jv.tobytes() == tv.tobytes() and js.tobytes() == ts.tobytes()
    assert not tv.flags.writeable
    # the cache hands back the same arrays; a second minibatch is unchanged
    rng = np.random.default_rng(3)
    a = tlofar.get_data_minibatch("L785747.MS_extract.h5", "0", 2, 32, rng)
    b = jlofar.get_data_minibatch("L785747.MS_extract.h5", "0", 2, 32,
                                  np.random.default_rng(3))
    assert a[:2] == b[:2] and a[2].tobytes() == b[2].tobytes()


def test_prefetcher_equals_direct_calls():
    direct = tlofar.CPCDataSource(FILES[:2], SAPS[:2], batch_size=2, seed=5)
    pre_src = tlofar.CPCDataSource(FILES[:2], SAPS[:2], batch_size=2, seed=5)
    pre = tlofar.RoundPrefetcher(pre_src, niter=2, total_rounds=3)
    try:
        for _ in range(3):
            want = direct.round_batches(2)
            got = pre.get()
            assert want[:2] == got[:2]
            assert want[2].tobytes() == got[2].tobytes()
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_prefetcher_relays_a_producer_failure():
    src = tlofar.CPCDataSource(["a.h5"], ["0"], batch_size=2, seed=5)
    src.round_batches = None          # calling it raises TypeError
    pre = tlofar.RoundPrefetcher(src, niter=1, total_rounds=1)
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            pre.get()
    finally:
        pre.close()
