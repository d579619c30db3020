"""The engine's throughput knobs held against the port itself.

Each knob changes when the host launches work, never what is computed, so
the port with a knob on ends bit for bit where it ends with the knob off:
``device_data`` (the shards on the device, each epoch a gather by the row
indices the host path gathers), ``overlap_staging``, ``overlap_round`` and
``fused_rounds`` (one host call a round), at K=4 over two blocks with two
local epochs a round; the fused round with the q8 fused collective at D=2;
the round overlap with the chunked krum at D=2 (the VAE-CL run is in
``test_torch_knobs_vae.py``).  ``sharded_update`` runs the
reduce-scatter of the shard sums, the divide on the owned segment and the
all-gather: it is held within ``rtol=2e-5``, ``atol=1e-6`` (the JAX
package's declared band) and is bitwise here, each coordinate being the
replicated mean's ordered sum and division.  A run killed after a mid-block round and resumed with the
knob flipped ends bit for bit where the uninterrupted run does.  Every run
pins one torch thread (``torch_threads``), so that two runs in one
process sum alike.
"""

import numpy as np
import pytest
import torch
from _torch_engine_pair import torch_threads

from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.parallel.comm import (
    sharded_federated_mean,
)
from federated_pytorch_test_tpu_torch.train import algorithms as alg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves

K = 4
DATA = dict(K=K, batch=16, limit_per_client=40, limit_test=32,
            biased_input=True)
BASE = dict(device="cpu", K=K, Nloop=1, Nepoch=2, Nadmm=2, default_batch=16,
            check_results=False, admm_rho0=0.1, biased_input=True,
            obs_sinks="none")
SILENT = lambda m: None


class Killed(Exception):
    pass


def run(algo=alg.AdmmConsensus, blocks=2, trainer=BlockwiseFederatedTrainer,
        model=Net, log=SILENT, checkpoint_path=None, resume=False, data=None,
        **kw):
    cfg = FederatedConfig(**dict(BASE, **kw))
    t = trainer(model(), cfg, FederatedCifar10(**(data or DATA)), algo())
    t.L = blocks
    with torch_threads(1):
        state, hist = t.run(log=log, checkpoint_path=checkpoint_path,
                            resume=resume)
    return t, state, hist


def assert_same(a, b):
    """Equal bit for bit: every parameter, statistic and round loss."""
    (_, sa, ha), (_, sb, hb) = a, b
    for x, y in zip(leaves((sa.params, sa.batch_stats)),
                    leaves((sb.params, sb.batch_stats))):
        assert torch.equal(x, y)
    assert [r["loss"] for r in ha] == [r["loss"] for r in hb]
    for k in ("dual_residual", "primal_residual"):
        assert [r.get(k) for r in ha] == [r.get(k) for r in hb]


@pytest.fixture(scope="module")
def off():
    return run(device_data=False)


KNOBS = {
    "device_data": dict(device_data=True),
    "overlap_staging": dict(device_data=False, overlap_staging=True),
    "overlap_staging_device": dict(device_data=True, overlap_staging=True),
    "overlap_round": dict(device_data=False, overlap_round=True),
    "fused_rounds": dict(device_data=True, fused_rounds=True),
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_knob_on_is_knob_off_bit_for_bit(off, name):
    on = run(**KNOBS[name])
    assert_same(off, on)
    t, _, hist = on
    assert len(hist) == 4
    want = 1 if name == "fused_rounds" else 2
    assert [r["host_dispatches"] for r in hist] == [want] * 4
    assert [r["host_dispatches"] for r in off[2]] == [2] * 4
    assert (t._dev_x is not None) == KNOBS[name]["device_data"]
    if name.startswith("overlap_staging"):
        # the look-ahead staged an epoch behind every comm step but the
        # run's last
        assert [r["overlap_seconds"] > 0 for r in hist] == [True] * 3 + [False]
    if name == "overlap_round":
        # the next round's first epoch is launched behind the comm step of
        # every round but the last of each block
        assert [r["overlap_dispatch_seconds"] > 0 for r in hist] == \
            [True, False, True, False]
    if name == "fused_rounds":
        assert all(r["comm_seconds"] == 0.0 for r in hist)


def test_fused_rounds_with_the_q8_fused_collective():
    kw = dict(compress="q8", fused_collective=True, num_devices=2)
    a = run(device_data=False, **kw)
    b = run(device_data=True, fused_rounds=True, **kw)
    assert_same(a, b)
    for ra, rb in zip(a[2], b[2]):
        assert ra["bytes_fused"] == rb["bytes_fused"] > 0
        assert (ra["host_dispatches"], rb["host_dispatches"]) == (2, 1)


def test_overlap_round_with_the_chunked_krum():
    kw = dict(robust_agg="krum", robust_chunked=True, num_devices=2,
              Nepoch=1, Nadmm=3)
    a = run(**kw)
    b = run(overlap_round=True, overlap_staging=True, **kw)
    assert_same(a, b)
    assert [r["overlap_dispatch_seconds"] > 0 for r in b[2]] == \
        [True, True, False] * 2


def test_sharded_update_within_the_declared_band():
    a = run(num_devices=2, Nepoch=1)
    b = run(num_devices=2, Nepoch=1, sharded_update=True)
    for x, y in zip(leaves(a[1].params), leaves(b[1].params)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-5,
                                   atol=1e-6)
    # each coordinate is the replicated mean's ordered sum and division
    assert b[0].mean_fn.func is sharded_federated_mean
    assert a[0].mean_fn is None
    assert_same(a, b)


def _kill_after(n_rounds: int):
    """A log that raises after the n-th round's line (the round's
    mid-run checkpoint is on disk by then)."""
    seen = []

    def log(msg):
        if msg.startswith("block="):
            seen.append(msg)
            if len(seen) == n_rounds:
                raise Killed(msg)
    return log


@pytest.mark.parametrize("first,second", [
    (dict(device_data=True, fused_rounds=True), dict(device_data=False)),
    (dict(device_data=False), dict(device_data=True, fused_rounds=True)),
    (dict(overlap_round=True, overlap_staging=True), dict(device_data=False)),
])
def test_kill_and_resume_across_the_knob(off, tmp_path, first, second):
    """Killed after round 3 (mid-block 1; with overlap_round the next
    round's first epoch is already launched), resumed with the knob
    flipped: bit for bit the uninterrupted run."""
    ck = str(tmp_path / "ck")
    with pytest.raises(Killed):
        run(checkpoint_path=ck, log=_kill_after(3), **first)
    resumed = run(checkpoint_path=ck, resume=True, **second)
    t, state, hist = resumed
    assert len(hist) == 4
    assert_same(off, resumed)
