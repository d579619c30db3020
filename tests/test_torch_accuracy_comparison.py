"""The port's ``accuracy_comparison`` against the JAX driver's, at a toy
size: K=2, Nloop=1, Nadmm=1, batch 16, 32 training images per client, 32
test images, the synthetic multi-prototype data (noise 48, 32 prototypes
a class).  Each of the four runs (standalone, FedAvg, consensus, the K=1
upper bound) starts from the weights of the JAX run's trainer, carried
across with ``bridge.py``; everything else is each side's own.  The JAX
side pins ``device_data=False``: its device-resident shards are shuffled
by ``jax.random``, which the port's host shuffle cannot replay.

Tolerance: every point of every curve (a mean over the clients of the
test accuracy) within one test image of the JAX curve, 100 / 32 points.
Measured: equal.
"""

import functools
import json

import jax
import numpy as np
import pytest

from federated_pytorch_test_tpu.drivers import accuracy_comparison as jac
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.drivers import accuracy_comparison as tac

TOY = dict(K=2, Nloop=1, Nadmm=1, batch=16, n_train=32, n_test=32)
CURVES = ("standalone", "fedavg", "consensus", "upper_k1")


@pytest.fixture(scope="module")
def both():
    inits = []

    class JRecording(jac.BlockwiseFederatedTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inits.append((self.params0, self.batch_stats0))

    class TFromJax(tac.BlockwiseFederatedTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            p0, b0 = (jax.tree.map(np.asarray, t) for t in inits.pop(0))
            self.params0, self.batch_stats0 = \
                bridge.classifier_state_from_jax(p0, b0)

    mp = pytest.MonkeyPatch()
    mp.setattr(jac, "BlockwiseFederatedTrainer", JRecording)
    mp.setattr(jac, "FederatedConfig",
               functools.partial(jac.FederatedConfig, device_data=False))
    mp.setattr(tac, "BlockwiseFederatedTrainer", TFromJax)
    try:
        want = jac.run_comparison(**TOY)
        assert len(inits) == 4
        got = tac.run_comparison(device="cpu", **TOY)
    finally:
        mp.undo()
    assert inits == []
    return got, want


def test_curves_match_jax(both):
    got, want = both
    for name in CURVES:
        assert len(got[name]) == len(want[name]) > 0, name
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=100.0 / 32 + 1e-9, err_msg=name)
    # the budgets: 1 x 1 full-net epochs standalone, one round per block
    # (Net has 5) federated
    assert [len(got[n]) for n in CURVES] == [1, 5, 5, 1]


def test_result_layout_matches_jax(both):
    got, want = both
    assert set(got) == set(want)
    assert got["config"] == want["config"]
    assert got["data_source"] == want["data_source"] == "synthetic"
    assert got["final"] == {n: got[n][-1] for n in CURVES}
    json.dumps(got)


def test_main_writes_the_json(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU at a tiny size: the JSON file and the final line
    (no plot: matplotlib is imported only for ``--plot``)."""
    out = tmp_path / "acc.json"
    res = tac.main(["--device", "cpu", "--K", "2", "--Nloop", "1", "--Nadmm",
                    "1", "--batch", "16", "--n-train", "16", "--n-test", "16",
                    "--out", str(out)])
    assert json.loads(out.read_text())["final"] == res["final"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(
        res["final"])
