"""The engine's throughput knobs against the JAX engine.

Both engines run Net at K=4 over two blocks from the same weights
(``tests/_torch_engine_pair.py``, the JAX side with ``device_data=False``):
with ``overlap_staging`` and ``overlap_round`` on (two local epochs a
round), and with ``sharded_update`` at D=2.  The engine pairs' tolerances
hold (loss rtol 1e-4, residuals rtol 1e-3, final parameters atol 5e-4),
every count field of every round is equal, ``host_dispatches`` among them,
and the records carry the same keys.  ``fused_rounds`` needs JAX's own
device shuffle (``jax.random``, which torch cannot replay): the port's
fused run has the JAX fused run's count fields and record keys, and the
port's unfused run's values bit for bit.
"""

import numpy as np
import pytest
import torch
from _torch_engine_pair import DATA, K, max_param_diff, run_both, torch_threads

from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves

#: every record field that is a count of the round's schedule
COUNTS = ("nloop", "block", "nadmm", "N", "host_dispatches", "n_active",
          "bytes_on_wire")
#: the JAX records' telemetry the port does not keep
JAX_ONLY = {"sync_seconds", "compile_seconds", "cache_hit", "flops_round",
            "hlo_bytes_accessed"}
SILENT = lambda m: None

CONFIGS = {
    "overlap": dict(Nadmm=2, Nepoch=2, admm_rho0=0.1, overlap_staging=True,
                    overlap_round=True),
    "sharded": dict(Nadmm=2, admm_rho0=0.1, num_devices=2,
                    sharded_update=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    with torch_threads(1):
        out = run_both(JNet, TNet, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                       CONFIGS[request.param])
    out["name"] = request.param
    return out


def check_counts_and_keys(jh, th):
    assert len(jh) == len(th) == 4
    for j, t in zip(jh, th):
        assert set(t) - {"kernel_launches"} == set(j) - JAX_ONLY
        for k in COUNTS:
            assert t.get(k, "absent") == j.get(k, "absent"), k


def test_counts_and_record_keys_equal_jax(pair):
    check_counts_and_keys(pair["jhist"], pair["thist"])
    th = pair["thist"]
    if pair["name"] == "overlap":
        assert [r["host_dispatches"] for r in th] == [2] * 4
        assert [r["overlap_dispatch_seconds"] > 0 for r in th] == \
            [True, False, True, False]
        assert [r["overlap_dispatch_seconds"] > 0
                for r in pair["jhist"]] == [True, False, True, False]
    else:
        assert pair["tt"].D == 2


def test_numbers_track_jax(pair):
    for j, t in zip(pair["jhist"], pair["thist"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        for k in ("primal_residual", "dual_residual"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3)
    assert max_param_diff(pair["tparams"], pair["jparams"]) <= 5e-4


FUSED = dict(K=K, Nloop=1, Nepoch=2, Nadmm=2, default_batch=16,
             biased_input=True, admm_rho0=0.1, check_results=False)


def test_fused_rounds_counts_and_keys_equal_jax_values_equal_unfused():
    jt = JTrainer(JNet(), JConfig(device_data=True, fused_rounds=True,
                                  **FUSED), JData(**DATA),
                  jalg.AdmmConsensus())
    jt.L = 2
    assert jt._use_fused
    _, jh = jt.run(log=SILENT)

    def port(**kw):
        t = TTrainer(TNet(), TConfig(device="cpu", **FUSED, **kw),
                     TData(**DATA), talg.AdmmConsensus())
        t.L = 2
        with torch_threads(1):
            return t, *t.run(log=SILENT)

    tt, ts, th = port(device_data=True, fused_rounds=True)
    assert tt._use_fused
    check_counts_and_keys(jh, th)
    assert [r["host_dispatches"] for r in th] == [1] * 4
    assert [r["comm_seconds"] for r in th] == [r["comm_seconds"]
                                               for r in jh] == [0.0] * 4
    _, us, uh = port(device_data=False)
    assert [r["loss"] for r in th] == [r["loss"] for r in uh]
    for a, b in zip(leaves(ts.params), leaves(us.params)):
        assert torch.equal(a, b)
