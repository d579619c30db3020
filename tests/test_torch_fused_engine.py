"""Slice 3 as a whole: the port's classifier engine with the compressed
exchange against the JAX ``BlockwiseFederatedTrainer``.

K=4, two blocks, Nadmm=2, ADMM consensus on Net, started from the JAX
trainer's weights (``bridge.py``), on the same synthetic CIFAR-10 shards as
``tests/test_torch_classifier_engine.py``: ``compress="q8"`` with
``fused_collective=True`` over a 2-shard client mesh (the JAX side on two
virtual CPU devices, its comm kernels in Pallas interpret mode), and once
more with the unfused ``compress="q8"``.  The JAX quantizer's key stream
is replayed into the port's quantizer through its ``uniform`` seam, so
both sides round the same deltas with the same draws.

Tolerances are those of slice 2 (the classifier engine test): N, rho,
bytes_on_wire and bytes_fused equal integers; loss at rtol 1e-4, residuals
at rtol 1e-3, final parameters at atol 5e-4.  The quantizers move a value
by a whole grid step where a rounding falls the other way, and the JAX
program (under ``jit``) rounds the scale and the hop accumulate apart from
IEEE.  Measured (fused / unfused): loss 4.4e-6 / 4.4e-6, dual residual
7.1e-4 / 5.7e-4, primal residual 5.9e-4 / 2.2e-4 (relative), parameters
1.6e-4 / 1.6e-4 (absolute): the scale of slice 2's run without
compression, so no flip reaches the metrics.
"""

import jax
import numpy as np
import pytest

from _torch_engine_pair import K, run_both
from _torch_jax_draws import jax_block_keys, replay
from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import consensus_multi
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)

BASE = dict(Nadmm=2, admm_rho0=0.1, check_results=False, num_devices=2)
CASES = {"q8_fused": dict(compress="q8", fused_collective=True),
         "q8_unfused": dict(compress="q8")}


def _replay_jax_keys(tt: TTrainer) -> None:
    """Hand the JAX engine's per-block quantizer streams to the port's."""
    seeds, keys = [], []
    for ci in range(tt.L):
        block_seed = int(np.random.default_rng(
            [tt.cfg.seed, 23, ci]).integers(2**31))
        seeds += tt._init_comp_state(ci)["seed"].tolist()
        keys += list(jax_block_keys(block_seed, K))
    tt.compressor.uniform = replay(seeds, keys)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    out = run_both(JNet, TNet, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                   dict(BASE, **CASES[request.param]),
                   replay=_replay_jax_keys)
    out["case"] = request.param
    return out


def test_round_structure_and_bytes_match(runs):
    keys = ("nloop", "block", "nadmm", "N", "rho", "bytes_on_wire")
    fused = runs["case"] == "q8_fused"
    if fused:
        keys += ("bytes_fused",)
    for t, j in zip(runs["thist"], runs["jhist"]):
        assert [t[k] for k in keys] == [j[k] for k in keys]
        assert ("bytes_fused" in t) == fused
        assert t["bytes_on_wire"] == K * runs["tt"].compressor.bytes_on_wire(
            t["N"]) < 4 * K * t["N"]
    assert len(runs["thist"]) == 4


@pytest.mark.parametrize("key,rtol", [("loss", 1e-4), ("dual_residual", 1e-3),
                                      ("primal_residual", 1e-3)])
def test_round_metrics_match(runs, key, rtol):
    want = np.array([r[key] for r in runs["jhist"]])
    got = np.array([r[key] for r in runs["thist"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_final_params_match(runs):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                         atol=5e-4),
                 runs["tparams"], runs["jparams"])
    moved = {k for k, leaves in runs["p0"].items()
             if any(not np.array_equal(runs["tparams"][k][n], leaves[n])
                    for n in leaves)}
    assert moved == {"fc1", "conv1"}


def test_records_count_no_launches_on_cpu(runs):
    for r in runs["thist"]:
        assert r["kernel_launches"] == {"gram": 0, "quantize_chunks": 0,
                                        "dequant_add": 0}


def _port(**kw):
    data = TData(K=4, batch=16, limit_per_client=16, limit_test=16)
    return TTrainer(TNet(), TConfig(K=4, device="cpu", **kw), data,
                    talg.AdmmConsensus())


def _jax(**kw):
    data = JData(K=4, batch=16, limit_per_client=16, limit_test=16)
    return JTrainer(JNet(), JConfig(K=4, **kw), data, jalg.AdmmConsensus())


@pytest.mark.parametrize("kw,match", [
    (dict(fused_collective=True), "compressed wire format"),
    (dict(compress="q8", fused_collective=True, robust_agg="trim"), "robust"),
    (dict(error_feedback=True), "lossy compressor"),
])
def test_engine_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as jerr:
        _jax(**kw)
    with pytest.raises(ValueError, match=match) as terr:
        _port(**kw)
    if match != "robust":           # the JAX message also names a knob
        assert str(terr.value) == str(jerr.value)   # the port lacks


def test_engine_refuses_topk():
    """Top-k is ported; what the engine refuses is only the sparse fused
    mean under ADMM, whose aggregated stack y + rho*x is dense: both
    engines warn with the same message and fall back to the unfused
    reduction (no ``bytes_fused``).  FedAvg keeps the sparse fused mean
    (``tests/test_torch_topk_engine.py``)."""
    kw = dict(compress="topk", error_feedback=True, fused_collective=True,
              num_devices=2)
    with pytest.warns(UserWarning, match="falling back") as jw:
        jt = _jax(**kw)
    with pytest.warns(UserWarning, match="falling back") as tw:
        tt = _port(**kw)
    assert str(tw[0].message) == str(jw[0].message)
    assert not jt._fused_coll and not tt._fused_coll
    assert tt.mean_fn is None                   # the plain mean


TINY = ["--K", "4", "--model", "net", "--Nloop", "1", "--Nadmm", "1",
        "--n-train", "16", "--n-test", "16", "--default-batch", "16"]


@pytest.mark.parametrize("extra", [["--fused-collective"],
                                   ["--error-feedback", "--quant-chunk", "64"]])
def test_driver_runs_the_compressed_exchange_on_cpu(extra):
    lines = []
    trainer, state, hist = consensus_multi.main(
        ["--device", "cpu", "--compress", "q8", "--num-devices", "2", *TINY,
         *extra], log=lines.append)
    assert trainer.device.type == "cpu" and trainer.D == 2
    assert trainer.compressor.name == ("q8+ef" if "--error-feedback" in extra
                                       else "q8")
    assert [r["block"] for r in hist] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert all(("bytes_fused" in r) == ("--fused-collective" in extra)
               for r in hist)
    assert lines[-1] == "Finished Training"
