"""The slice as a whole: the port's classifier engine (``train/engine.py``)
against the JAX ``BlockwiseFederatedTrainer``, and the algorithms' global
updates (``train/algorithms.py``) against the JAX ones.

The engine runs: K=4, two blocks, Nadmm=2, ADMM consensus, started from
the JAX trainer's weights carried across with ``bridge.py``, on the same
synthetic CIFAR-10 shards (40 images per client, batch 16, so the last
batch of every epoch has 8 pad rows): Net with krum over a 2-shard mesh
with ``robust_chunked`` (the JAX side on two virtual CPU devices with the
Pallas Gram in interpret mode); Net with the plain mean at D=1; and a tiny
conv + masked BatchNorm + dense model with the plain mean at D=1, whose
per-client running statistics (pad rows excluded) are compared too.  The
JAX side pins ``device_data=False`` (its on-device permutation draws
``jax.random``).

Tolerances.  Both sides run float32 in different summation orders, and
Adam's normalised step moves an element whose gradient is at rounding
level by up to lr = 1e-3 either way:
- N and bytes_on_wire are integers and equal; rho equal;
- loss at rtol 1e-4 (measured 5e-6);
- dual and primal residuals at rtol 1e-3 (measured 2.6e-4: they are norms
  of differences of nearly equal vectors);
- the final parameters at atol 5e-4 (measured 1.6e-4), the BatchNorm
  running statistics at rtol 1e-4, atol 1e-5;
- per-client test accuracy within one test image.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_engine_pair import run_both
from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models import base as jbase
from federated_pytorch_test_tpu.models.resnet import MaskedBatchNorm
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import common, consensus_multi
from federated_pytorch_test_tpu_torch.models import base as tbase
from federated_pytorch_test_tpu_torch.models.base import Classifier
from federated_pytorch_test_tpu_torch.models.resnet import (
    _bn_stats,
    masked_batch_norm,
)
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)

class JTinyBN(jbase.BlockModule):
    """conv(3->4, 5, stride 2) -> masked BatchNorm -> ELU -> pool -> fc."""

    @nn.compact
    def __call__(self, x, train: bool = True, sample_weight=None):
        x = nn.Conv(4, (5, 5), strides=(2, 2), padding="VALID",
                    use_bias=False, name="conv1")(x)
        x = jbase.elu(MaskedBatchNorm(name="bn1")(
            x, w=sample_weight, use_running_average=not train))
        x = jbase.flatten(jbase.max_pool_2x2(x))
        return nn.Dense(10, name="fc1")(x)

    def param_order(self):
        return ["conv1/kernel", "bn1/scale", "bn1/bias", "fc1/kernel",
                "fc1/bias"]

    def train_order_block_ids(self):
        return [[0, 2], [3, 4]]


class TTinyBN(Classifier):
    """The port's twin of :class:`JTinyBN`."""

    def param_shapes(self):
        return {"conv1": tbase.conv_leaf(4, 3, 5, bias=False),
                "bn1": {"scale": (4,), "bias": (4,)},
                "fc1": tbase.dense_leaf(10, 196)}

    def init_variables(self, gen, init_model=True):
        params, _ = super().init_variables(gen, init_model)
        return params, _bn_stats(params)

    def apply(self, params, batch_stats, x, train=True, sample_weight=None):
        x = tbase.conv(x, params["conv1"], stride=2)
        x, bn1 = masked_batch_norm(x, params["bn1"], batch_stats["bn1"], train,
                                   sample_weight)
        x = tbase.flatten_nhwc(tbase.max_pool_2x2(torch.nn.functional.elu(x)))
        return tbase.dense(x, params["fc1"]), {"bn1": bn1}

    def param_order(self):
        return JTinyBN().param_order()

    def train_order_block_ids(self):
        return [[0, 2], [3, 4]]


#: (JAX model, port model, config, the modules the two blocks train)
CASES = {
    "krum_chunked_d2": (JNet, TNet, dict(robust_agg="krum", robust_chunked=True,
                                         num_devices=2, check_results=True),
                        {"fc1", "conv1"}),
    "plain_d1": (JNet, TNet, dict(robust_agg="none", num_devices=1,
                                  check_results=False), {"fc1", "conv1"}),
    "batchnorm_d1": (JTinyBN, TTinyBN, dict(robust_agg="none", num_devices=1,
                                            check_results=True),
                     {"conv1", "bn1", "fc1"}),
}


def _run_both(jmodel, tmodel, extra, moved):
    out = run_both(jmodel, tmodel, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                   dict(Nadmm=2, admm_rho0=0.1, **extra))
    out["moved"] = moved
    return out


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    return _run_both(*CASES[request.param])


def test_round_structure_matches(runs):
    key = lambda r: (r["nloop"], r["block"], r["nadmm"], r["N"],
                     r["bytes_on_wire"], r["rho"], r["host_dispatches"])
    assert [key(r) for r in runs["thist"]] == [key(r) for r in runs["jhist"]]
    assert len(runs["thist"]) == 4


@pytest.mark.parametrize("key,rtol", [("loss", 1e-4), ("dual_residual", 1e-3),
                                      ("primal_residual", 1e-3)])
def test_round_metrics_match(runs, key, rtol):
    want = np.array([r[key] for r in runs["jhist"]])
    got = np.array([r[key] for r in runs["thist"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_accuracy_matches(runs):
    if "accuracy" not in runs["jhist"][0]:          # check_results=False
        assert all("accuracy" not in r for r in runs["thist"])
    for j, t in zip(runs["jhist"], runs["thist"]):
        if "accuracy" not in j:
            continue
        np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=0,
                                   atol=100.0 / 32 + 1e-9)


def test_final_params_match(runs):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                         atol=5e-4),
                 runs["tparams"], runs["jparams"])
    # the two trained blocks moved, the rest did not
    moved = {k for k, leaves in runs["p0"].items()
             if any(not np.array_equal(runs["tparams"][k][n], leaves[n])
                    for n in leaves)}
    assert moved == runs["moved"]


def test_final_batch_stats_match(runs):
    assert jax.tree.structure(runs["tstats"]) == jax.tree.structure(
        runs["jstats"])
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-4,
                                                         atol=1e-5),
                 runs["tstats"], runs["jstats"])
    for g, b in zip(jax.tree.leaves(runs["tstats"]),
                    jax.tree.leaves(runs["b0"])):
        assert not np.array_equal(g, b)       # every client's stats moved


def test_records_carry_timings_and_no_launches_on_cpu(runs):
    for r in runs["thist"]:
        assert r["round_seconds"] >= r["train_seconds"] >= 0.0
        assert r["kernel_launches"] == {"gram": 0, "quantize_chunks": 0,
                                        "dequant_add": 0}


# ---------------------------------------------------------------------------
# the algorithms' global updates on random stacks


def _jax_update(algo, x, z, y, rho, w, D):
    mesh = client_mesh(D)
    csh = client_sharding(mesh)

    def body(xs, ys, ws):
        return algo.global_update(xs, jnp.asarray(z), ys, jnp.float32(rho), 8,
                                  w=None if w is None else ws)

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS), P(CLIENT_AXIS)),
                  out_specs=(P(), P(CLIENT_AXIS), P()), check_vma=False)
    ww = np.ones(8, np.float32) if w is None else w
    out = jax.jit(f)(*(jax.device_put(jnp.asarray(a), csh) for a in (x, y, ww)))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", ["FedAvg", "FedProx", "AdmmConsensus"])
@pytest.mark.parametrize("weighted", [False, True])
def test_global_update_matches_jax(name, weighted):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 300)).astype(np.float32)
    y = rng.normal(size=(8, 300)).astype(np.float32) * 0.1
    z = rng.normal(size=300).astype(np.float32)
    w = np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32) if weighted else None
    jz, jy, jdiag = _jax_update(getattr(jalg, name)(), x, z, y, 0.3, w, 2)
    tz, ty, tdiag = getattr(talg, name)().global_update(
        torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(y),
        torch.tensor(0.3), 8, ClientMesh(2),
        w=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5, atol=1e-6)
    assert set(tdiag) == set(jdiag)
    for k in jdiag:
        np.testing.assert_allclose(float(tdiag[k]), float(jdiag[k]), rtol=1e-5)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_bb_rho_update_matches_jax(scale):
    rng = np.random.default_rng(12)
    x, y, x0, yhat0 = (rng.normal(size=(4, 64)).astype(np.float32) * s
                       for s in (1.0, 0.1, 1.0, 0.1))
    x0 = x - scale * (x - x0)
    z = rng.normal(size=64).astype(np.float32)
    bb = jalg.BBConfig(rhomax=10.0)
    mesh = client_mesh(2)
    csh = client_sharding(mesh)
    f = shard_map(lambda xs, ys, a, b: jalg.bb_rho_update(
        xs, jnp.asarray(z), ys, jnp.float32(0.05), a, b, bb, 2),
        mesh=mesh, in_specs=(P(CLIENT_AXIS),) * 4,
        out_specs=(P(), P(CLIENT_AXIS), P(CLIENT_AXIS)), check_vma=False)
    jrho, jx0, jyh = jax.tree.map(np.asarray, jax.jit(f)(
        *(jax.device_put(jnp.asarray(a), csh) for a in (x, y, x0, yhat0))))
    trho, tx0, tyh = talg.bb_rho_update(
        torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(y),
        torch.tensor(0.05), torch.from_numpy(x0), torch.from_numpy(yhat0),
        talg.BBConfig(rhomax=10.0))
    np.testing.assert_allclose(float(trho), float(jrho), rtol=1e-5)
    np.testing.assert_array_equal(tx0.numpy(), jx0)
    np.testing.assert_allclose(tyh.numpy(), jyh, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the consensus_multi entry point


TINY = ["--K", "4", "--model", "net", "--Nloop", "1", "--Nadmm", "1",
        "--n-train", "16", "--n-test", "16", "--default-batch", "16"]
KNOBS = ("device_data", "fused_rounds", "overlap_staging", "overlap_round",
         "sharded_update")


def test_driver_runs_on_cpu_when_asked():
    lines = []
    trainer, state, hist = consensus_multi.main(
        ["--device", "cpu", "--robust-agg", "krum", "--robust-chunked",
         "--num-devices", "2", *TINY], log=lines.append)
    assert trainer.device.type == "cpu" and trainer.D == 2
    assert [r["block"] for r in hist] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert lines[-1] == "Finished Training"


def test_driver_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        consensus_multi.main(TINY, log=lambda m: None)


def test_driver_defaults_are_the_reference_ones():
    from federated_pytorch_test_tpu.drivers.consensus_multi import (
        DEFAULTS as JD,
    )
    d = consensus_multi.DEFAULTS
    assert (d.K, d.Nloop, d.Nepoch, d.Nadmm, d.admm_rho0, d.biased_input,
            d.device) == (JD.K, JD.Nloop, JD.Nepoch, JD.Nadmm, JD.admm_rho0,
                          JD.biased_input, "cuda")


@pytest.mark.parametrize("argv,field", [
    (["--sharded-update"], "sharded_update"),
    (["--device-data"], "device_data"),
    (["--fused-rounds"], "fused_rounds"),
    (["--overlap-round"], "overlap_round"),
])
def test_unported_knobs_are_refused(argv, field):
    """The throughput knobs, which the drivers once refused by name, are
    parsed as the JAX drivers parse them and reach the config and the
    engine: the sharded update, the shards on the device, the fused round,
    the round overlap."""
    cfg, args = common.parse_config(consensus_multi.DEFAULTS,
                                    "consensus_multi",
                                    ["--device", "cpu", *TINY, *argv])
    assert getattr(cfg, field) is True
    assert [getattr(cfg, f) for f in KNOBS if f != field] == \
        [getattr(consensus_multi.DEFAULTS, f) for f in KNOBS if f != field]
    t = common.make_trainer(cfg, talg.AdmmConsensus(), args.n_train,
                            args.n_test)
    engine = {"sharded_update": t.cfg.sharded_update and t.mean_fn is None,
              "device_data": t._dev_x is not None,
              "fused_rounds": t._use_fused,
              "overlap_round": t._overlap_round}
    assert engine[field]
    t.close()


def test_engine_refuses_lbfgs_and_bad_mesh():
    """L-BFGS is ported for BatchNorm-free models; on a model with
    BatchNorm the port refuses it with the JAX engine's ValueError (the
    JAX engine raises when it builds the block's step, the port at
    construction).  A mesh that does not divide K, and --robust-chunked
    without an estimator, are refused too."""
    data = TData(K=4, batch=16, limit_per_client=16, limit_test=16)
    jt = JTrainer(JTinyBN(), JConfig(K=4, optimizer="lbfgs",
                                     device_data=False),
                  JData(K=4, batch=16, limit_per_client=16, limit_test=16),
                  jalg.AdmmConsensus())
    with pytest.raises(ValueError, match="BatchNorm-free") as jerr:
        jt.run(log=lambda m: None)
    with pytest.raises(ValueError, match="BatchNorm-free") as terr:
        TTrainer(TTinyBN(), TConfig(K=4, device="cpu", optimizer="lbfgs"),
                 data, talg.AdmmConsensus())
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="not divisible"):
        TTrainer(TNet(), TConfig(K=4, device="cpu", num_devices=3), data,
                 talg.AdmmConsensus())
    with pytest.raises(ValueError, match="robust-chunked"):
        TTrainer(TNet(), TConfig(K=4, device="cpu", robust_chunked=True), data,
                 talg.AdmmConsensus())


def test_batchnorm_engine_keeps_per_client_statistics():
    """ResNet9 with BatchNorm through one round of the stem block: every
    client's running statistics move with its own data (the last batch has
    pad rows), and stay [K, C] tensors."""
    data = TData(K=2, batch=8, limit_per_client=12, limit_test=8)
    from federated_pytorch_test_tpu_torch.models.resnet import ResNet9
    t = TTrainer(ResNet9(), TConfig(K=2, Nloop=1, Nadmm=1, default_batch=8,
                                    device="cpu", robust_agg="krum",
                                    robust_chunked=True, num_devices=2),
                 data, talg.AdmmConsensus())
    t.L = 1
    state, hist = t.run(log=lambda m: None)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert np.isfinite(hist[0]["accuracy"]).all()
    before = t.batch_stats0["layer4_0"]["bn2"]["var"]
    after = state.batch_stats["layer4_0"]["bn2"]["var"]
    assert after.shape == before.shape == (2, 512)
    assert not torch.equal(after[0], before[0])
    assert not torch.equal(after[0], after[1])
