"""The port's classifier drivers: ``federated_multi``, ``fedprox_multi``
and ``no_consensus_multi`` (new), with ``consensus_multi``'s plumbing.

- The no-consensus baseline (``run_independent``: the whole net trains,
  Adam afresh every epoch, no comm) against the JAX engine's, K=4 on Net,
  Nepoch = 2, batch 16, 40 images per client, from the same weights
  (``tests/_torch_engine_pair.py``).  Tolerances those of the consensus
  engine test: loss at rtol 1e-4, final parameters at atol 5e-4, accuracy
  within one test image.  Measured: loss 1.3e-6 (relative), parameters
  4.6e-5, accuracy equal.
- Each driver's ``DEFAULTS`` equal to the JAX driver's, ``--device``
  defaulting to ``cuda`` (and raising without a card), the L-BFGS knobs
  on the command line, and a tiny drive of each driver on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_engine_pair import max_param_diff, moved_modules, run_both
from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.drivers import (
    common,
    fedprox_multi,
    federated_multi,
    no_consensus_multi,
)
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train import engine

DRIVERS = {"federated_multi": federated_multi, "fedprox_multi": fedprox_multi,
           "no_consensus_multi": no_consensus_multi}


@pytest.fixture(scope="module")
def independent():
    counts = []
    adam_step = engine.adam_step

    def spy(x, g, mu, nu, count, lr):
        counts.append(count)
        return adam_step(x, g, mu, nu, count, lr)

    engine.adam_step = spy
    try:
        out = run_both(JNet, TNet, jalg.NoConsensus(), talg.NoConsensus(),
                       dict(Nepoch=2, check_results=True), independent=True)
    finally:
        engine.adam_step = adam_step
    out["counts"] = counts
    return out


def test_independent_records_match(independent):
    j, t = independent["jhist"], independent["thist"]
    assert [r["epoch"] for r in t] == [r["epoch"] for r in j] == [0, 1]
    assert all(set(r) == {"epoch", "loss", "epoch_seconds", "accuracy",
                          "host_dispatches"} for r in t)
    # one local-epoch call an epoch, as the JAX records count it
    assert [r["host_dispatches"] for r in t] == \
        [r["host_dispatches"] for r in j] == [1, 1]
    np.testing.assert_allclose([r["loss"] for r in t], [r["loss"] for r in j],
                               rtol=1e-4)
    for a, b in zip(t, j):
        assert a["epoch_seconds"] > 0
        np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                                   atol=100.0 / 32 + 1e-9)


def test_independent_trains_the_whole_net(independent):
    assert max_param_diff(independent["tparams"],
                          independent["jparams"]) <= 5e-4
    assert moved_modules(independent["p0"], independent["tparams"]) == set(
        independent["p0"])
    tt = independent["tt"]
    assert tt.block_size(None) == sum(
        int(np.prod(leaf.shape[1:])) for mod in independent["p0"].values()
        for leaf in mod.values())
    assert tt.reg_for_block(None) == (0.0, 0.0)


def test_independent_recreates_adam_every_epoch(independent):
    """Adam's step count restarts at 1 in each epoch of each client: 3
    steps an epoch, 4 clients, 2 epochs."""
    assert independent["counts"] == [1, 2, 3] * 4 * 2


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_defaults_are_the_reference_ones(name):
    import importlib

    jd = importlib.import_module(
        f"federated_pytorch_test_tpu.drivers.{name}").DEFAULTS
    td = DRIVERS[name].DEFAULTS
    for f in dataclasses.fields(td):
        if f.name != "device":
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert td.device == "cuda"
    args = common.build_parser(td, name).parse_args([])
    assert args.device == "cuda"
    assert (args.lbfgs_history_size, args.lbfgs_max_iter) == (10, 4)


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DRIVERS[name].main(["--K", "2", "--model", "net", "--n-train", "8",
                            "--n-test", "8"], log=lambda m: None)


TINY = ["--device", "cpu", "--K", "4", "--model", "net", "--Nloop", "1",
        "--Nadmm", "1", "--n-train", "16", "--n-test", "16",
        "--default-batch", "16"]


@pytest.mark.parametrize("name,extra", [
    ("federated_multi", ["--compress", "topk", "--error-feedback",
                         "--fused-collective", "--num-devices", "2"]),
    ("federated_multi", ["--optimizer", "lbfgs", "--lbfgs-max-iter", "2",
                         "--lbfgs-history-size", "3"]),
    ("fedprox_multi", []),
    ("no_consensus_multi", ["--Nepoch", "2"]),
])
def test_driver_runs_on_cpu_when_asked(name, extra):
    lines = []
    trainer, state, hist = DRIVERS[name].main([*TINY, *extra],
                                              log=lines.append)
    assert trainer.device.type == "cpu"
    assert lines[0].startswith(f"{name}: K=4 model=Net")
    assert lines[-1] == "Finished Training"
    assert all(np.isfinite(r["loss"]) for r in hist)
    if name == "no_consensus_multi":
        assert [r["epoch"] for r in hist] == [0, 1]
        assert [m.split(" acc=")[0] for m in lines[1:3]] == ["Epoch 0",
                                                             "Epoch 1"]
        return
    assert [r["block"] for r in hist] == [0, 1, 2, 3, 4]
    if "--optimizer" in extra:
        assert trainer.lbfgs.max_iter == 2 and trainer.lbfgs.history_size == 3
        assert all(s.n_iter_total <= 2 for s in state.opt_state)
    if "--compress" in extra:
        assert trainer.compressor.name == "topk+ef" and trainer._fused_coll
        assert all(r["bytes_fused"] == r["bytes_on_wire"] for r in hist)
