"""The port's VAE drivers, ``federated_vae`` and ``federated_vae_cl``.

- Each driver's ``DEFAULTS`` equal to the JAX driver's, ``--device``
  defaulting to ``cuda`` and raising without a card, ``--Kc``/``--Lc``
  reaching the clustering model, and the throughput knobs reaching the
  config and the engine.
- Each driver end to end on the CPU (``--device cpu``) at a tiny size: the
  full sweep (12 layers; 3 blocks), every loss finite, the final test ELBO
  finite.
- The flags of what a driver fixes itself (its model, VAE-CL's optimizers
  and rate, the regulariser a VAE does not have) refused by name.

Each driver against a live JAX run is in ``test_torch_vae_engine.py`` and
``test_torch_vae_cl_engine.py``, on the JAX run those files make.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from _torch_tmp_cwd import tmp_cwd  # noqa: F401

from federated_pytorch_test_tpu_torch.drivers import common, federated_vae, federated_vae_cl

DRIVERS = {"federated_vae": federated_vae, "federated_vae_cl": federated_vae_cl}
SILENT = lambda m: None
TINY = ["--device", "cpu", "--Nloop", "1", "--Nadmm", "1", "--n-train", "40",
        "--n-test", "32", "--default-batch", "16"]


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_defaults_are_the_reference_ones(name):
    jd = importlib.import_module(
        f"federated_pytorch_test_tpu.drivers.{name}").DEFAULTS
    td = DRIVERS[name].DEFAULTS
    for f in dataclasses.fields(td):
        if f.name != "device":
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert td.device == "cuda"
    args = common.build_parser(td, name).parse_args([])
    assert args.device == "cuda"


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DRIVERS[name].main(["--K", "1", "--n-train", "8", "--n-test", "8"],
                           log=SILENT)


@pytest.mark.parametrize("name", list(DRIVERS))
@pytest.mark.parametrize("flag", ["--sharded-update", "--fused-rounds",
                                  "--device-data", "--overlap-round"])
def test_driver_refuses_unported_knobs(name, flag):
    """The throughput knobs, which the drivers once refused by name, reach
    the VAE trainers' config and engine."""
    field = flag[2:].replace("-", "_")
    t = DRIVERS[name].build([*TINY, flag])
    assert getattr(t.cfg, field) is True
    engine = {"sharded_update": t.cfg.sharded_update and t.mean_fn is None,
              "device_data": t._dev_x is not None,
              "fused_rounds": t._use_fused,
              "overlap_round": t._overlap_round}
    assert engine[field]
    t.close()


@pytest.mark.parametrize("name,flag", [
    ("federated_vae", "--model"), ("federated_vae", "--lambda2"),
    ("federated_vae_cl", "--lr"), ("federated_vae_cl", "--optimizer"),
    ("federated_vae_cl", "--no-bf16")])
def test_driver_refuses_what_it_fixes(name, flag, capsys):
    value = {"--model": ["net"], "--lambda2": ["0.1"], "--lr": ["0.1"],
             "--optimizer": ["adam"], "--no-bf16": []}[flag]
    with pytest.raises(SystemExit):
        DRIVERS[name].main([*TINY, flag, *value], log=SILENT)
    assert f"{flag.replace('no-', '')} is fixed by {name}" in \
        capsys.readouterr().err


@pytest.mark.parametrize("name,extra,units", [
    ("federated_vae", ["--K", "2"], 12),
    ("federated_vae_cl", ["--Kc", "3", "--Lc", "4"], 3)])
def test_driver_runs_on_cpu_when_asked(name, extra, units):
    lines = []
    trainer, state, hist = DRIVERS[name].main([*TINY, *extra],
                                              log=lines.append)
    assert trainer.device.type == "cpu"
    assert lines[0].startswith(f"{name}: K=")
    assert lines[-1] == "Finished Training"
    assert [r["block"] for r in hist] == list(range(units))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["dual_residual"])
               for r in hist)
    assert "accuracy" not in hist[0]            # check_results off
    elbo = trainer.evaluate(state)
    assert elbo.shape == (trainer.cfg.K,) and np.isfinite(elbo).all()
    if name == "federated_vae_cl":
        assert (trainer.model.K, trainer.model.L) == (3, 4)
        assert trainer.cfg.K == 1 and trainer.cfg.lambda2 == 1e-3
