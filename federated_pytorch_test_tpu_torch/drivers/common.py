"""Shared CLI plumbing for the port's classifier drivers.

Port of ``federated_pytorch_test_tpu/drivers/common.py`` without
supervision, campaigns, checkpoints or telemetry: flags (the JAX knob
names of every ``FederatedConfig`` field the port has, plus ``--device``,
``--n-train`` and ``--n-test``), the data partition, the model choice and
the engine.  A knob of the JAX driver that the port does not have yet is
refused by name instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.resnet import ResNet9, ResNet18
from federated_pytorch_test_tpu_torch.models.simple import Net, Net1, Net2
from federated_pytorch_test_tpu_torch.parallel.comm import ROBUST_AGG_CHOICES
from federated_pytorch_test_tpu_torch.train.algorithms import Algorithm
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import BlockwiseFederatedTrainer

_MODELS = {"net": Net, "net1": Net1, "net2": Net2,
           "resnet9": ResNet9, "resnet18": ResNet18}
MODEL_CHOICES = ("auto",) + tuple(_MODELS)

#: flags of the JAX classifier drivers whose features the port does not
#: have yet (ROADMAP.md): given on the command line, they raise
UNPORTED = (
    "participation", "population", "compress", "fault-spec", "campaign-spec",
    "update-guard", "async-rounds", "fused-rounds", "fused-collective",
    "overlap-staging", "overlap-round", "sharded-update", "device-data",
    "load-model", "midrun-checkpoint", "async-checkpoint", "max-restarts",
    "obs-dir", "obs-sinks", "control", "serve-spec", "profile-dir",
    "be-verbose")


def build_parser(defaults: FederatedConfig, prog: str) -> argparse.ArgumentParser:
    """Argparse over the port's FederatedConfig fields (JAX knob names)."""
    p = argparse.ArgumentParser(
        prog=prog, description="Federated CIFAR-10 driver (PyTorch + CUDA)")
    optional_types = {"data_dir": str, "num_devices": int}
    for f in dataclasses.fields(FederatedConfig):
        default = getattr(defaults, f.name)
        arg = "--" + f.name.replace("_", "-")
        if f.name == "device":
            p.add_argument(arg, choices=("cuda", "cpu"), default=default)
        elif isinstance(default, bool):
            p.add_argument(arg, action=argparse.BooleanOptionalAction,
                           default=default)
        elif f.name == "optimizer":
            p.add_argument(arg, choices=("adam", "lbfgs"), default=default)
        elif f.name == "norm":
            p.add_argument(arg, choices=("batch", "group"), default=default)
        elif f.name == "robust_agg":
            p.add_argument(arg, choices=ROBUST_AGG_CHOICES, default=default)
        elif f.name == "model":
            p.add_argument(arg, choices=MODEL_CHOICES, default=default)
        elif default is None:
            p.add_argument(arg, type=optional_types[f.name], default=None)
        else:
            p.add_argument(arg, type=type(default), default=default)
    p.add_argument("--n-train", type=int, default=None,
                   help="cap samples per client (smoke runs)")
    p.add_argument("--n-test", type=int, default=None,
                   help="cap test-set size (smoke runs)")
    for name in UNPORTED:
        p.add_argument(f"--{name}", f"--no-{name}", dest=f"unported_{name}",
                       nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def parse_config(defaults: FederatedConfig, prog: str, argv=None):
    """(FederatedConfig, args) from ``argv``; an unported knob raises."""
    p = build_parser(defaults, prog)
    args = p.parse_args(argv)
    given = [n for n in UNPORTED if getattr(args, f"unported_{n}") is not None]
    if given:
        p.error(f"--{given[0]} is not ported to the PyTorch package yet "
                "(see ROADMAP.md)")
    cfg = FederatedConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(FederatedConfig)})
    return cfg, args


def pick_model(cfg: FederatedConfig):
    """Classifier model from ``cfg.model`` ("auto" follows use_resnet)."""
    dtype = torch.bfloat16 if cfg.bf16 else None
    name = cfg.model
    if name == "auto":
        name = "resnet18" if cfg.use_resnet else "net"
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; "
                         f"expected one of {MODEL_CHOICES}")
    if name.startswith("resnet"):
        return _MODELS[name](dtype=dtype, norm=cfg.norm)
    return _MODELS[name](dtype=dtype)


def make_trainer(cfg: FederatedConfig, algorithm: Algorithm,
                 n_train: Optional[int] = None,
                 n_test: Optional[int] = None) -> BlockwiseFederatedTrainer:
    data = FederatedCifar10(
        K=cfg.K, batch=cfg.default_batch, biased_input=cfg.biased_input,
        drop_last_sample=cfg.drop_last_sample, data_dir=cfg.data_dir,
        limit_per_client=n_train, limit_test=n_test)
    return BlockwiseFederatedTrainer(pick_model(cfg), cfg, data, algorithm)


def run_classifier_driver(prog: str, defaults: FederatedConfig,
                          algorithm: Algorithm, argv=None, log=print):
    """Parse, build, run; returns (trainer, state, history)."""
    cfg, args = parse_config(defaults, prog, argv)
    trainer = make_trainer(cfg, algorithm, args.n_train, args.n_test)
    mname = type(trainer.model).__name__
    if mname == "ResNet":
        mname = f"ResNet{trainer.model.qualifier}"
    log(f"{prog}: K={cfg.K} model={mname} devices={trainer.D} "
        f"clients/device={trainer.K_local} data={trainer.data.source} "
        f"device={trainer.device}")
    state, history = trainer.run(log=log)
    log("Finished Training")
    return trainer, state, history
