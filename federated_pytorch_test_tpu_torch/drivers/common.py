"""Shared CLI plumbing for the port's drivers (the classifiers, the VAEs
and the CPC's flag surface).

Port of ``federated_pytorch_test_tpu/drivers/common.py``: flags (the JAX
knob names of every ``FederatedConfig`` field the port has, plus
``--device``, ``--n-train`` and ``--n-test``), the data
partition, the model choice, the engine and its checkpoints
(``--midrun-checkpoint`` saves after every round under
``<checkpoint-dir>/<prog>_midrun``, ``--load-model`` resumes that slot or
else loads the end-of-run ``<checkpoint-dir>/<prog>``, which the run saves
unless ``--no-save-model``), the record stream (written under
``<checkpoint-dir>/obs`` unless ``--obs-dir`` or ``--obs-sinks`` say
otherwise), the restart supervisor (``--max-restarts``, which turns the
mid-run checkpoint on) and the soak harness (``--campaign-spec``, which
turns the mid-run checkpoint on and runs under ``campaign/harness.py``
``run_soak``, its waits scaled by ``--campaign-accel``).  A driver may hand in its own trainer class, model
and extra flags, and refuses the flags of what it fixes.

Under ``FEDTPU_DISTRIBUTED=1`` each process of a job joins the process
group before its first device query (:func:`setup_runtime`) and runs its
rank's share of the client mesh; the end-of-run checkpoint is saved by
process 0 from the gathered tree, and a load restores each rank's rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional, Type

import torch

from federated_pytorch_test_tpu_torch.campaign.harness import run_soak
from federated_pytorch_test_tpu_torch.compress.base import COMPRESS_CHOICES
from federated_pytorch_test_tpu_torch.control.policy import (
    CONTROL_MODES,
    CONTROL_POLICIES,
)
from federated_pytorch_test_tpu_torch.control.supervisor import (
    supervise_classifier,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.resnet import ResNet9, ResNet18
from federated_pytorch_test_tpu_torch.models.simple import Net, Net1, Net2
from federated_pytorch_test_tpu_torch.obs.health import HEALTH_ACTIONS
from federated_pytorch_test_tpu_torch.parallel.comm import ROBUST_AGG_CHOICES
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    initialize_multihost,
    rank_device,
)
from federated_pytorch_test_tpu_torch.population.sampler import SAMPLER_CHOICES
from federated_pytorch_test_tpu_torch.train.algorithms import Algorithm
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import BlockwiseFederatedTrainer
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils.tree import tree_map

_MODELS = {"net": Net, "net1": Net1, "net2": Net2,
           "resnet9": ResNet9, "resnet18": ResNet18}
MODEL_CHOICES = ("auto",) + tuple(_MODELS)

#: parse_config's default of a ``fixed`` field, to tell it from a given one
_FIXED = object()


def build_parser(defaults: FederatedConfig, prog: str) -> argparse.ArgumentParser:
    """Argparse over the port's FederatedConfig fields (JAX knob names)."""
    p = argparse.ArgumentParser(
        prog=prog, description="Federated CIFAR-10 driver (PyTorch + CUDA)")
    optional_types = {"data_dir": str, "num_devices": int,
                      "profile_dir": str, "obs_dir": str}
    # tri-state booleans: absent -> None (auto), --flag/--no-flag override
    optional_bools = {"device_data"}
    for f in dataclasses.fields(FederatedConfig):
        default = getattr(defaults, f.name)
        arg = "--" + f.name.replace("_", "-")
        if f.name == "device":
            p.add_argument(arg, choices=("cuda", "cpu"), default=default)
        elif f.name in optional_bools or isinstance(default, bool):
            p.add_argument(arg, action=argparse.BooleanOptionalAction,
                           default=default)
        elif f.name == "optimizer":
            p.add_argument(arg, choices=("adam", "lbfgs"), default=default)
        elif f.name == "norm":
            p.add_argument(arg, choices=("batch", "group"), default=default)
        elif f.name == "robust_agg":
            p.add_argument(arg, choices=ROBUST_AGG_CHOICES, default=default)
        elif f.name == "compress":
            p.add_argument(arg, choices=COMPRESS_CHOICES, default=default)
        elif f.name == "model":
            p.add_argument(arg, choices=MODEL_CHOICES, default=default)
        elif f.name == "cohort_sampling":
            p.add_argument(arg, choices=SAMPLER_CHOICES, default=default)
        elif f.name == "fault_spec":
            p.add_argument(
                arg, type=str, default=default, metavar="SPEC",
                help="fault injection (train/faults.py): 'none' or "
                     "drop=P,straggle=P,corrupt=P,mode=nan|inf|signflip|"
                     "scale|innerprod|collude,scale=X,seed=N,clients=i+j,"
                     "delay=P,delay_max=N,join=P,leave=P,preempt=P")
        elif f.name == "campaign_spec":
            p.add_argument(
                arg, type=str, default=default, metavar="SPEC",
                help="soak-campaign schedule (campaign/schedule.py): "
                     "'none' or hours=H,round_minutes=M,diurnal=A,"
                     "drop=P,straggle=P,corrupt=P,mode=...,join=P,"
                     "leave=P,storm=P,storm_len=N,storm_straggle=P,"
                     "burst=P,burst_len=N,burst_corrupt=P,"
                     "preempt_at=H1+H2,seed=N,accel=X,"
                     "health_window_hours=H; mutually exclusive with "
                     "--fault-spec")
        elif f.name == "serve_spec":
            p.add_argument(
                arg, type=str, default=default, metavar="SPEC",
                help="serving plane (serve/): 'none' or qps=N,"
                     "round_minutes=M,diurnal=A,buckets=8+32+128,"
                     "swap_every=N,drift_at=R,seed=N")
        elif f.name == "health_action":
            p.add_argument(
                arg, choices=HEALTH_ACTIONS, default=default,
                help="watchdog response (obs/health.py): warn writes "
                     "alert records, abort raises RunHealthAbort, "
                     "checkpoint-abort verifies a final checkpoint first")
        elif f.name == "control":
            p.add_argument(
                arg, choices=CONTROL_MODES, default=default,
                help="control plane (control/): observe records the "
                     "decisions, act applies them; check a stream with "
                     "python -m federated_pytorch_test_tpu_torch.control."
                     "replay <jsonl>")
        elif f.name == "control_policy":
            p.add_argument(arg, choices=CONTROL_POLICIES, default=default)
        elif default is None:
            p.add_argument(arg, type=optional_types[f.name], default=None)
        else:
            p.add_argument(arg, type=type(default), default=default)
    p.add_argument("--n-train", type=int, default=None,
                   help="cap samples per client (smoke runs)")
    p.add_argument("--n-test", type=int, default=None,
                   help="cap test-set size (smoke runs)")
    return p


def parse_config(defaults: FederatedConfig, prog: str, argv=None,
                 add_args: Optional[Callable] = None, fixed=()):
    """(FederatedConfig, args) from ``argv``.
    ``add_args(parser)`` adds a driver's own flags; ``fixed`` names the
    FederatedConfig fields the driver sets itself, whose flags raise too."""
    p = build_parser(defaults, prog)
    if add_args is not None:
        add_args(p)
    p.set_defaults(**{name: _FIXED for name in fixed})
    args = p.parse_args(argv)
    for name in fixed:
        if getattr(args, name) is not _FIXED:
            p.error(f"--{name.replace('_', '-')} is fixed by {prog}")
        setattr(args, name, getattr(defaults, name))
    cfg = FederatedConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(FederatedConfig)})
    return setup_runtime(default_obs_dir(cfg)), args


def setup_runtime(cfg: FederatedConfig) -> FederatedConfig:
    """Join the job's process group when ``FEDTPU_DISTRIBUTED=1``
    (``parallel/mesh.py`` ``initialize_multihost``), before the first
    device query, and give this rank its device: ``cuda:LOCAL_RANK`` when
    each rank has a card of its own, else the run's device (``--device
    cpu`` stays the CPU)."""
    initialize_multihost(cfg.device)
    dev = rank_device(cfg.device)
    return cfg if dev == cfg.device else dataclasses.replace(cfg, device=dev)


def default_obs_dir(cfg: FederatedConfig) -> FederatedConfig:
    """A driver's record stream goes to ``<checkpoint_dir>/obs`` unless
    ``--obs-dir`` names another directory or ``--obs-sinks`` is given;
    engine-API callers keep the file-free "auto" without a directory."""
    if cfg.obs_dir is None and cfg.obs_sinks == "auto":
        cfg = dataclasses.replace(
            cfg, obs_dir=os.path.join(cfg.checkpoint_dir, "obs"))
    return cfg


def print_obs_artifact(trainer, log=print) -> None:
    """Name the run's JSONL stream, if it wrote one."""
    rec = getattr(trainer, "obs_recorder", None)
    if rec is not None and rec.jsonl_path:
        log(f"obs artifact -> {rec.jsonl_path}")


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
                 n_test: Optional[int] = None, model=None,
                 trainer_cls: Type[BlockwiseFederatedTrainer] = BlockwiseFederatedTrainer,
                 ) -> BlockwiseFederatedTrainer:
    """``trainer_cls`` on ``model`` (default :func:`pick_model`'s) over the
    CIFAR-10 partition of ``cfg``."""
    data = FederatedCifar10(
        K=cfg.K, batch=cfg.default_batch, biased_input=cfg.biased_input,
        drop_last_sample=cfg.drop_last_sample, data_dir=cfg.data_dir,
        limit_per_client=n_train, limit_test=n_test)
    return trainer_cls(pick_model(cfg) if model is None else model, cfg,
                       data, algorithm)


def checkpoint_path(cfg: FederatedConfig, name: str) -> str:
    return os.path.join(cfg.checkpoint_dir, name)


def maybe_load(trainer: BlockwiseFederatedTrainer, name: str, log=print):
    """The run's start: with ``--load-model`` and an end-of-run checkpoint
    ``<checkpoint_dir>/<name>`` on disk, its params and batch statistics
    (as the JAX driver: model variables only); else the common init."""
    cfg = trainer.cfg
    state = trainer.init_state()
    path = checkpoint_path(cfg, name)
    if cfg.load_model and os.path.isdir(os.path.abspath(
            os.path.expanduser(path))):
        tree, meta = ckpt.load_checkpoint(path)
        # each rank takes its own client rows
        to = lambda t: tree_map(
            lambda v: trainer._own_leaf(v).to(trainer.device), t)
        state = state._replace(
            params=to(ckpt.unflatten_dict(tree, "params/")),
            batch_stats=to(ckpt.unflatten_dict(tree, "batch_stats/")))
        log(f"loaded checkpoint <- {path} "
            f"(rounds={int(meta.get('rounds', 0))})")
    return state


def finish(trainer: BlockwiseFederatedTrainer, state, name: str, history,
           log=print) -> None:
    """The end-of-run checkpoint ``<checkpoint_dir>/<name>`` (unless
    ``--no-save-model``): params, batch statistics and the last block's
    optimizer state, with the round count."""
    cfg = trainer.cfg
    if not cfg.save_model:
        return
    # the whole K-client tree, gathered across the ranks (process 0 writes)
    full = lambda t: tree_map(trainer._full_leaf, t)
    tree = {**ckpt.flatten_dict(full(state.params), "params/"),
            **ckpt.flatten_dict(full(state.batch_stats), "batch_stats/")}
    for i, leaf in enumerate(trainer._full_opt_leaves(state.opt_state)):
        tree[f"opt/{i}"] = torch.as_tensor(leaf)
    path = checkpoint_path(cfg, name)
    ckpt.save_checkpoint(path, tree, {"rounds": len(history)})
    log(f"saved checkpoint -> {path}")


def run_classifier_driver(prog: str, defaults: FederatedConfig,
                          algorithm: Algorithm, independent: bool = False,
                          argv=None, log=print):
    """Parse, build and run a classifier driver (:func:`run_driver`)."""
    cfg, args = parse_config(defaults, prog, argv)

    def build(c):
        return make_trainer(c, algorithm, args.n_train, args.n_test)

    return run_driver(prog, build(cfg), independent, log, rebuild=build)


def run_driver(prog: str, trainer: BlockwiseFederatedTrainer,
               independent: bool = False, log=print,
               rebuild: Optional[Callable] = None):
    """Run the driver ``prog``'s trainer; returns (trainer, state,
    history).  ``independent``: the no-consensus baseline
    (``run_independent``).  The mid-run checkpoint (``--midrun-checkpoint``)
    lives at ``<checkpoint_dir>/<prog>_midrun``; ``--load-model`` resumes
    it, else starts from the end-of-run checkpoint (:func:`maybe_load`).
    With ``--max-restarts`` the run is supervised
    (``control/supervisor.py``): the mid-run checkpoint is on, and each
    restart resumes it on a trainer ``rebuild(cfg)`` makes from the
    attempt's (from the second restart on, degraded) configuration.  A
    campaign (``--campaign-spec``) turns the mid-run checkpoint on (its
    deterministic preemptions need a resume point) and runs under the
    soak harness (``campaign/harness.py`` ``run_soak``), which prints its
    virtual clock."""
    cfg = trainer.cfg
    trainer.obs_run_name = prog
    mname = type(trainer.model).__name__
    if mname == "ResNet":
        mname = f"ResNet{trainer.model.qualifier}"
    log(f"{prog}: K={cfg.K} model={mname} devices={trainer.D} "
        f"clients/device={trainer.K_local} data={trainer.data.source} "
        f"device={trainer.device}")
    state = maybe_load(trainer, prog, log)
    if independent:
        state, history = trainer.run_independent(state, log=log)
    else:
        supervised = cfg.max_restarts > 0
        campaign = cfg.campaign_spec not in ("none", "", None)
        ck = (checkpoint_path(cfg, prog + "_midrun")
              if cfg.midrun_checkpoint or supervised or campaign else None)
        if supervised or campaign:
            box = {"trainer": trainer}

            def build_trainer(c, attempt):
                if attempt > 1:
                    # the failed attempt's trainer is closed
                    box["trainer"] = rebuild(c)
                    box["trainer"].obs_run_name = prog
                return box["trainer"]

            kw = dict(state=state, resume=cfg.load_model,
                      run_kwargs={"log": log}, log=log,
                      engine=("vae" if trainer.obs_engine.startswith("vae")
                              else "classifier"))
            if campaign:
                (state, history), clock = run_soak(
                    build_trainer, cfg, ck, run_name=prog, **kw)
                log(f"soak campaign done: {clock!r}")
            else:
                state, history = supervise_classifier(
                    build_trainer, cfg, ck, **kw)
            trainer = box["trainer"]
        else:
            state, history = trainer.run(
                state, log=log, checkpoint_path=ck,
                resume=cfg.load_model and ck is not None)
    finish(trainer, state, prog, history, log)
    print_obs_artifact(trainer, log)
    log("Finished Training")
    return trainer, state, history
