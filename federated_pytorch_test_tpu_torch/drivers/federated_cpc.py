"""Federated CPC on LOFAR visibilities (arXiv:1905.09272), on the card.

Port of ``federated_pytorch_test_tpu/drivers/federated_cpc.py``: the
shared flag surface of ``drivers/common.py`` (every ``FederatedConfig``
field the port has: ``--fault-spec``, ``--participation``,
``--update-guard``, ``--robust-agg``, ``--async-rounds``,
``--num-devices``, ``--midrun-checkpoint``, ``--obs-dir``,
``--max-restarts``, ``--campaign-spec``, ...) plus the CPC's data and
model knobs, with the
reference defaults (K=4 clients from the file list, Lc=256, Rc=32, batch
128, patch 32, Niter=10, Nloop=1, Nadmm=1, L-BFGS history 7 and max_iter
2) and ``--device`` (default ``cuda``; ``cpu`` only on request).  Flags
the CPC trainer cannot honour (``--compress``, ``--fused-collective``,
``--bb-update``) fail with its constructor's ValueError.  Files that are
absent fall back to deterministic synthetic visibility cubes keyed on
(file, SAP) — see ``data/lofar.py``.  A campaign runs as in the JAX
driver: its windows set each round's faults, and its ``preempt_at`` fires
only with a mid-run checkpoint, so it needs ``--max-restarts`` to be
survived (the supervisor here sleeps in real time; ``--campaign-accel``
scales the soak harness of the classifier drivers only).  ``--serve-spec``
raises "no serving adapter" at the first round's serving tick.

Checkpoints: the end-of-run save ``<checkpoint-dir>/federated_cpc`` (the
three sub-models' stacked client parameters; unless ``--no-save-model``),
which ``--load-model`` starts from; the mid-run slot
``<checkpoint-dir>/federated_cpc_midrun`` (``--midrun-checkpoint``, or
``--max-restarts``), which ``--load-model`` resumes first.  The record
stream goes to ``<checkpoint-dir>/obs/federated_cpc.jsonl``.

    python -m federated_pytorch_test_tpu_torch.drivers.federated_cpc
"""

from __future__ import annotations

import argparse
import os

from federated_pytorch_test_tpu_torch.control.supervisor import (
    ladder_overrides,
    ladder_records,
    supervise,
)
from federated_pytorch_test_tpu_torch.data.lofar import CPCDataSource
from federated_pytorch_test_tpu_torch.drivers import common
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.cpc_engine import (
    SUBMODELS,
    CPCTrainer,
)
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils.tree import tree_map

PROG = "federated_cpc"
DEFAULT_FILES = ["L785751.MS_extract.h5", "L785751.MS_extract.h5",
                 "L785747.MS_extract.h5", "L785757.MS_extract.h5"]
DEFAULT_SAPS = ["1", "2", "0", "0"]

#: reference defaults: K comes from the file list, one outer loop, one
#: communication round per block
DEFAULTS = FederatedConfig(K=4, Nloop=1, Nadmm=1, check_results=False)


def add_args(p: argparse.ArgumentParser) -> None:
    """The CPC's own knobs (none is a FederatedConfig field)."""
    p.description = "Federated CPC on LOFAR visibilities (PyTorch + CUDA)"
    p.add_argument("--file-list", nargs="+", default=DEFAULT_FILES)
    p.add_argument("--sap-list", nargs="+", default=DEFAULT_SAPS)
    p.add_argument("--Lc", type=int, default=256,
                   help="CPC latent dimension (reference Lc)")
    p.add_argument("--Rc", type=int, default=32,
                   help="reduced/context dimension (reference Rc)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--patch-size", type=int, default=32)
    p.add_argument("--Niter", type=int, default=10,
                   help="L-BFGS data batches per client per round")


def build_parser() -> argparse.ArgumentParser:
    p = common.build_parser(DEFAULTS, PROG)
    add_args(p)
    return p


def main(argv=None, log=print):
    """Run the rotation; returns (trainer, final state, history)."""
    cfg, args = common.parse_config(DEFAULTS, PROG, argv, add_args)
    data = CPCDataSource(args.file_list, args.sap_list,
                         batch_size=args.batch_size,
                         patch_size=args.patch_size, seed=cfg.seed)

    def make(c):
        t = CPCTrainer(data, latent_dim=args.Lc, reduced_dim=args.Rc,
                       Niter=args.Niter, cfg=c)
        t.obs_run_name = PROG
        return t

    trainer = make(cfg)
    log(f"federated_cpc: K={data.K} Lc={args.Lc} Rc={args.Rc} "
        f"devices={trainer.D} device={trainer.device}")
    state = trainer.state0
    path = common.checkpoint_path(cfg, PROG)
    if cfg.load_model and os.path.isdir(os.path.abspath(
            os.path.expanduser(path))):
        tree, _ = ckpt.load_checkpoint(path)
        state = {m: tree_map(lambda v: trainer._own(v).to(trainer.device),
                             ckpt.unflatten_dict(tree, m + "/"))
                 for m in SUBMODELS}
        log(f"loaded checkpoint <- {path}")
    supervised = cfg.max_restarts > 0
    # supervision is resume-from-checkpoint: a restart budget turns the
    # mid-run checkpoint on
    midrun = (common.checkpoint_path(cfg, PROG + "_midrun")
              if cfg.midrun_checkpoint or supervised else None)
    run_kw = dict(Nloop=cfg.Nloop, Nadmm=cfg.Nadmm, log=log,
                  checkpoint_path=midrun)
    if supervised:
        box = {"trainer": trainer}

        def run_attempt(attempt, resume_now):
            if attempt > 1:
                # a fresh trainer on the attempt's configuration (from the
                # second restart on, the ladder's; engine "cpc" skips the
                # rungs the CPC cannot build) resumes the mid-run slot
                _, degraded, _ = ladder_overrides(cfg, attempt - 1,
                                                  engine="cpc")
                box["trainer"] = make(degraded)
            t = box["trainer"]
            st = state if attempt == 1 else t.state0
            return t.run(state=st, resume=cfg.load_model or resume_now,
                         **run_kw)

        def describe(attempt, exc=None):
            rec = box["trainer"].obs_recorder
            jsonl_path = getattr(rec, "jsonl_path", None)
            run_id = getattr(rec, "run_id", "") or ""
            ridx = getattr(rec, "_last_index", -1)
            if not isinstance(ridx, int):
                ridx = -1
            extra = []
            if attempt <= max(0, cfg.max_restarts):
                extra = ladder_records(cfg, attempt, run_id=run_id,
                                       ridx=ridx, engine="cpc")
            return jsonl_path, run_id, extra

        state, history = supervise(
            run_attempt, max_restarts=cfg.max_restarts,
            backoff_base=cfg.restart_backoff, seed=cfg.seed,
            describe=describe, log=log)
        trainer = box["trainer"]
    else:
        state, history = trainer.run(
            state=state, resume=cfg.load_model and midrun is not None,
            **run_kw)
    if cfg.save_model:
        tree = {}
        for m in SUBMODELS:
            tree.update(ckpt.flatten_dict(
                tree_map(trainer._full_leaf, state[m]), m + "/"))
        ckpt.save_checkpoint(path, tree, {"rounds": len(history)})
        log(f"saved checkpoint -> {path}")
    common.print_obs_artifact(trainer, log)
    log("Finished Training")
    return trainer, state, history


if __name__ == "__main__":
    main()
