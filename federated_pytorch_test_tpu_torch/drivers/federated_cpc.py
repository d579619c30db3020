"""Federated CPC on LOFAR visibilities (arXiv:1905.09272), on the card.

Port of ``federated_pytorch_test_tpu/drivers/federated_cpc.py``: the same
knob names and defaults (K=4 clients from the file list, Lc=256, Rc=32,
batch 128, patch 32, Niter=10, Nloop=1, Nadmm=1, L-BFGS history 7 and
max_iter 2), plus ``--device`` (default ``cuda``; ``cpu`` only on request).
Files that are absent fall back to deterministic synthetic visibility
cubes keyed on (file, SAP) — see ``data/lofar.py``.

    python -m federated_pytorch_test_tpu_torch.drivers.federated_cpc
"""

from __future__ import annotations

import argparse

from federated_pytorch_test_tpu_torch.data.lofar import CPCDataSource
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.cpc_engine import CPCTrainer

DEFAULT_FILES = ["L785751.MS_extract.h5", "L785751.MS_extract.h5",
                 "L785747.MS_extract.h5", "L785757.MS_extract.h5"]
DEFAULT_SAPS = ["1", "2", "0", "0"]

#: reference defaults: K comes from the file list, one outer loop, one
#: communication round per block
DEFAULTS = FederatedConfig(K=4, Nloop=1, Nadmm=1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="federated_cpc",
        description="Federated CPC on LOFAR visibilities (PyTorch + CUDA)")
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
    p.add_argument("--Nloop", type=int, default=DEFAULTS.Nloop)
    p.add_argument("--Nadmm", type=int, default=DEFAULTS.Nadmm)
    p.add_argument("--seed", type=int, default=DEFAULTS.seed)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None, log=print):
    """Run the rotation; returns (trainer, final state, history)."""
    args = build_parser().parse_args(argv)
    data = CPCDataSource(args.file_list, args.sap_list,
                         batch_size=args.batch_size,
                         patch_size=args.patch_size, seed=args.seed)
    cfg = FederatedConfig(K=data.K, Nloop=args.Nloop, Nadmm=args.Nadmm,
                          seed=args.seed, device=args.device)
    trainer = CPCTrainer(data, latent_dim=args.Lc, reduced_dim=args.Rc,
                         Niter=args.Niter, cfg=cfg)
    log(f"federated_cpc: K={data.K} Lc={args.Lc} Rc={args.Rc} "
        f"device={trainer.device}")
    state, history = trainer.run(Nloop=cfg.Nloop, Nadmm=cfg.Nadmm, log=log)
    log("Finished Training")
    return trainer, state, history


if __name__ == "__main__":
    main()
