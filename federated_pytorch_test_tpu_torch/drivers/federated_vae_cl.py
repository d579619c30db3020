"""Federated clustering VAE (arXiv:2005.04613) on the card: FedAvg on
``AutoEncoderCNNCL``, three blocks with a per-block Adam/L-BFGS switch.

Port of ``federated_pytorch_test_tpu/drivers/federated_vae_cl.py``
(reference federated_vae_cl.py: K=1, Kc=10 clusters, Lc=32 latent,
Nloop=12, Nepoch=1, Nadmm=3, lambda2=1e-3, L-BFGS history 10 and 4
iterations on the encoder and decoder, Adam lr 1e-4 on the latent block,
z written back).  ``--device`` defaults to ``cuda``; ``cpu`` runs only
when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.federated_vae_cl --Kc 10 --Lc 32
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers import common
from federated_pytorch_test_tpu_torch.models.vae_cl import AutoEncoderCNNCL
from federated_pytorch_test_tpu_torch.train.algorithms import FedAvg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.vae_engine import VAECLTrainer

PROG = "federated_vae_cl"
DEFAULTS = FederatedConfig(K=1, Nloop=12, Nepoch=1, Nadmm=3,
                           lambda2=1e-3, biased_input=False,
                           check_results=False,
                           lbfgs_history_size=10, lbfgs_max_iter=4)
#: what the driver sets itself (the model, each block's optimizer and Adam
#: rate, no L1), so that their flags are refused rather than ignored
FIXED = ("model", "use_resnet", "norm", "bf16", "optimizer", "lr",
         "lambda1")


def add_args(p) -> None:
    p.add_argument("--Kc", type=int, default=10,
                   help="number of clusters (federated_vae_cl.py:22)")
    p.add_argument("--Lc", type=int, default=32,
                   help="latent dimension (federated_vae_cl.py:23)")


def build(argv=None) -> VAECLTrainer:
    """The driver's trainer from its flags ``argv``."""
    cfg, args = common.parse_config(DEFAULTS, PROG, argv, add_args, FIXED)
    return common.make_trainer(cfg, FedAvg(), args.n_train, args.n_test,
                               AutoEncoderCNNCL(K=args.Kc, L=args.Lc),
                               VAECLTrainer)


def main(argv=None, log=print):
    """Run federated_vae_cl; returns (trainer, state, history)."""
    return common.run_driver(PROG, build(argv), log=log)


if __name__ == "__main__":
    main()
