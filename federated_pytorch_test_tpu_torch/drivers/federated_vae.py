"""Federated VAE on the card: layer-wise FedAvg on ``AutoEncoderCNN`` over
K CIFAR-10 clients.

Port of ``federated_pytorch_test_tpu/drivers/federated_vae.py`` (reference
federated_vae.py: K=10, Nloop=12, Nepoch=1, Nadmm=3, Adam lr=1e-3,
biased_input=True, z written back every round, no evaluation a round).
``--device`` defaults to ``cuda``; ``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.federated_vae
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers import common
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.train.algorithms import FedAvg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.vae_engine import VAETrainer

PROG = "federated_vae"
DEFAULTS = FederatedConfig(K=10, Nloop=12, Nepoch=1, Nadmm=3,
                           biased_input=True, check_results=False)
#: what the driver sets itself (the model; the VAE has no regulariser), so
#: that their flags are refused rather than ignored
FIXED = ("model", "use_resnet", "norm", "bf16", "lambda1", "lambda2")


def build(argv=None) -> VAETrainer:
    """The driver's trainer from its flags ``argv``."""
    cfg, args = common.parse_config(DEFAULTS, PROG, argv, fixed=FIXED)
    return common.make_trainer(cfg, FedAvg(), args.n_train, args.n_test,
                               AutoEncoderCNN(), VAETrainer)


def main(argv=None, log=print):
    """Run federated_vae; returns (trainer, state, history)."""
    return common.run_driver(PROG, build(argv), log=log)


if __name__ == "__main__":
    main()
