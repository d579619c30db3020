"""Blockwise FedAvg over K CIFAR-10 clients, on the card: average the
active block, write z back to every client.

Port of ``federated_pytorch_test_tpu/drivers/federated_multi.py``
(reference federated_multi.py: K=10, Nloop=12, Nepoch=1, Nadmm=3,
lambda1=lambda2=1e-4, Adam lr=1e-3, biased_input=True).  ``--device``
defaults to ``cuda``; ``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.federated_multi \\
        --model resnet18 --compress topk --error-feedback \\
        --fused-collective --num-devices 2
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers.common import run_classifier_driver
from federated_pytorch_test_tpu_torch.train.algorithms import FedAvg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig

DEFAULTS = FederatedConfig(K=10, Nloop=12, Nepoch=1, Nadmm=3,
                           biased_input=True)


def main(argv=None, log=print):
    """Run federated_multi; returns (trainer, state, history)."""
    return run_classifier_driver("federated_multi", DEFAULTS, FedAvg(),
                                 argv=argv, log=log)


if __name__ == "__main__":
    main()
