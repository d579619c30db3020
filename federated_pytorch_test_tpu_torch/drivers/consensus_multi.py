"""ADMM consensus over K CIFAR-10 clients, on the card.

Port of ``federated_pytorch_test_tpu/drivers/consensus_multi.py`` (reference
consensus_multi.py: K=10, Nloop=12, Nepoch=1, Nadmm=5, admm_rho0=0.1,
biased_input=True, bb_update off).  Clients are never reset to z: consensus
only through the augmented-Lagrangian penalty.  ``--device`` defaults to
``cuda``; ``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.consensus_multi \\
        --model resnet18 --robust-agg krum --robust-chunked --num-devices 2
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers.common import run_classifier_driver
from federated_pytorch_test_tpu_torch.train.algorithms import AdmmConsensus
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig

DEFAULTS = FederatedConfig(K=10, Nloop=12, Nepoch=1, Nadmm=5,
                           admm_rho0=0.1, biased_input=True)


def main(argv=None, log=print):
    """Run consensus_multi; returns (trainer, state, history)."""
    return run_classifier_driver("consensus_multi", DEFAULTS, AdmmConsensus(),
                                 argv=argv, log=log)


if __name__ == "__main__":
    main()
