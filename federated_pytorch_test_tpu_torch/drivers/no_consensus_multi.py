"""The baseline: K independent CIFAR-10 models, no parameter exchange ever,
on the card.

Port of ``federated_pytorch_test_tpu/drivers/no_consensus_multi.py``
(reference no_consensus_multi.py: K=10, Nepoch=20, Adam lr=1e-3, Adam
re-created every epoch, the full net trainable, biased_input=True).
``--device`` defaults to ``cuda``; ``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.no_consensus_multi \\
        --model resnet18
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers.common import run_classifier_driver
from federated_pytorch_test_tpu_torch.train.algorithms import NoConsensus
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig

DEFAULTS = FederatedConfig(K=10, Nepoch=20, biased_input=True)


def main(argv=None, log=print):
    """Run no_consensus_multi; returns (trainer, state, history), one
    record per epoch."""
    return run_classifier_driver("no_consensus_multi", DEFAULTS,
                                 NoConsensus(), independent=True, argv=argv,
                                 log=log)


if __name__ == "__main__":
    main()
