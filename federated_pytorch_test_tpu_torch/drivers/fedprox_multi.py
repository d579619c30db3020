"""FedProx over K CIFAR-10 clients, on the card: the proximal term
(rho/2)||x - z||^2 in the local loss; z is never written back (the
reference's "master will send z to all slaves" has no put_trainable_values,
fedprox_multi.py:227).

Port of ``federated_pytorch_test_tpu/drivers/fedprox_multi.py`` (reference
fedprox_multi.py: K=10, Nloop=12, Nepoch=1, Nadmm=5, admm_rho0=1.0 — the
FedProx 'mu', biased_input=True).  ``--device`` defaults to ``cuda``;
``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.fedprox_multi \\
        --model resnet18
"""

from __future__ import annotations

from federated_pytorch_test_tpu_torch.drivers.common import run_classifier_driver
from federated_pytorch_test_tpu_torch.train.algorithms import FedProx
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig

DEFAULTS = FederatedConfig(K=10, Nloop=12, Nepoch=1, Nadmm=5,
                           admm_rho0=1.0, biased_input=True)


def main(argv=None, log=print):
    """Run fedprox_multi; returns (trainer, state, history)."""
    return run_classifier_driver("fedprox_multi", DEFAULTS, FedProx(),
                                 argv=argv, log=log)


if __name__ == "__main__":
    main()
