"""Run configuration of the port's trainers.

The subset of ``federated_pytorch_test_tpu/train/config.py``'s
``FederatedConfig`` that the CPC path reads, with the JAX package's
defaults, plus the device the run uses.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    K: int = 10                    # number of clients
    Nloop: int = 12                # loops over the whole network
    Nadmm: int = 3                 # communication rounds per block
    seed: int = 69                 # data-draw seed
    init_seed: int = 0             # common-init seed
    device: str = "cuda"           # "cuda" or "cpu" (the CPU only on request)
