"""Run configuration of the port's trainers.

The subset of ``federated_pytorch_test_tpu/train/config.py``'s
``FederatedConfig`` that the ported paths read (the CPC trainer and the
classifier consensus round), with the JAX package's defaults, plus the
device the run uses.  A knob of the JAX package that is missing here is not
ported yet (``ROADMAP.md``); the drivers refuse it by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    K: int = 10                    # number of clients
    default_batch: int = 128       # minibatch size
    Nloop: int = 12                # loops over the whole network
    Nepoch: int = 1                # local epochs per round
    Nadmm: int = 3                 # communication rounds per block
    seed: int = 69                 # data-draw seed
    init_seed: int = 0             # common-init seed

    lambda1: float = 1e-4          # L1 on the fc blocks (reference quirk)
    lambda2: float = 1e-4          # L2
    admm_rho0: float = 1.0         # FedProx rho / ADMM penalty (0.1 consensus)

    init_model: bool = True        # Xavier kernels, 0.01 biases
    check_results: bool = True     # per-client test accuracy every round
    biased_input: bool = False     # per-client biased normalisation
    use_resnet: bool = False       # model "auto" -> resnet18 instead of net
    model: str = "auto"            # auto|net|net1|net2|resnet9|resnet18
    norm: str = "batch"            # ResNet norm: batch | group
    bf16: bool = False             # bfloat16 convs/dense (params stay f32)

    robust_agg: str = "none"       # none|trim|median|clip|krum|geomed
    trim_frac: float = 0.1         # trim fraction; krum's attacker fraction
    clip_mult: float = 3.0         # clip at this x the median client norm
    robust_chunked: bool = False   # segment-owned robust aggregation
    num_devices: Optional[int] = None  # client-mesh shards (None: one)

    bb_update: bool = False        # Barzilai-Borwein adaptive rho
    bb_period_T: int = 2
    bb_alphacorrmin: float = 0.2
    bb_epsilon: float = 1e-3
    bb_rhomax: float = 0.1

    optimizer: str = "adam"        # local optimizer ("lbfgs" not ported yet)
    lr: float = 1e-3

    data_dir: Optional[str] = None  # CIFAR-10 pickle batches (else synthetic)
    drop_last_sample: bool = True  # reference off-by-one parity
    prefetch: bool = True          # build epoch n+1's host batches ahead

    device: str = "cuda"           # "cuda" or "cpu" (the CPU only on request)
