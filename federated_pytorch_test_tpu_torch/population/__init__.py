"""Population federation: virtual-client registry and seeded cohort sampling.

Port of ``federated_pytorch_test_tpu/population/``: numpy only, copied so
that a cohort draw and a registry ledger replay bit for bit in either
package.  ``cfg.population`` registered clients share the ``cfg.K`` slots
of a round; ``sampler`` draws each round's cohort as a pure function of
(seed, round coordinates) and ``registry`` keeps the per-client host state
(quarantine, membership, async ledger, compressor/EF rows).
"""

from federated_pytorch_test_tpu_torch.population.registry import ClientRegistry
from federated_pytorch_test_tpu_torch.population.sampler import (
    SAMPLER_CHOICES,
    cohort_slot_mask,
    sample_cohort,
)

__all__ = [
    "ClientRegistry",
    "SAMPLER_CHOICES",
    "cohort_slot_mask",
    "sample_cohort",
]
