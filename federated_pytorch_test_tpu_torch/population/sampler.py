"""Seeded per-round cohort sampling over the client registry.

Port of ``federated_pytorch_test_tpu/population/sampler.py`` (numpy, the
same code).  Every draw is a pure function of ``(seed, nloop, ci, nadmm)``
plus static registry facts (population size, sampling method), so a
killed and resumed run redraws the identical cohort sequence.

Sampling methods (``cfg.cohort_sampling``):

- ``uniform``    — ``cohort`` ids drawn without replacement, equal odds.
- ``weighted``   — without replacement under static per-client
  availability weights (:func:`client_weights`, a pure function of
  ``(seed, population)``).
- ``stratified`` — the id space is split into ``cohort`` contiguous
  strata and one id is drawn per stratum.

Identity: ``population == cohort`` returns ``arange(cohort)`` for every
method, so full participation is the engine without population.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: rng stream tags — distinct from the participation draw (11), the
#: compressor state init (23), and the restart backoff jitter (0xC791),
#: so no population draw can collide with an existing seeded stream
_COHORT_TAG = 31
_WEIGHT_TAG = 37
_ACTIVE_TAG = 41

SAMPLER_CHOICES = ("uniform", "weighted", "stratified")


def client_weights(population: int, seed: int) -> np.ndarray:
    """Static per-client availability weights in (0.5, 1.5).

    Drawn ONCE per (seed, population) — not per round — so weighted
    sampling stays a pure function of the run's configuration.
    """
    rng = np.random.default_rng([seed, _WEIGHT_TAG, population])
    return 0.5 + rng.random(population)


def sample_cohort(population: int, cohort: int, *, seed: int,
                  nloop: int, ci: int, nadmm: int,
                  method: str = "uniform") -> np.ndarray:
    """Draw this round's cohort: ``cohort`` SORTED registry ids.

    Sorted order is load-bearing twice over: device slot ``k`` hosts
    cohort id ``ids[k]``, so sorting makes the slot assignment itself a
    pure function of the draw (no tie-break ambiguity), and the
    ``population == cohort`` identity case degenerates to
    ``arange(cohort)`` — the bitwise K=D contract.
    """
    if method not in SAMPLER_CHOICES:
        raise ValueError(
            f"cohort_sampling={method!r} must be one of {SAMPLER_CHOICES}")
    if not 1 <= cohort <= population:
        raise ValueError(
            f"cohort size {cohort} outside [1, population={population}]")
    if population == cohort:
        return np.arange(cohort, dtype=np.int64)
    rng = np.random.default_rng([seed, _COHORT_TAG, nloop, ci, nadmm])
    if method == "uniform":
        ids = rng.choice(population, size=cohort, replace=False)
    elif method == "weighted":
        w = client_weights(population, seed)
        ids = rng.choice(population, size=cohort, replace=False,
                         p=w / w.sum())
    else:  # stratified: one id per contiguous stratum, already sorted
        bounds = [round(j * population / cohort) for j in range(cohort + 1)]
        ids = np.array([b + int(rng.integers(e - b))
                        for b, e in zip(bounds[:-1], bounds[1:])])
    return np.sort(ids).astype(np.int64)


def cohort_slot_mask(cohort: int, frac: float, *, seed: int,
                     nloop: int, ci: int, nadmm: int
                     ) -> Optional[np.ndarray]:
    """[cohort] f32 activity mask for the control plane's cohort rung.

    ``frac`` is the live ``cohort_frac`` knob: ``max(1, round(frac *
    cohort))`` slots stay active, chosen by a seeded draw in the round
    coordinates (a separate stream from the id draw, so shrinking the
    cohort never perturbs WHICH ids were sampled).  Returns None at frac >= 1 (the staged ones mask).
    """
    if frac >= 1.0:
        return None
    n_active = max(1, int(round(frac * cohort)))
    if n_active >= cohort:
        return None
    rng = np.random.default_rng([seed, _ACTIVE_TAG, nloop, ci, nadmm])
    mask = np.zeros(cohort, np.float32)
    mask[rng.permutation(cohort)[:n_active]] = 1.0
    return mask
