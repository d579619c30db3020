"""The virtual-client registry: host state for every registered client.

Port of ``federated_pytorch_test_tpu/population/registry.py`` (numpy, the
same code).  ``cfg.population`` registered clients exist as rows of a few
host numpy ledgers (quarantine sentences, churn membership, the buffered
async arrival schedule, sampling and guard counters) plus a sparse store
of compressor/EF state rows.  Only the round's cohort (``cfg.K`` ids drawn
by ``population/sampler.py``) reaches the card: the round kernel gathers
the cohort's ledger rows into its [K] slot arrays before the round and
scatters them back afterwards.

Persistence: :meth:`meta` / :meth:`restore` carry the ledgers and the
stored compressor rows in the mid-run checkpoint meta under ``pop_*``
keys.  ``population == cohort`` marks the registry ``identity`` and the
engine skips every gather/scatter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from federated_pytorch_test_tpu_torch.population.sampler import (
    SAMPLER_CHOICES,
    cohort_slot_mask,
    sample_cohort,
)


class ClientRegistry:
    """Host-side state for ``population`` registered virtual clients."""

    def __init__(self, population: int, cohort: int, seed: int,
                 sampling: str = "uniform"):
        if sampling not in SAMPLER_CHOICES:
            raise ValueError(
                f"cohort_sampling={sampling!r} must be one of "
                f"{SAMPLER_CHOICES}")
        if population < cohort:
            raise ValueError(
                f"population={population} must be >= the cohort size "
                f"K={cohort} (K slots must be fillable every round)")
        self.population = int(population)
        self.cohort = int(cohort)
        self.seed = int(seed)
        self.sampling = sampling
        #: population == cohort: sampling is the identity and the engine
        #: skips every gather/scatter (bitwise K=D contract)
        self.identity = self.population == self.cohort
        P = self.population
        # [P] ledgers — the registry-wide versions of the round kernel's
        # [K] slot arrays (RoundKernel._init_round_kernel)
        self.quarantine = np.zeros(P, np.int64)
        self.members = np.ones(P, bool)
        self.async_arrival = np.full(P, -1, np.int64)
        self.async_birth = np.zeros(P, np.int64)
        # sampling/telemetry counters (weighted-sampling inputs stay the
        # STATIC sampler weights — these are advisory, never drawn from)
        self.sampled_rounds = np.zeros(P, np.int64)
        self.active_rounds = np.zeros(P, np.int64)
        self.guard_trips = np.zeros(P, np.int64)
        # sparse per-client compressor/EF rows: rid -> tuple of leaf
        # rows, populated only for clients that have ever been sampled
        # in the current block (bounded by cohort x rounds, never P x N)
        self._comp_store: Dict[int, Tuple[np.ndarray, ...]] = {}

    # -- cohort draw ----------------------------------------------------
    def draw(self, nloop: int, ci: int, nadmm: int, frac: float = 1.0
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """This round's (sorted cohort ids, slot activity mask)."""
        ids = sample_cohort(self.population, self.cohort, seed=self.seed,
                            nloop=nloop, ci=ci, nadmm=nadmm,
                            method=self.sampling)
        mask = cohort_slot_mask(self.cohort, frac, seed=self.seed,
                                nloop=nloop, ci=ci, nadmm=nadmm)
        self.sampled_rounds[ids] += 1
        return ids, mask

    # -- ledger gather/scatter ------------------------------------------
    def gather_ledgers(self, cohort: np.ndarray, round_clock: int) -> dict:
        """Cohort rows of every ledger, as fresh [K] slot arrays.

        An in-flight async update whose scheduled arrival round passed
        while its sender was unsampled is clamped to deliver NOW
        (``arrival = round_clock``): the existing scheduler only checks
        ``arrival == nadmm``, so without the clamp a missed delivery
        would wedge its slot forever.  Staleness still measures from the
        true dispatch round (``birth``), so a late-because-unsampled
        update pays its real staleness at admission.
        """
        arrival = self.async_arrival[cohort].copy()
        late = (arrival >= 0) & (arrival < round_clock)
        arrival[late] = round_clock
        return {
            "quarantine": self.quarantine[cohort].copy(),
            "members": self.members[cohort].copy(),
            "arrival": arrival,
            "birth": self.async_birth[cohort].copy(),
        }

    def scatter_ledgers(self, cohort: np.ndarray, *, quarantine, members,
                        arrival, birth) -> None:
        """Write the round's slot arrays back to the cohort's rows."""
        self.quarantine[cohort] = quarantine
        self.members[cohort] = members
        self.async_arrival[cohort] = arrival
        self.async_birth[cohort] = birth

    def note_round(self, cohort: np.ndarray, active, tripped=None) -> None:
        """Advisory per-client counters (telemetry only)."""
        act = np.asarray(active)
        self.active_rounds[cohort[act > 0]] += 1
        if tripped is not None:
            self.guard_trips[cohort[np.asarray(tripped, bool)]] += 1

    # -- compressor/EF row persistence ----------------------------------
    def stash_comp_rows(self, cohort: np.ndarray,
                        leaves: List[np.ndarray], stacked: List[bool]
                        ) -> None:
        """Store the cohort's compressor rows (leaf ``i`` row ``k`` is
        client ``cohort[k]``'s state; non-client-stacked leaves are
        skipped — they are block-global, not per-client)."""
        for k, rid in enumerate(cohort.tolist()):
            self._comp_store[rid] = tuple(
                np.asarray(leaf[k]).copy() if is_k else None
                for leaf, is_k in zip(leaves, stacked))

    def load_comp_rows(self, cohort: np.ndarray,
                       fresh_leaves: List[np.ndarray],
                       stacked: List[bool]) -> List[np.ndarray]:
        """[K]-stacked leaves for the new cohort: a client's stored rows
        if it was sampled before this block, else this block's fresh
        init rows for the slot it landed in."""
        out = [leaf.copy() if is_k else leaf
               for leaf, is_k in zip(fresh_leaves, stacked)]
        for k, rid in enumerate(cohort.tolist()):
            rows = self._comp_store.get(rid)
            if rows is None:
                continue
            for i, is_k in enumerate(stacked):
                if is_k and rows[i] is not None:
                    out[i][k] = rows[i]
        return out

    @property
    def comp_rows(self) -> int:
        """Number of clients with stored compressor/EF rows (telemetry
        + the engine's first-round-of-block early-out)."""
        return len(self._comp_store)

    def drop_comp_rows(self, rids: np.ndarray) -> None:
        """Forget departed clients' compressor/EF rows: a returning
        client is a NEW client (the churn contract) and must re-enter
        on the fresh block init, not a stale residual."""
        for rid in np.nonzero(np.asarray(rids, bool))[0].tolist():
            self._comp_store.pop(rid, None)

    def reset_block(self) -> None:
        """Block boundary: in-flight updates are void (the flat block
        vector changes meaning) and so are the per-block EF rows — the
        registry mirrors ``RoundKernel._reset_block_ledgers``."""
        self.async_arrival[:] = -1
        self.async_birth[:] = 0
        self._comp_store.clear()

    # -- checkpoint meta -------------------------------------------------
    def meta(self, cohort: Optional[np.ndarray]) -> dict:
        """The registry's slice of the mid-run checkpoint meta (additive
        ``pop_*`` keys; population-off checkpoints never carry them)."""
        out = {
            "pop_population": np.asarray(self.population, np.int64),
            "pop_quarantine": self.quarantine.copy(),
            "pop_members": self.members.copy(),
            "pop_arrival": self.async_arrival.copy(),
            "pop_birth": self.async_birth.copy(),
            "pop_sampled": self.sampled_rounds.copy(),
            "pop_active": self.active_rounds.copy(),
            "pop_guard_trips": self.guard_trips.copy(),
        }
        if cohort is not None:
            # the checkpointed round's cohort: its slot rows (saved in
            # the state tree) belong to these ids on resume
            out["pop_cohort"] = np.asarray(cohort, np.int64)
        if self._comp_store:
            rids = sorted(self._comp_store)
            out["pop_comp_ids"] = np.asarray(rids, np.int64)
            rows0 = self._comp_store[rids[0]]
            out["pop_comp_nleaves"] = np.asarray(len(rows0), np.int64)
            for i in range(len(rows0)):
                if rows0[i] is not None:
                    out[f"pop_comp_leaf{i}"] = np.stack(
                        [self._comp_store[r][i] for r in rids])
        return out

    def restore(self, meta: dict) -> Optional[np.ndarray]:
        """Restore from checkpoint meta; returns the checkpointed
        round's cohort ids (None when the slot predates population mode
        — the registry then starts clean, exactly like the kernel's
        pre-ledger fallbacks)."""
        if "pop_population" not in meta:
            return None
        saved = int(meta["pop_population"])
        if saved != self.population:
            raise ValueError(
                f"checkpoint was written with population={saved}, this "
                f"run has population={self.population} — the registry "
                "id space must match to resume")
        self.quarantine = np.asarray(meta["pop_quarantine"], np.int64)
        self.members = np.asarray(meta["pop_members"], bool)
        self.async_arrival = np.asarray(meta["pop_arrival"], np.int64)
        self.async_birth = np.asarray(meta["pop_birth"], np.int64)
        self.sampled_rounds = np.asarray(meta["pop_sampled"], np.int64)
        self.active_rounds = np.asarray(meta["pop_active"], np.int64)
        self.guard_trips = np.asarray(meta["pop_guard_trips"], np.int64)
        self._comp_store.clear()
        if "pop_comp_ids" in meta:
            rids = np.asarray(meta["pop_comp_ids"], np.int64).tolist()
            nleaves = int(meta["pop_comp_nleaves"])
            leaves = [np.asarray(meta[f"pop_comp_leaf{i}"])
                      if f"pop_comp_leaf{i}" in meta else None
                      for i in range(nleaves)]
            for j, rid in enumerate(rids):
                self._comp_store[rid] = tuple(
                    None if lv is None else lv[j].copy() for lv in leaves)
        if "pop_cohort" in meta:
            return np.asarray(meta["pop_cohort"], np.int64)
        return None
