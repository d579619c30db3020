"""The robustness shell of a communication round, for any engine.

Port of ``RoundKernel`` of ``federated_pytorch_test_tpu/train/rounds.py``
without the campaign schedule, the serving plane, the control plane and
the observability fan-out.  Everything here is host-side bookkeeping:
seeded mask draws, the quarantine, async, churn and population ledgers,
and their slice of the mid-run checkpoint meta.  The engine runs the
round's tensor work and hands the kernel back the guard verdicts.

Host-class contract (what the mixin reads):

==========================  ===========================================
``self.cfg``                a :class:`~.config.FederatedConfig`
``self.D``                  the client mesh's device count
``self._ckpt_writer``       async checkpoint writer or None
``_init_comp_state(ci)``    fresh [K]-stacked compressor state of block
                            ``ci`` (reached from ``_reset_comp_rows``)
==========================  ===========================================

A mixin, so that the CPC trainer can compose it too.  The masks come back
as numpy ``[K]`` float32 arrays; the engine moves them to its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.parallel.mesh import CollectiveTimeoutError
from federated_pytorch_test_tpu_torch.population import ClientRegistry
from federated_pytorch_test_tpu_torch.population.sampler import SAMPLER_CHOICES
from federated_pytorch_test_tpu_torch.train.faults import FaultSpec
from federated_pytorch_test_tpu_torch.utils.checkpoint import mesh_geometry_meta
from federated_pytorch_test_tpu_torch.utils.tree import map_leaves


class RoundKernel:
    """Mixin: the engine-agnostic host slice of a communication round."""

    # ------------------------------------------------------------------
    # construction: ledgers, fault layer, validation
    # ------------------------------------------------------------------
    def _init_round_kernel(self) -> None:
        """Parse the fault spec and build every host-side round ledger.
        Call once from the engine's ``__init__`` after ``self.cfg`` is
        set."""
        cfg = self.cfg
        self.faults = FaultSpec.parse(cfg.fault_spec)
        # per-client remaining quarantine rounds and the per-block running
        # guard norm scale (inf: no bound until one clean round)
        self._quarantine = np.zeros(cfg.K, np.int64)
        self._guard_scale = float("inf")
        # buffered async: scheduled arrival round (-1: nothing in flight),
        # dispatch round of the update in flight, run-scoped rejections
        self._async_arrival = np.full(cfg.K, -1, np.int64)
        self._async_birth = np.zeros(cfg.K, np.int64)
        self._async_rejected = 0
        # churn membership (everyone present at the start) and the one-shot
        # arming of the simulated preemption
        self._members = np.ones(cfg.K, bool)
        self._rejoined_mask = np.zeros(cfg.K, bool)
        self._members_joined = 0
        self._members_left = 0
        self._preempt_armed = True
        # population: the registry keeps the [population] ledgers; each
        # round swaps the cohort's rows into the [K] slot arrays above
        self._registry: Optional[ClientRegistry] = None
        self._cohort = None                  # this round's sorted ids
        self._pop_slot_mask = None           # the cohort_frac mask
        self._cohort_frac = float(cfg.cohort_frac)
        self._pop_comp_prev = None           # cohort owning state.comp rows
        if cfg.population:
            self._registry = ClientRegistry(
                cfg.population, cfg.K, cfg.seed,
                sampling=cfg.cohort_sampling)

    @property
    def _churn_live(self) -> bool:
        """Can this run's membership ledger ever move?"""
        return self.faults.churn_enabled

    @property
    def _pop_active(self) -> bool:
        """Population mode live (registered clients > cohort)?  False for
        population off and for the identity registry."""
        return self._registry is not None and not self._registry.identity

    @property
    def _partial(self) -> bool:
        """Do rounds carry activity masks?  Partial participation, faults,
        the guard, async rounds and a rotating cohort all mask clients out;
        with every knob off the round is the full-participation one."""
        cfg = self.cfg
        return (cfg.participation < 1.0 or self.faults.enabled
                or cfg.update_guard or cfg.async_rounds
                or (cfg.population > 0 and cfg.population != cfg.K))

    def _validate_round_cfg(self) -> None:
        """Construction-time validation of the robustness knobs, with the
        JAX package's messages."""
        cfg = self.cfg
        if not 0.0 < cfg.participation <= 1.0:
            raise ValueError(
                f"participation={cfg.participation} must be in (0, 1]")
        if cfg.participation < 1.0 and cfg.bb_update:
            raise ValueError(
                "participation < 1 is incompatible with bb_update: the BB "
                "spectral history (x0/yhat0 deltas) assumes every client "
                "moves every round (consensus_multi.py:242-278)")
        if cfg.bb_update and (self.faults.enabled or cfg.update_guard):
            raise ValueError(
                "fault injection / update guards are incompatible with "
                "bb_update: both can mask clients out of a round, and the "
                "BB spectral history (x0/yhat0 deltas) assumes every "
                "client moves every round (consensus_multi.py:242-278)")
        if cfg.async_rounds:
            if cfg.bb_update:
                raise ValueError(
                    "async_rounds is incompatible with bb_update: the BB "
                    "spectral history assumes every client moves in "
                    "lockstep rounds (consensus_multi.py:242-278)")
            if cfg.max_staleness < 0:
                raise ValueError(
                    f"max_staleness={cfg.max_staleness} must be >= 0")
            if cfg.staleness_alpha < 0:
                raise ValueError(
                    f"staleness_alpha={cfg.staleness_alpha} must be >= 0")
        if cfg.quarantine_rounds < 0:
            raise ValueError(
                f"quarantine_rounds={cfg.quarantine_rounds} must be >= 0")
        pop = int(cfg.population)
        if pop < 0:
            raise ValueError(f"population={pop} must be >= 0 (0 = off)")
        if pop:
            if pop < cfg.K:
                raise ValueError(
                    f"population={pop} must be >= K={cfg.K}: the cohort "
                    "fills every device slot each round (use "
                    "population=0 to turn virtualization off)")
            if cfg.bb_update and pop != cfg.K:
                raise ValueError(
                    "population sampling is incompatible with bb_update: "
                    "the BB spectral history assumes the SAME clients "
                    "move every round (consensus_multi.py:242-278), and "
                    "a rotating cohort re-seats the [K] slots")
            if cfg.cohort_sampling not in SAMPLER_CHOICES:
                raise ValueError(
                    f"cohort_sampling={cfg.cohort_sampling!r} must be "
                    f"one of {SAMPLER_CHOICES}")
        if not 0.0 < cfg.cohort_frac <= 1.0:
            raise ValueError(
                f"cohort_frac={cfg.cohort_frac} must be in (0, 1]")
        if cfg.guard_norm_mult <= 0:
            raise ValueError(
                f"guard_norm_mult={cfg.guard_norm_mult} must be positive")

    # ------------------------------------------------------------------
    # per-round activity: participation x quarantine x faults x churn
    # ------------------------------------------------------------------
    def _participation_host(self, nloop: int, ci: int, nadmm: int):
        """[K] f32 participation draw of the round (tag 11), stateless in
        the round coordinates, with at least one participant.  Under
        population mode the draw is over the whole registry, then the
        cohort's rows."""
        rng = np.random.default_rng(
            [self.cfg.seed, 11, nloop, ci, nadmm])
        if self._pop_active:
            mP = (rng.random(self._registry.population)
                  < self.cfg.participation).astype(np.float32)
            m = mP[self._cohort]
        else:
            m = (rng.random(self.cfg.K)
                 < self.cfg.participation).astype(np.float32)
        if not m.any():
            m[int(rng.integers(self.cfg.K))] = 1.0
        return m

    def _population_round_begin(self, nloop: int, ci: int,
                                nadmm: int) -> None:
        """Rotate the registry cohort for this round: scatter the previous
        cohort's slot ledgers back, draw this round's cohort, gather its
        rows into the [K] slot arrays.  The async late-arrival clamp runs
        on ``nadmm``, the clock of the arrival schedule."""
        if not self._pop_active:
            return
        reg = self._registry
        if self._cohort is not None:
            reg.scatter_ledgers(self._cohort, quarantine=self._quarantine,
                                members=self._members,
                                arrival=self._async_arrival,
                                birth=self._async_birth)
        ids, mask = reg.draw(nloop, ci, nadmm, self._cohort_frac)
        led = reg.gather_ledgers(ids, nadmm)
        self._cohort = ids
        self._pop_slot_mask = mask
        self._quarantine = led["quarantine"]
        self._members = led["members"]
        self._async_arrival = led["arrival"]
        self._async_birth = led["birth"]

    def _round_faults_cohort(self, nloop: int, ci: int, nadmm: int):
        """This round's (drop, straggle, corrupt) [K] vectors; population
        mode draws over the whole registry and takes the cohort's rows."""
        faults = self.faults
        if self._pop_active:
            dP, sP, cP = faults.round_faults(
                self._registry.population, nloop, ci, nadmm)
            c = self._cohort
            return dP[c], sP[c], cP[c]
        return faults.round_faults(self.cfg.K, nloop, ci, nadmm)

    def _round_activity(self, nloop: int, ci: int, nadmm: int):
        """This round's masks: ``(train, comm, corrupt, comm_host,
        counts)``, numpy [K] float32 (``comm_host`` is ``comm``).

        ``train``: clients that run local epochs (a straggler ships its
        round-start params, so it is in ``comm`` only); ``comm``: clients
        in the exchange (the fractional staleness weights under async
        rounds); ``corrupt``: 1 where the shipped delta is poisoned;
        ``counts``: ``n_comm`` and the ``fault_*``, churn and async counts
        for the round record (empty on the fast path)."""
        cfg, faults = self.cfg, self.faults
        self._population_round_begin(nloop, ci, nadmm)
        # churn ticks once per round, before the async delegation
        churn_counts = self._membership_tick(nloop, ci, nadmm)
        if cfg.async_rounds:
            return self._round_activity_async(nloop, ci, nadmm,
                                              churn_counts)
        quarantined = int(np.sum(self._quarantine > 0))
        zero = np.zeros(cfg.K, np.float32)
        if (not faults.enabled and quarantined == 0
                and self._pop_slot_mask is None):
            host = (np.ones(cfg.K, np.float32) if cfg.participation >= 1.0
                    else self._participation_host(nloop, ci, nadmm))
            return host, host, zero, host, {}
        base = (np.ones(cfg.K, np.float32) if cfg.participation >= 1.0
                else self._participation_host(nloop, ci, nadmm))
        if self._pop_slot_mask is not None:
            base = base * self._pop_slot_mask
        if self._churn_live:
            # a departed client is out of the round entirely
            base = base * self._members.astype(np.float32)
        ok = 1.0 - (self._quarantine > 0).astype(np.float32)
        drop = straggle = corrupt = zero
        if faults.enabled:
            drop, straggle, corrupt = self._round_faults_cohort(
                nloop, ci, nadmm)
        comm = base * ok * (1.0 - drop)
        train = comm * (1.0 - straggle)
        corrupt = corrupt * comm
        counts = {"n_comm": int(comm.sum())}
        if faults.enabled:
            counts.update(
                fault_dropped=int(np.sum(base * ok * drop)),
                fault_straggled=int(np.sum(comm * straggle)),
                fault_corrupted=int(np.sum(corrupt)))
        counts.update(churn_counts)
        return train, comm, corrupt, comm, counts

    def _membership_tick(self, nloop: int, ci: int, nadmm: int) -> dict:
        """Advance the churn membership ledger by one round: a departed
        client's quarantine and in-flight async update are void; a
        rejoining client is marked in ``_rejoined_mask`` (the round loop
        re-initialises its compressor rows).  Returns the record counts
        (empty when churn is off).  Population mode ticks the whole
        registry roster, then refreshes the slot views."""
        faults = self.faults
        if not self._churn_live:
            return {}
        if self._pop_active:
            reg = self._registry
            prevP = reg.members.copy()
            newP = faults.round_churn(prevP, nloop, ci, nadmm)
            joinedP = newP & ~prevP
            leftP = prevP & ~newP
            reg.members = newP
            if leftP.any():
                reg.quarantine[leftP] = 0
                reg.async_arrival[leftP] = -1
                reg.async_birth[leftP] = 0
                reg.drop_comp_rows(leftP)
            c = self._cohort
            led = reg.gather_ledgers(c, nadmm)
            self._quarantine = led["quarantine"]
            self._members = led["members"]
            self._async_arrival = led["arrival"]
            self._async_birth = led["birth"]
            self._rejoined_mask = joinedP[c]
            self._members_joined += int(joinedP.sum())
            self._members_left += int(leftP.sum())
            return {"members_active": int(newP.sum()),
                    "joined": int(joinedP.sum()),
                    "left": int(leftP.sum())}
        prev = self._members
        self._members = faults.round_churn(prev, nloop, ci, nadmm)
        joined = self._members & ~prev
        left = prev & ~self._members
        if left.any():
            self._quarantine[left] = 0
            self._async_arrival[left] = -1
            self._async_birth[left] = 0
        self._rejoined_mask = joined
        self._members_joined += int(joined.sum())
        self._members_left += int(left.sum())
        return {"members_active": int(self._members.sum()),
                "joined": int(joined.sum()),
                "left": int(left.sum())}

    def _maybe_preempt(self, nloop: int, ci: int, nadmm: int,
                       rounds_done: int, checkpoint_path) -> None:
        """Simulated slice preemption (``preempt=``): raises
        :class:`CollectiveTimeoutError` when armed (not on a resumed
        segment), once a round has been checkpointed, and after the async
        writer made that checkpoint durable."""
        faults = self.faults
        if (faults.preempt <= 0.0 or not self._preempt_armed
                or rounds_done == 0 or checkpoint_path is None):
            return
        if not faults.round_preempt(nloop, ci, nadmm):
            return
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        raise CollectiveTimeoutError(
            f"simulated preemption at round {rounds_done} "
            f"(nloop={nloop}, block={ci}, nadmm={nadmm}): fault spec "
            f"preempt={faults.preempt} drew this round",
            round_index=rounds_done)

    def _reset_comp_rows(self, comp, ci: int, mask: np.ndarray):
        """Re-initialise the compressor/EF rows of the clients in ``mask``
        (rejoining clients) to block ``ci``'s fresh init; leaves whose
        leading axis is not the client stack pass through."""
        fresh = self._init_comp_state(ci)
        K = self.cfg.K

        def sel(cur, new):
            if not isinstance(cur, torch.Tensor) or cur.dim() == 0 \
                    or cur.shape[0] != K:
                return cur
            m = torch.as_tensor(mask, device=cur.device)
            return torch.where(m.reshape((-1,) + (1,) * (cur.dim() - 1)),
                               new, cur)

        return map_leaves(sel, comp, fresh)

    def _round_activity_async(self, nloop: int, ci: int, nadmm: int,
                              churn_counts: Optional[dict] = None):
        """Buffered-async round schedule (``cfg.async_rounds``).

        A free client sampled this round dispatches: it trains now and its
        update spends ``faults.round_delays`` rounds in transit (its frozen
        params are the update in flight; it is out of train and comm until
        delivery).  Deliveries due this round pass the staleness admission
        (``staleness <= max_staleness``; rejects are counted) and join the
        exchange with weight ``(1 + s)^(-staleness_alpha)``.  Same return
        contract as ``_round_activity``, ``comm`` carrying the weights and
        ``counts`` the async telemetry."""
        cfg, faults = self.cfg, self.faults
        K = cfg.K
        base = (np.ones(K, np.float32) if cfg.participation >= 1.0
                else self._participation_host(nloop, ci, nadmm))
        if self._pop_slot_mask is not None:
            base = base * self._pop_slot_mask
        if self._churn_live:
            base = base * self._members.astype(np.float32)
        ok = 1.0 - (self._quarantine > 0).astype(np.float32)
        drop = straggle = corrupt = np.zeros(K, np.float32)
        if faults.enabled:
            drop, straggle, corrupt = self._round_faults_cohort(
                nloop, ci, nadmm)
        free = (self._async_arrival < 0).astype(np.float32)
        # a straggler still dispatches: its update in flight is its
        # round-start params
        dispatch = base * ok * (1.0 - drop) * free
        train = dispatch * (1.0 - straggle)
        if self._pop_active:
            delays = faults.round_delays(
                self._registry.population, nloop, ci, nadmm)[self._cohort]
        else:
            delays = faults.round_delays(K, nloop, ci, nadmm)
        d_idx = dispatch > 0
        self._async_arrival[d_idx] = nadmm + delays[d_idx]
        self._async_birth[d_idx] = nadmm
        # deliveries due this round (a delay-0 dispatch arrives in its own)
        arrive = self._async_arrival == nadmm
        stale = np.where(arrive, nadmm - self._async_birth, 0)
        admit = arrive & (stale <= cfg.max_staleness)
        reject = arrive & ~admit
        w = np.zeros(K, np.float32)
        w[admit] = (1.0 + stale[admit]) ** (-cfg.staleness_alpha)
        # every delivery frees its slot, admitted or rejected
        self._async_arrival[arrive] = -1
        self._async_rejected += int(reject.sum())
        # corruption poisons the wire at delivery
        corrupt = corrupt * admit.astype(np.float32)
        hist = np.bincount(stale[admit].astype(np.int64),
                           minlength=cfg.max_staleness + 1)
        counts = {
            "n_comm": int(admit.sum()),
            "async_arrived": int(arrive.sum()),
            "admission_rejected": int(reject.sum()),
            "buffer_depth": int(np.sum(self._async_arrival >= 0)),
            "staleness_hist": [int(c) for c in hist],
        }
        if faults.enabled:
            counts.update(
                fault_dropped=int(np.sum(base * ok * free * drop)),
                fault_straggled=int(np.sum(dispatch * straggle)),
                fault_corrupted=int(np.sum(corrupt)))
        counts.update(churn_counts or {})
        return train, w, corrupt, w, counts

    # ------------------------------------------------------------------
    # update guard: norm bound, verdicts, quarantine
    # ------------------------------------------------------------------
    def _round_gbound(self) -> np.float32:
        """The guard's norm bound: +inf until one accepted round of the
        block has calibrated the running scale."""
        if not (self.cfg.update_guard and np.isfinite(self._guard_scale)):
            return np.float32(np.inf)
        return np.float32(self.cfg.guard_norm_mult * self._guard_scale)

    def _apply_guard_verdicts(self, diag, okf, comm_host) -> None:
        """Quarantine this round's offenders (active and rejected), tick
        running sentences down a round, and fold the accepted norm scale
        into the bound (EMA of weight 0.5; the first clean round seeds
        it)."""
        cfg = self.cfg
        okf_h = np.asarray(okf)
        tripped = (comm_host > 0) & (okf_h < 0.5)
        self._quarantine = np.maximum(self._quarantine - 1, 0)
        if cfg.quarantine_rounds > 0:
            self._quarantine[tripped] = cfg.quarantine_rounds
        if self._pop_active:
            self._registry.note_round(self._cohort, comm_host, tripped)
        if diag.get("n_ok", 0.0) > 0:
            nm = diag["guard_norm_mean"]
            self._guard_scale = (
                nm if not np.isfinite(self._guard_scale)
                else 0.5 * self._guard_scale + 0.5 * nm)

    # ------------------------------------------------------------------
    # ledger checkpoint meta
    # ------------------------------------------------------------------
    def _ledger_meta(self) -> dict:
        """The kernel's slice of the mid-run checkpoint meta: mesh geometry,
        churn membership, guard, async and registry ledgers."""
        meta = {}
        meta.update(mesh_geometry_meta(
            devices=self.D, processes=1, K=self.cfg.K,
            members=self._members if self._churn_live else None))
        if self._churn_live:
            meta["members_joined"] = np.asarray(self._members_joined,
                                                np.int64)
            meta["members_left"] = np.asarray(self._members_left, np.int64)
        if self.cfg.update_guard:
            meta["quarantine"] = np.asarray(self._quarantine, np.int64)
            meta["guard_scale"] = np.asarray(self._guard_scale, np.float64)
        if self.cfg.async_rounds:
            meta["async_arrival"] = np.asarray(self._async_arrival, np.int64)
            meta["async_birth"] = np.asarray(self._async_birth, np.int64)
            meta["async_rejected"] = np.asarray(self._async_rejected,
                                                np.int64)
        if self._pop_active:
            # scatter the live cohort's slot rows back first, so the
            # registry is whole at the cut
            if self._cohort is not None:
                self._registry.scatter_ledgers(
                    self._cohort, quarantine=self._quarantine,
                    members=self._members, arrival=self._async_arrival,
                    birth=self._async_birth)
            meta.update(self._registry.meta(self._cohort))
        return meta

    def _restore_ledger_meta(self, meta) -> None:
        """Restore the kernel ledgers from checkpoint meta (a slot without a
        ledger family starts that family clean)."""
        K = self.cfg.K
        if self.cfg.update_guard:
            if "quarantine" in meta:
                self._quarantine = np.asarray(meta["quarantine"], np.int64)
                self._guard_scale = float(meta["guard_scale"])
            else:
                self._quarantine = np.zeros(K, np.int64)
                self._guard_scale = float("inf")
        if self.cfg.async_rounds:
            if "async_arrival" in meta:
                self._async_arrival = np.asarray(meta["async_arrival"],
                                                 np.int64)
                self._async_birth = np.asarray(meta["async_birth"], np.int64)
                self._async_rejected = int(meta["async_rejected"])
            else:
                self._async_arrival = np.full(K, -1, np.int64)
                self._async_birth = np.zeros(K, np.int64)
                self._async_rejected = 0
        if self._churn_live:
            if "members" in meta:
                self._members = np.asarray(meta["members"], bool)
                self._members_joined = int(meta.get("members_joined", 0))
                self._members_left = int(meta.get("members_left", 0))
            else:
                self._members = np.ones(K, bool)
                self._members_joined = 0
                self._members_left = 0
            self._rejoined_mask = np.zeros(K, bool)
        if self._pop_active:
            # after the slot ledgers: pop_cohort names whose rows they are
            self._cohort = self._registry.restore(meta)
            self._pop_comp_prev = self._cohort
            self._pop_slot_mask = None

    def _reset_block_ledgers(self) -> None:
        """Block boundary: a fresh delta scale (no bound until one clean
        round) and every async update in flight void; the rejection
        counter is run-scoped and survives."""
        self._guard_scale = float("inf")
        self._async_arrival = np.full(self.cfg.K, -1, np.int64)
        self._async_birth = np.zeros(self.cfg.K, np.int64)
        if self._registry is not None:
            self._registry.reset_block()
            self._pop_comp_prev = None
