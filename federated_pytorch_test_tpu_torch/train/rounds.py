"""The robustness shell of a communication round, for any engine.

Port of ``RoundKernel`` of ``federated_pytorch_test_tpu/train/rounds.py``.
Everything here is host-side bookkeeping: seeded mask draws, the
quarantine, async, churn and population ledgers, their slice of the
mid-run checkpoint meta, the soak campaign's per-round window, the
serving plane's round tick, and the round's observability fan-out (the
round, client, campaign and serve records, the phase spans, the health
watchdog and the control plane's round-scope interventions).  The engine
runs the round's tensor work and hands the kernel back the guard
verdicts.

Host-class contract (what the mixin reads):

==========================  ===========================================
``self.cfg``                a :class:`~.config.FederatedConfig`
``self.algo``               strategy with ``.name``/``.communicates``
``self.D``                  the client mesh's device count
``self.mesh``               the client mesh (``.processes``)
``self.n_rows``, ``_own``   this process's client-row count, and its
                            rows of a ``[K, ...]`` array
``self.device``             the trainer's torch device
``self.obs_engine``         engine tag of the obs records
``self.obs_run_name``       run name override (drivers set it) or None
``self._ckpt_writer``       async checkpoint writer or None
``round_bytes_on_wire``     ``(N, n_clients) -> int`` wire-byte model
``_save_midrun``            ``(path, state, blockvars, nxt, history)``
                            (reached from ``_health_abort``)
``_flush_ckpt_writer()``    the async writer's barrier
``_init_comp_state(ci)``    fresh compressor state of block ``ci``, this
                            process's rows (from ``_reset_comp_rows``)
``_build_serve_plane``      ``(sched) -> dict`` and ``_serve_export``
                            ``(state) -> weights``: the serving adapter
                            (the base raises "no serving adapter")
==========================  ===========================================

A mixin, so that the CPC trainer can compose it too.  The masks come back
as numpy ``[K]`` float32 arrays; the engine moves them to its device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.campaign.schedule import (
    CampaignSchedule,
)
from federated_pytorch_test_tpu_torch.control.policy import (
    CONTROL_MODES,
    CONTROL_POLICIES,
    ControlRestart,
    controller_from_config,
)
from federated_pytorch_test_tpu_torch.obs import (
    client_round_fields,
    device_memory_stats,
    make_recorder,
)
from federated_pytorch_test_tpu_torch.obs.health import (
    HEALTH_ACTIONS,
    RunHealthAbort,
    monitor_from_config,
)
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    CollectiveTimeoutError,
    configure_barrier_timeout,
)
from federated_pytorch_test_tpu_torch.population import ClientRegistry
from federated_pytorch_test_tpu_torch.population.sampler import SAMPLER_CHOICES
from federated_pytorch_test_tpu_torch.serve.batcher import SERVE_TAG, ServeSchedule
from federated_pytorch_test_tpu_torch.train.faults import FaultSpec
from federated_pytorch_test_tpu_torch.utils.checkpoint import (
    NoUsableCheckpointError,
    finalize_checkpoint,
    mesh_geometry_meta,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves, map_leaves


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
        # the round's host waits on the card (round record ``host_syncs``;
        # the engine resets it at round start)
        self._host_syncs = 0
        self.faults = FaultSpec.parse(cfg.fault_spec)
        # soak campaign: _campaign_tick swaps self.faults for the window's
        # derived spec at every round entry; the parsed base (the disabled
        # spec: campaign and fault_spec exclude each other) keeps the
        # defaults.  The floor keeps a resumed segment from firing a
        # deterministic preempt_at again; the last emitted hour drives the
        # transition-only `campaign` record
        self.campaign = CampaignSchedule.parse(cfg.campaign_spec)
        self._campaign_base_faults = self.faults
        self._campaign_floor = -1
        self._campaign_window = None
        self._campaign_last_hour = None
        # serving plane: the schedule owns the pure per-round plan (no
        # serve state rides in the checkpoint); the runtime half is built
        # at the first serving round by the engine's _build_serve_plane;
        # _serve_forced is the control plane's pending forced refresh
        self._serve_sched = ServeSchedule.parse(cfg.serve_spec)
        self._serve_plane = None
        self._serve_forced = False
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
        # the round's per-client host arrays for the client record
        self._client_round: dict = {}
        # the last recorder a run opened; control-plane swaps of the
        # frozen cfg take the lock
        self.obs_recorder = None
        self._cfg_swap_lock = threading.Lock()

    @property
    def _client_probe(self) -> bool:
        """Client-grain flight recorder on (``cfg.client_ledger``) for an
        engine that exchanges?"""
        return bool(self.cfg.client_ledger) and self.algo.communicates

    @property
    def _churn_live(self) -> bool:
        """Can this run's membership ledger ever move?  A campaign with
        churn counts whatever its current window says (sticky, so that the
        ledger meta does not flap between windows)."""
        return (self.faults.churn_enabled
                or (self.campaign is not None and self.campaign.has_churn))

    @property
    def _pop_active(self) -> bool:
        """Population mode live (registered clients > cohort)?  False for
        population off and for the identity registry."""
        return self._registry is not None and not self._registry.identity

    @property
    def _partial(self) -> bool:
        """Do rounds carry activity masks?  Partial participation, faults,
        the guard, async rounds and a rotating cohort all mask clients out;
        with every knob off the round is the full-participation one.  Reads
        the current fault spec: the classifier engine freezes it a block
        (``_block_flags``), as the JAX engine's compiled step does."""
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
        if self.campaign is not None:
            if self.faults.enabled:
                raise ValueError(
                    "campaign_spec and fault_spec are mutually exclusive: "
                    "the campaign schedule OWNS the fault families' "
                    "probabilities per round (fold static fault knobs "
                    "into the campaign spec instead)")
            if cfg.bb_update:
                raise ValueError(
                    "campaign_spec is incompatible with bb_update: the "
                    "campaign's arrival/fault windows mask clients out "
                    "of rounds, and the BB spectral history assumes "
                    "every client moves every round "
                    "(consensus_multi.py:242-278)")
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
        if cfg.health_action not in HEALTH_ACTIONS:
            raise ValueError(
                f"health_action={cfg.health_action!r} must be one of "
                f"{HEALTH_ACTIONS}")
        if cfg.health_streak < 1:
            raise ValueError(
                f"health_streak={cfg.health_streak} must be >= 1")
        if cfg.health_window < 2:
            raise ValueError(
                f"health_window={cfg.health_window} must be >= 2")
        if cfg.health_loss_mult <= 1 or cfg.health_tput_frac <= 0:
            raise ValueError(
                "health_loss_mult must be > 1 and health_tput_frac > 0 "
                f"(got {cfg.health_loss_mult}, {cfg.health_tput_frac})")
        if cfg.control not in CONTROL_MODES:
            raise ValueError(
                f"control={cfg.control!r} must be one of {CONTROL_MODES}")
        if cfg.control_policy not in CONTROL_POLICIES:
            raise ValueError(
                f"control_policy={cfg.control_policy!r} must be one of "
                f"{CONTROL_POLICIES}")
        if cfg.max_restarts < 0:
            raise ValueError(
                f"max_restarts={cfg.max_restarts} must be >= 0")
        if cfg.restart_backoff < 0:
            raise ValueError(
                f"restart_backoff={cfg.restart_backoff} must be >= 0")
        if cfg.barrier_timeout < 0:
            raise ValueError(
                f"barrier_timeout={cfg.barrier_timeout} must be >= 0 "
                "(0 disables the bounded wait)")
        if cfg.barrier_timeout > 0:
            configure_barrier_timeout(cfg.barrier_timeout)

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
                and self._pop_slot_mask is None and self.campaign is None):
            host = (np.ones(cfg.K, np.float32) if cfg.participation >= 1.0
                    else self._participation_host(nloop, ci, nadmm))
            if self._client_probe:
                self._client_round = {"active": host, "weight": host}
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
        if self._client_probe:
            self._client_round = {
                "active": comm, "weight": comm,
                "quarantine": self._quarantine.copy(),   # round-start census
                "dropped": base * ok * drop,
                "straggled": comm * straggle,
                "corrupted": corrupt,
            }
            if self._churn_live:
                self._client_round["members"] = \
                    self._members.astype(np.float32)
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

    # ------------------------------------------------------------------
    # soak campaign: the round's window and its record
    # ------------------------------------------------------------------
    def _campaign_tick(self, rounds_done: int, nloop: int, ci: int,
                       nadmm: int, checkpoint_path) -> None:
        """Apply the campaign window of round ``rounds_done``: swap
        ``self.faults`` for the window's derived spec (the seeded families
        then draw with the campaign seed) and stash the window for the
        ``campaign`` record.  A deterministic ``preempt_at`` event raises
        :class:`CollectiveTimeoutError`, as the ``preempt=`` family does,
        once the newest checkpoint is durable; ``_campaign_floor`` (the
        resumed segment's first round) keeps it from firing again."""
        if self.campaign is None:
            return
        w = self.campaign.window(rounds_done)
        self.faults = self.campaign.spec_for(
            w, base=self._campaign_base_faults)
        self._campaign_window = w
        if (w.preempt_now and rounds_done > self._campaign_floor
                and rounds_done > 0 and checkpoint_path is not None):
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()
            raise CollectiveTimeoutError(
                f"campaign preemption at round {rounds_done} "
                f"(virtual hour {w.hour}): campaign spec preempt_at "
                f"scheduled this round", round_index=rounds_done)

    def _campaign_resume_floor(self, resumed: bool,
                               rounds_prior: int) -> None:
        """A segment's start: a resumed segment fires a ``preempt_at``
        event only strictly past its first round, and the transition-only
        ``campaign`` emission restarts with the segment."""
        self._campaign_floor = rounds_prior if resumed else -1
        self._campaign_last_hour = None

    def _emit_campaign_record(self, obs, round_index: int) -> None:
        """Transition-only ``campaign`` record, right after the round
        record: the segment's first round, every virtual-hour boundary and
        every preempted window (``CampaignSchedule.expected_emissions``)."""
        w = self._campaign_window
        if w is None or w.round_index != round_index:
            return
        if (self._campaign_last_hour is None
                or w.hour != self._campaign_last_hour or w.preempt_now):
            obs.campaign_event(self.campaign.record_fields(w))
        self._campaign_last_hour = w.hour

    # ------------------------------------------------------------------
    # serving plane: hot-swap, traffic and the `serve` record
    # ------------------------------------------------------------------
    def _build_serve_plane(self, sched) -> dict:
        """Engine hook: the serving runtime (predictor, hot-swap buffer,
        micro-batcher, host traffic pool and, for a classifier, the eval
        stream).  The base kernel has no model surface to serve."""
        raise ValueError(
            f"serve_spec is set but the {self.obs_engine!r} engine has "
            "no serving adapter (_build_serve_plane); serve with the "
            "classifier/VAE engines, or use serve.infer heads directly")

    def _serve_export(self, state):
        """Engine hook: the served consensus of the client state."""
        raise ValueError(
            f"the {self.obs_engine!r} engine has no serving adapter")

    def _serve_tick(self, obs, round_index: int, state, log=print) -> None:
        """One serving round at the round-obs boundary: publish when the
        schedule's swap sequence starts a new ``weights_version`` or a
        forced refresh is pending, answer the round's seeded traffic
        through the micro-batcher, score the answers on the eval stream
        and emit one ``serve`` record.  A forced refresh republishes the
        current consensus without bumping the version, so interventions
        never move the replay-checked swap sequence."""
        sched = self._serve_sched
        forced = self._serve_forced
        self._serve_forced = False
        if self._serve_plane is None:
            self._serve_plane = self._build_serve_plane(sched)
        plane = self._serve_plane
        fields = sched.record_fields(round_index)
        version = int(fields["weights_version"])
        gap = None
        if plane["buffer"].version != version or forced:
            gap = plane["buffer"].publish(version, self._serve_export(state),
                                          block=True)
        # request content: pool rows drawn on the tag-83 content substream
        # (replay checks the count, the schedule's requests_for draw)
        n = int(fields["requests"])
        rng = np.random.default_rng([sched.seed, SERVE_TAG, round_index, 2])
        idx = rng.integers(plane["pool_n"], size=n)
        # one snapshot for the whole drain: never torn even if a publish
        # landed mid-round
        _, plane["current"] = plane["buffer"].acquire()
        mb = plane["batcher"]
        pool_x = plane["pool_x"]
        for i in idx:
            mb.submit(pool_x[i])
        outs, tel = mb.drain()
        rec = dict(fields)
        rec["serve_p50_ms"] = round(tel["serve_p50_ms"], 6)
        rec["serve_p99_ms"] = round(tel["serve_p99_ms"], 6)
        rec["serve_qps"] = round(tel["serve_qps"], 6)
        if gap is not None:
            rec["swap_gap_seconds"] = round(gap, 6)
        if forced:
            rec["forced_refresh"] = True
            log(f"serve: forced refresh applied at round {round_index} "
                f"(version {version} republished)")
        stream = plane.get("stream")
        if stream is not None and plane.get("pool_y") is not None:
            rec.update(stream.score(round_index, np.stack(outs),
                                    plane["pool_y"][idx]))
        obs.serve_event(rec)

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
        rows = self.n_rows
        mask = self._own(np.asarray(mask))

        def sel(cur, new):
            if not isinstance(cur, torch.Tensor) or cur.dim() == 0 \
                    or cur.shape[0] != rows:
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
        if self._client_probe:
            self._client_round = {
                "active": admit.astype(np.float32), "weight": w.copy(),
                "quarantine": self._quarantine.copy(),
                "dropped": base * ok * free * drop,
                "straggled": dispatch * straggle,
                "corrupted": corrupt,
                # -1: no arrival this round
                "staleness": np.where(arrive, stale, -1).astype(np.int64),
                "admitted": admit.astype(np.float32),
            }
            if self._churn_live:
                self._client_round["members"] = \
                    self._members.astype(np.float32)
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
        if self._client_probe:
            self._client_round["guard_ok"] = okf_h
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
    # this process's client rows (all K with one process)
    # ------------------------------------------------------------------
    def _own(self, a):
        """This process's rows of a host or device ``[K, ...]`` array."""
        if self.mesh.processes == 1:
            return a
        return a[self.rows.start:self.rows.stop]

    def _own_leaf(self, t):
        """:meth:`_own` of a leaf whose leading axis is the client axis;
        other leaves pass through."""
        if isinstance(t, torch.Tensor) and t.dim() >= 1 \
                and t.shape[0] == self.cfg.K:
            return self._own(t)
        return t

    def _full_leaf(self, t):
        """The whole ``[K, ...]`` of a leaf of this process's client rows
        (gathered across the ranks); other leaves pass through."""
        if self.mesh.processes > 1 and isinstance(t, torch.Tensor) \
                and t.dim() >= 1 and t.shape[0] == self.n_rows:
            return self.mesh.gather_rows(t)
        return t

    def _full_opt_leaves(self, opt) -> list:
        """The leaves of the whole K-client optimizer state: Adam's stacks
        gathered, or every client's L-BFGS state in client order."""
        if isinstance(opt, list):
            return leaves(self.mesh.gather_objects(opt))
        return [self._full_leaf(torch.as_tensor(t)) for t in leaves(opt)]

    def _own_opt_leaves(self, template, full: list) -> list:
        """This process's share of ``full``, the leaves
        :meth:`_full_opt_leaves` saved, for ``template``'s structure: its
        clients' L-BFGS states (client after client), or its rows of
        Adam's stacks."""
        if isinstance(template, list):
            per = len(full) // self.cfg.K
            return full[self.rows.start * per:self.rows.stop * per]
        return [self._own_leaf(t) for t in full]

    # ------------------------------------------------------------------
    # ledger checkpoint meta
    # ------------------------------------------------------------------
    def _ledger_meta(self) -> dict:
        """The kernel's slice of the mid-run checkpoint meta: mesh geometry,
        churn membership, guard, async and registry ledgers."""
        meta = {}
        meta.update(mesh_geometry_meta(
            devices=self.D, processes=self.mesh.processes, K=self.cfg.K,
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

    # ------------------------------------------------------------------
    # observability: recorder, client record, spans, health, control
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _host_wait(self, n: int = 1):
        """A site where the round's host waits for the card, ``n`` times:
        counted in ``_host_syncs`` (the round record's ``host_syncs``) on
        any device, so that the count is the path's; a test's seam onto
        every counted site."""
        self._host_syncs += n
        yield

    def _obs_sync(self, obs) -> None:
        """Close out queued device work at an obs phase boundary, so that
        the phase spans measure execution; only while a recorder writes
        (with obs off the round keeps its one sync)."""
        if obs.enabled:
            with self._host_wait():
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

    def _open_obs(self, *, resumed: bool, rounds_prior: int):
        """Open this run's recorder (sinks from ``cfg.obs_sinks`` and
        ``cfg.obs_dir``; "auto" without a directory writes nothing) and
        attach the health watchdog, then the controller (the controller
        sees round N before round N's alerts: file order)."""
        cfg = self.cfg
        run_name = (self.obs_run_name
                    or f"{self.obs_engine}_{self.algo.name}")
        rec = make_recorder(cfg.obs_sinks, cfg.obs_dir, run_name=run_name,
                            engine=self.obs_engine,
                            algorithm=self.algo.name, device=self.device)
        rec.open(config=dataclasses.asdict(cfg),
                 mesh_shape={"clients": self.D}, resumed=resumed,
                 rounds_prior=rounds_prior)
        monitor_from_config(cfg, recorder=rec)
        controller_from_config(cfg, recorder=rec)
        self.obs_recorder = rec
        return rec

    def _emit_client_record(self, obs, round_index: int, N: int,
                            loss_host, cl_nrm, cl_dist) -> None:
        """The round's ``client`` record from the activity and guard stash
        and the per-client norms and losses the round already fetched."""
        cr = self._client_round
        fields = client_round_fields(
            round_index, self.cfg.K,
            update_norm=cl_nrm, dist_z=cl_dist, loss=loss_host,
            weight=cr.get("weight"), active=cr.get("active"),
            guard_ok=cr.get("guard_ok"), quarantine=cr.get("quarantine"),
            dropped=cr.get("dropped"), straggled=cr.get("straggled"),
            corrupted=cr.get("corrupted"), staleness=cr.get("staleness"),
            admitted=cr.get("admitted"), members=cr.get("members"),
            registry_ids=self._cohort if self._pop_active else None,
            payload_bytes=self.round_bytes_on_wire(N, 1))
        obs.client_event(fields)
        self._client_round = {}

    def _emit_round_obs(self, obs, rec, *, round_index, t_round,
                        images=None, extra_fields=None, N=0,
                        loss_host=None, cl_nrm=None, cl_dist=None,
                        phase_marks=(), t_ckpt=None,
                        checkpoint_path=None, state=None, blockvars=None,
                        nxt=None, history=None, log=print):
        """One round's observability fan-out: the round record, the
        client record, the campaign record, the serving tick, the phase
        and checkpoint spans, then the health watchdog and the control
        plane (a fatal health trip owns the exit, the supervisor the
        recovery).  With no sink, watchdog or controller nothing runs, the
        serving tick included.  ``phase_marks`` is ``[(name, cat, t0,
        t1), ...]``."""
        if not (obs.enabled or obs.health is not None
                or obs.control is not None):
            return
        extra = dict(rec, round_index=round_index, t_start=t_round,
                     **device_memory_stats(self.device))
        if images is not None:
            extra["images"] = images
        if extra_fields:
            extra.update(extra_fields)
        rrec = obs.round(extra)
        if self._client_probe:
            self._emit_client_record(obs, round_index, N, loss_host,
                                     cl_nrm, cl_dist)
        if self.campaign is not None:
            # the window transition, if any, rides behind the round record
            self._emit_campaign_record(obs, round_index)
        if self._serve_sched is not None and state is not None:
            # the serving tick rides the round boundary
            self._serve_tick(obs, round_index, state, log=log)
        if obs.enabled:
            rspan = (rrec or {}).get("span_id")
            for nm, cat, s0, s1 in phase_marks:
                obs.span(nm, s0, s1, cat=cat, round_index=round_index,
                         parent_span=rspan)
            if t_ckpt is not None:
                # the save runs after round_seconds is measured: its span
                # hangs off the run span
                obs.span("ckpt", t_ckpt,
                         t_ckpt + rec["ckpt_write_seconds"],
                         cat="ckpt", round_index=round_index)
        if obs.health is not None and obs.health.tripped is not None:
            self._health_abort(obs, checkpoint_path, state, blockvars,
                               nxt, history, log)
        if obs.control is not None:
            self._apply_round_control(obs, checkpoint_path, log)

    def _health_abort(self, obs, checkpoint_path, state, blockvars, nxt,
                      history, log=print):
        """A watchdog rule tripped under a fatal ``--health-action``.
        ``checkpoint-abort`` first makes sure a verified checkpoint is on
        disk: the round's mid-run slot, or a one-off save at
        ``<checkpoint_dir>/<run_name>_health_abort``.  Always ends in
        :class:`RunHealthAbort`."""
        alert = obs.health.tripped
        log(f"health: rule {alert.get('rule')!r} tripped on round "
            f"{alert.get('round_index')} (action={obs.health.action})")
        if obs.health.action == "checkpoint-abort":
            path = checkpoint_path
            if path is None:
                run_name = (self.obs_run_name
                            or f"{self.obs_engine}_{self.algo.name}")
                path = os.path.join(self.cfg.checkpoint_dir,
                                    f"{run_name}_health_abort")
                self._save_midrun(path, state, blockvars, nxt, history)
            self._flush_ckpt_writer()
            try:
                slot = finalize_checkpoint(path)
            except NoUsableCheckpointError as e:
                log(f"WARNING: health: no usable checkpoint to finalize "
                    f"({e}); aborting without one")
            else:
                log(f"health: final checkpoint verified at {slot}")
        raise RunHealthAbort(alert)

    def _apply_round_control(self, obs, checkpoint_path, log=print):
        """Act-mode round-scope decisions at the round boundary:
        ``max_staleness`` and ``cohort_frac`` are host knobs read every
        round, so they apply live; a ``serve_swap`` arms a forced refresh
        that the next round's serving tick applies (without bumping
        ``weights_version``); a ``checkpoint_restart`` verifies the newest
        slot and raises :class:`ControlRestart` to the supervisor."""
        ctl = obs.control
        for d in ctl.take_round():
            if d.param == "max_staleness":
                with self._cfg_swap_lock:
                    old = self.cfg.max_staleness
                    self.cfg = dataclasses.replace(
                        self.cfg, max_staleness=int(d.to_value))
                log(f"control: {d.intervention} max_staleness "
                    f"{old} -> {self.cfg.max_staleness} ({d.reason})")
            elif d.param == "cohort_frac":
                if not self._pop_active:
                    log("control: skip cohort_frac (population mode "
                        "is off for this run)")
                    continue
                old_f = self._cohort_frac
                self._cohort_frac = float(d.to_value)
                log(f"control: {d.intervention} cohort_frac "
                    f"{old_f} -> {self._cohort_frac} ({d.reason})")
            elif d.param == "serve_swap":
                if self._serve_sched is None:
                    log("control: skip serve_swap (serving is off for "
                        "this run)")
                    continue
                self._serve_forced = True
                log(f"control: {d.intervention} armed a forced serving "
                    f"refresh ({d.reason})")
        d = ctl.take_restart()
        if d is not None:
            self._flush_ckpt_writer()
            slot = finalize_checkpoint(checkpoint_path)
            log(f"control: checkpoint-then-restart from verified {slot} "
                f"({d.reason})")
            raise ControlRestart(
                d.fields(source="policy", mode="act", applied=True))
