"""Versioned record schema for run telemetry.

A copy of ``federated_pytorch_test_tpu/obs/schema.py`` for the port (the
port imports nothing of the JAX package), without the determinism
contract's tables that the JAX package's lint reads.

One run = one JSONL stream of ten event kinds:

- ``run_header``  — emitted once when a run (or resumed segment) opens:
  config snapshot, mesh shape, jax/backend versions, git rev.
- ``round``       — one per communication round (or per epoch on the
  no-consensus path): loop coordinates, loss/residuals/rho, wall-clock
  phase timings, ``bytes_on_wire``, guard/fault/quarantine counters,
  device memory stats where the backend reports them.
- ``summary``     — emitted once when the run closes (``completed`` or
  ``aborted``): totals and derived rates.
- ``span``        — one per phase/sub-span (schema v5): a parent-linked
  node of the run -> round -> phase timeline; export with
  ``python -m federated_pytorch_test_tpu_torch.obs.trace``.
- ``alert``       — a streaming-watchdog verdict (schema v5;
  ``obs/health.py``): which rule tripped, on which round, and what the
  configured ``--health-action`` did about it.
- ``compile``     — one per observed jit compile event (schema v6;
  ``obs/costs.py``): site label, compile wall-seconds, trace count,
  AOT cost-model / memory-analysis numbers where available, and
  persistent-compile-cache hit/miss attribution.
- ``control``     — one per control-plane decision (schema v8;
  ``control/``): a typed intervention from the deterministic policy
  engine or the restart supervisor — which knob, from/to values,
  scope, whether it was applied, and the telemetry that justified it.
  Pure function of the recorded stream (no wall clock): replay with
  ``python -m federated_pytorch_test_tpu_torch.control.replay``.
- ``client``      — one per communication round (schema v10;
  ``obs/clients.py``): the client-grain flight recorder.  Parallel
  length-K list fields carry per-client update norms, delta-vs-z
  distance, loss contribution, guard verdicts and quarantine state,
  fault tags, async staleness/admission, and membership — the round
  record's counters, un-aggregated.  Emitted right AFTER the round
  record it describes, so file order is the replay order.
- ``campaign``    — one per schedule-window transition (schema v12;
  ``campaign/``): the hour-quantized slice of the trace-driven soak
  schedule the engine applied from this round on — diurnal arrival
  fraction, derived fault/churn probabilities, storm/burst flags,
  deterministic preemption marker.  Pure function of (campaign seed,
  round_index): ``control.replay`` re-derives the whole campaign from
  the run header's ``campaign_spec``.
- ``serve``       — one per communication round while the serving plane
  is on (schema v13; ``serve/``): the seeded traffic draw, the greedy
  pad-to-bucket batch plan, the hot-swap weights version, and advisory
  p50/p99/QPS/swap-gap/eval-stream telemetry.  The pure subset
  re-derives from the run header's ``serve_spec`` + round index alone.

The schema unifies what ``engine.py``, ``cpc_engine.py`` and
``vae_engine.py`` used to build as ad-hoc dicts; every record carries
``schema`` (the version) and validates via :func:`validate_record`.
Unknown fields are ALLOWED (forward compatibility — a newer writer must
not break an older reader); known fields are type-checked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

# v2 (additive): optional per-round `jit_retraces` — cumulative jit
# retrace count from the engine's retrace sentinel
# (analysis/sanitize.py), present when --retrace-sentinel is on.
# v3 (additive): optional per-round `host_dispatches` — how many jitted
# step dispatches the host issued for the round (fused rounds: exactly 1
# for the train+comm phase vs Nepoch+1 unfused) — and `ckpt_write_seconds`
# — wall-clock the round spent in the mid-run save call (async
# checkpointing: snapshot+enqueue only, so near zero unless the writer's
# backpressure barrier engaged).
# v4 (additive): buffered-async federation telemetry (--async-rounds) —
# per-round `async_mode`/`max_staleness` (the mode stamp), `async_arrived`
# (deliveries this round), `admission_rejected` (staler than
# max_staleness, discarded), `buffer_depth` (updates still in flight
# after the round), and `staleness_hist` (admitted deliveries bucketed by
# staleness 0..max_staleness).
# v5 (additive): the live run-health layer — parent-linked span ids
# (`span_id` on run_header/round, `parent_span` + host-monotonic
# `t_start`/`t_end` on round records), a new `span` record kind (the
# run -> round -> phase timeline, exported to Chrome trace-event JSON by
# obs/trace.py and keyed to the same `round_index` the XProf round_trace
# annotations use), a new `alert` record kind (obs/health.py streaming
# watchdog verdicts), and `alerts_total` on the summary.
# v6 (additive): the device-cost ledger (obs/costs.py) — a new `compile`
# record kind (one per observed jit compile: `site`, `compile_seconds`,
# `trace_count`, AOT cost-model `flops` / `hlo_bytes_accessed` /
# `transcendentals` and memory_analysis byte fields where the backend
# supports them, `cache_hit` persistent-cache attribution; carries
# span_id/parent_span/t_start/t_end so compile events render as bubbles
# inside rounds in the Chrome-trace export), per-round `compile_seconds`
# / `flops_round` / `hlo_bytes_accessed` / `peak_device_bytes` /
# `cache_hit`, and summary compile/cache totals plus the device-memory
# high-watermark pair.  ALL cost fields are advisory: absent means "the
# backend/mode did not produce it", never zero (PARITY.md).
# v7 (additive): the roofline comm path (--fused-collective /
# --overlap-staging) — per-round `bytes_fused` (predicted device-to-device
# bytes the fused packed collective moves for the round: every ppermute
# hop's packed payload + scale sidecar, ops/packed_reduce.py
# fused_bytes_on_wire; a DIFFERENT quantity from the uplink model
# `bytes_on_wire`, which counts K client payloads once) and
# `overlap_seconds` (host wall-clock the round spent pre-staging the next
# round's first epoch while the comm dispatch was in flight; present only
# when --overlap-staging is on, 0.0 when there was nothing left to
# prestage).
# v8 (additive): the closed-loop control plane (control/) — a new
# `control` record kind, one per policy decision or supervisor restart
# action.  `source` says who decided ("policy" = the deterministic
# in-run rule engine, "supervisor" = the restart wrapper between run
# segments); `intervention`/`param`/`from_value`/`to_value`/`scope`
# describe the typed knob change; `mode` ("observe"|"act") and
# `applied` record whether the engine actually took it; `reason`
# carries the rule text; `observed`/`threshold`/`streak` reuse the
# alert-field semantics for the triggering telemetry.  Supervisor
# records add `attempt` (1-based restart count), `backoff_seconds`
# (seeded deterministic backoff) and `ladder_stage`.  Control records
# deliberately carry NO time_unix: every field is a pure function of
# recorded telemetry + round index, so control.replay can re-derive
# the decision sequence bit-exactly from the stream.  The summary
# gains `interventions_total`.
# v9 (additive): elastic federation (train/faults.py churn families +
# mesh-reshaping resume) — round records gain `members_active` (live
# churn-ledger members after this round's tick), `joined` and `left`
# (this round's membership transitions).  Present only when a
# join=/leave= fault family is configured, so static-roster streams are
# byte-identical to v8.  Reshape restarts reuse the existing v8 control
# fields (`intervention="reshape"`, param/from_value/to_value/scope/
# attempt/reason); control.replay cross-checks them against consecutive
# run_header `mesh_shape` values.
# v10 (additive): the client-grain flight recorder (obs/clients.py) — a
# new `client` record kind, at most one per communication round, emitted
# immediately AFTER the round record it describes (file order == replay
# order; control.replay feeds both in sequence).  Scalar `clients` is
# the cohort size K; every other payload field is a parallel length-K
# list indexed by client id: `update_norm` (||x_k - z|| BEFORE guard
# neutralisation, so NaN/inf corruption stays visible), `dist_z`
# (||x_k - z_new|| after the consensus fold), `loss_client`, `weight`
# (the mean weight incl. participation and staleness decay), `active`,
# `guard_ok` (guard verdicts, only when --update-guard is on),
# `quarantine` (rounds remaining), fault tags `dropped`/`straggled`/
# `corrupted`, async `staleness`/`admitted`, and churn `members`.
# `payload_bytes` is the per-participant uplink cost of the round.
# ALL list fields are advisory (absent means "that subsystem was off",
# never zeroed — PARITY.md); streams with client_ledger=False are
# byte-identical to v9.  The record is derived from host values the
# engine already fetched plus one optional probe output, and the
# anomaly ranking in obs/clients.py is a pure function of the stream.
# v11 (additive): population federation (population/) — `client` records
# gain optional `registry_ids`, a parallel length-`clients` list mapping
# each slot to the REGISTRY id of the virtual client that occupied it
# this round (``--population K`` decouples registered clients from
# device slots; the sampled cohort changes every round).  When present,
# obs/clients.py keys its ledger/ranking/timelines by registry id and
# aggregates byte-exactly over the full population even though each
# record only carries the sampled cohort.  Absent on population-off
# streams, which therefore stay byte-identical to v10.
# v12 (additive): soak campaigns (campaign/) — a new `campaign` record
# kind, emitted right after the round record whenever the trace-driven
# schedule's hour-quantized window transitions (first round of a
# segment, every virtual-hour boundary, and any post-resume re-run of a
# preempted round).  Carries the window the engine actually applied:
# `virtual_seconds` (round_index * round_minutes * 60 — virtual time is
# a pure function of the round index), `arrival_frac` (the diurnal
# curve), the derived per-family probabilities `drop_p`/`straggle_p`/
# `corrupt_p`/`join_p`/`leave_p`, the correlated-event flags `storm`/
# `burst` (seeded tags 73/79), `preempt_now`, and the human-facing
# `phase` label.  Deliberately NO time_unix: every field is a pure
# function of (campaign seed, round_index), so control.replay
# re-derives the whole campaign schedule bit-exactly from the header
# config's campaign_spec alone.  Campaign-off streams carry no
# `campaign` records and stay byte-identical to v11.
# v13 (additive): the serving plane (serve/) — a new `serve` record
# kind, one per communication round while serving is on, emitted right
# after the campaign record slot in the round fan-out (file order ==
# replay order).  The record splits into a PURE subset and advisory
# telemetry.  Pure (re-derived bit-exactly by control.replay from the
# header config's serve_spec + the round index alone): `weights_version`
# (1 + round_index // swap_every — forced refreshes republish at the
# SAME version, keeping the sequence resume-free), `requests` (the
# seeded diurnal traffic draw, tag 83), `batches`/`padded_slots`/
# `padding_waste_frac` (the greedy pad-to-bucket plan), `drift_injected`
# (round_index >= drift_at) and `swap` (round_index % swap_every == 0).
# Advisory (wall-clock/model-dependent — never replay-checked):
# `serve_p50_ms`/`serve_p99_ms` request latency, `serve_qps`,
# `swap_gap_seconds` (double-buffered publish gap), `serve_accuracy`/
# `drift_score` (the eval-stream loop into obs/health.py's serve_drift
# rule) and `forced_refresh` (a control-plane serve_swap intervention
# republished the weights this round).  Serving-off streams carry no
# `serve` records and stay byte-identical to v12.
# v14 (additive): whole-round compute/comm overlap (--overlap-round) —
# per-round `overlap_dispatch_seconds`, the host wall-clock spent
# enqueueing the NEXT round's first train epoch while this round's comm
# collective was still executing on-device (train/engine.py
# _predispatch_round).  Advisory (a host timing, like overlap_seconds);
# present only when --overlap-round is active, 0.0 on the last round of
# a block (the pre-dispatch is gated to same-block successors) and
# whenever the lookahead cache was already spent.  Overlap-off streams
# carry no such field and stay byte-identical to v13.
# v1..v13 records remain valid: validate_record accepts ver <= SCHEMA_VERSION.
SCHEMA_VERSION = 14

EVENTS = ("run_header", "round", "summary", "span", "alert", "compile",
          "control", "client", "campaign", "serve")


class SchemaError(ValueError):
    """A record fails schema validation (missing/ill-typed field)."""


# bool is an int subclass: _INT/_NUM must not silently admit True/False
_NUM = (int, float)      # numeric (counters may arrive as float from psum)
_INT = (int,)
_STR = (str,)
_BOOL = (bool,)
_LIST = (list,)
_DICT = (dict,)
_ANY = None              # any JSON value

#: known fields -> (event kinds they may appear on, allowed types)
FIELDS: Dict[str, Any] = {
    # envelope
    "event":        (EVENTS, _STR),
    "schema":       (EVENTS, _INT),
    "run_id":       (EVENTS, _STR),
    "run_name":     (("run_header",), _STR),
    "engine":       (("run_header", "round", "compile"), _STR),
    "algorithm":    (("run_header", "round", "compile"), _STR),
    # header
    "time_unix":    (("run_header", "summary", "alert"), _NUM),
    "config":       (("run_header",), _DICT),
    "mesh_shape":   (("run_header",), _DICT),
    "devices":      (("run_header",), _INT),
    "local_devices": (("run_header",), _INT),
    "platform":     (("run_header",), _STR),
    "jax_version":  (("run_header",), _STR),
    "jaxlib_version": (("run_header",), _STR),
    "git_rev":      (("run_header",), _STR),
    "resumed":      (("run_header",), _BOOL),
    "rounds_prior": (("run_header",), _INT),
    "host":         (("run_header",), _STR),
    "pid":          (("run_header",), _INT),
    # time.time_ns() - time.perf_counter_ns() at open (the port): maps
    # t_start/t_end onto torch.profiler's clock (additive, no bump)
    "clock_offset_ns": (("run_header",), _INT),
    # round coordinates (spans and alerts are keyed to the same index the
    # XProf round_trace annotations use, so all three timelines correlate)
    "round_index":  (("round", "span", "alert", "compile", "control",
                      "client", "campaign", "serve"), _INT),
    "nloop":        (("round",), _INT),
    "block":        (("round",), _INT),
    "nadmm":        (("round",), _INT),
    "epoch":        (("round",), _INT),
    "model":        (("round",), _STR),   # CPC submodel name
    "N":            (("round",), _INT),
    "label":        (("round",), _STR),   # bench section tag
    # round measurements
    "loss":         (("round",), _NUM),
    "rho":          (("round",), _NUM),
    "dual_residual": (("round",), _NUM),
    "primal_residual": (("round",), _NUM),
    "accuracy":     (("round",), _LIST),
    "images":       (("round",), _INT),
    # wall-clock phase segments (time.monotonic/perf_counter on host;
    # they sum to ~round_seconds — see README "Observability" for the
    # single-host-sync attribution caveat)
    "round_seconds": (("round",), _NUM),
    "stage_seconds": (("round",), _NUM),
    "train_seconds": (("round",), _NUM),
    "comm_seconds": (("round",), _NUM),
    "sync_seconds": (("round",), _NUM),
    "compute_seconds": (("round",), _NUM),
    "epoch_seconds": (("round",), _NUM),
    # recompilation sentinel (schema v2; --retrace-sentinel)
    "jit_retraces": (("round",), _INT),
    "host_dispatches": (("round",), _INT),
    "ckpt_write_seconds": (("round",), _NUM),
    # communication volume
    "bytes_on_wire": (("round",), _INT),
    "bytes_dense":  (("round",), _INT),
    # roofline comm path (schema v7; --fused-collective/--overlap-staging)
    "bytes_fused":  (("round",), _INT),
    "overlap_seconds": (("round",), _NUM),
    # whole-round overlap (schema v14; --overlap-round)
    "overlap_dispatch_seconds": (("round",), _NUM),
    # the port's round instrumentation (additive, no bump; present while
    # a recorder writes): host enqueue time of the local epoch and of its
    # client-steps' phases, evaluation, the comm step's CUDA-event time
    # (on a card) and the round's host waits on the card; the client-steps
    # replayed from CUDA graphs, dispatched eagerly and the graphs captured
    "epoch_host_seconds": (("round",), _NUM),
    "step_forward_seconds": (("round",), _NUM),
    "step_backward_seconds": (("round",), _NUM),
    "step_optimizer_seconds": (("round",), _NUM),
    "step_replay_seconds": (("round",), _NUM),
    "graph_steps": (("round",), _INT),
    "eager_steps": (("round",), _INT),
    "graph_captures": (("round",), _INT),
    "eval_seconds": (("round",), _NUM),
    "comm_device_seconds": (("round",), _NUM),
    "host_syncs": (("round",), _INT),
    # fault / guard counters
    "guard_trips":  (("round",), _NUM),
    "guard_norm_mean": (("round",), _NUM),
    "n_ok":         (("round",), _NUM),
    "n_active":     (("round",), _NUM),
    "n_comm":       (("round",), _INT),
    "quarantined":  (("round",), _INT),
    "fault_dropped": (("round",), _INT),
    "fault_straggled": (("round",), _INT),
    "fault_corrupted": (("round",), _INT),
    # elastic federation churn ledger (schema v9; join=/leave= families)
    "members_active": (("round",), _INT),
    "joined":       (("round",), _INT),
    "left":         (("round",), _INT),
    # buffered-async federation (schema v4; --async-rounds)
    "async_mode":   (("round",), _BOOL),
    "max_staleness": (("round",), _INT),
    "async_arrived": (("round",), _INT),
    "admission_rejected": (("round",), _INT),
    "buffer_depth": (("round",), _INT),
    "staleness_hist": (("round",), _LIST),
    # device memory (absent when the backend reports none, e.g. CPU)
    "mem_bytes_in_use": (("round",), _INT),
    "mem_peak_bytes_in_use": (("round",), _INT),
    # device-cost ledger (schema v6; obs/costs.py).  Round-level fields
    # aggregate the compile events and executed cost-model numbers of
    # that round's dispatch window; `compile` records carry the per-event
    # detail.  Every one of these is optional — omitted, never zeroed,
    # when the backend/AOT mode does not produce it.
    "site":         (("compile",), _STR),     # jit site label
    "compile_seconds": (("round", "compile"), _NUM),
    "trace_count":  (("compile",), _INT),     # cumulative; 1 == cold
    "flops":        (("compile",), _NUM),     # per-dispatch cost model
    "flops_round":  (("round",), _NUM),       # executed (sum over window)
    "hlo_bytes_accessed": (("round", "compile"), _NUM),
    "transcendentals": (("compile",), _NUM),
    "argument_bytes": (("compile",), _INT),   # memory_analysis (full AOT)
    "output_bytes": (("compile",), _INT),
    "temp_bytes":   (("compile",), _INT),
    "generated_code_bytes": (("compile",), _INT),
    "peak_device_bytes": (("round", "compile"), _INT),
    "cache_hit":    (("round", "compile"), _BOOL),
    # span tracing (schema v5; obs/trace.py).  `span_id`/`parent_span`
    # ride additively on existing records; `t_start`/`t_end` are HOST
    # MONOTONIC (time.perf_counter) stamps taken at the phase boundaries
    # the engines already time — device-phase durations come from the
    # existing `_obs_sync` sync points, no new syncs are introduced.
    "span_id":      (("run_header", "round", "span", "compile"), _STR),
    "parent_span":  (("round", "span", "compile"), _STR),
    "t_start":      (("round", "span", "compile"), _NUM),
    "t_end":        (("round", "span", "compile"), _NUM),
    "name":         (("span",), _STR),        # phase/sub-span label
    "cat":          (("span",), _STR),        # run|round|phase|comm|ckpt|...
    # streaming watchdog verdicts (schema v5; obs/health.py)
    "rule":         (("alert",), _STR),
    "severity":     (("alert",), _STR),       # warn|fatal
    "message":      (("alert",), _STR),
    "observed":     (("alert", "control"), _NUM),  # triggering value
    "threshold":    (("alert", "control"), _NUM),
    "streak":       (("alert", "control"), _INT),  # consecutive bad rounds
    "action":       (("alert",), _STR),       # health_action at trip time
    # closed-loop control plane (schema v8; control/).  NO time_unix on
    # purpose: a control record is a pure function of recorded telemetry
    # and the round index, so control.replay reproduces it bit-exactly.
    "source":       (("control",), _STR),     # policy|supervisor
    "intervention": (("control",), _STR),     # typed action name
    "param":        (("control",), _STR),     # cfg knob it targets
    "from_value":   (("control",), _ANY),
    "to_value":     (("control",), _ANY),
    "reason":       (("control",), _STR),
    "mode":         (("control",), _STR),     # observe|act
    "applied":      (("control",), _BOOL),    # engine took the action
    "scope":        (("control",), _STR),     # round|block|restart
    "attempt":      (("control",), _INT),     # supervisor: restart count
    "backoff_seconds": (("control",), _NUM),  # supervisor: seeded backoff
    "ladder_stage": (("control",), _INT),     # supervisor: degradation rung
    # client-grain flight recorder (schema v10; obs/clients.py).  All
    # list fields are parallel, length `clients`, indexed by client id;
    # each is advisory — present only when its subsystem ran.
    "clients":      (("client",), _INT),      # cohort size K
    "update_norm":  (("client",), _LIST),     # ||x_k - z|| pre-guard
    "dist_z":       (("client",), _LIST),     # ||x_k - z_new|| post-fold
    "loss_client":  (("client",), _LIST),
    "weight":       (("client",), _LIST),     # mean weight (partic+stale)
    "active":       (("client",), _LIST),     # 0/1 contributed this round
    "guard_ok":     (("client",), _LIST),     # guard verdicts (guard on)
    "quarantine":   (("client",), _LIST),     # rounds remaining
    "dropped":      (("client",), _LIST),     # fault tags this round
    "straggled":    (("client",), _LIST),
    "corrupted":    (("client",), _LIST),
    "staleness":    (("client",), _LIST),     # async: rounds stale
    "admitted":     (("client",), _LIST),     # async: admission outcome
    "members":      (("client",), _LIST),     # churn roster after tick
    "registry_ids": (("client",), _LIST),     # population: slot -> rid (v11)
    "payload_bytes": (("client",), _INT),     # uplink bytes/participant
    # soak-campaign schedule windows (schema v12; campaign/).  One per
    # window TRANSITION, right after the round record it rides with; no
    # time_unix — every field is a pure function of (campaign seed,
    # round_index), re-derived bit-exactly by control.replay from the
    # header config's campaign_spec.
    "virtual_seconds": (("campaign",), _NUM),  # round_index * round secs
    "arrival_frac": (("campaign",), _NUM),     # diurnal curve, [0, 1]
    "drop_p":       (("campaign",), _NUM),     # derived family probs
    "straggle_p":   (("campaign",), _NUM),
    "corrupt_p":    (("campaign",), _NUM),
    "join_p":       (("campaign",), _NUM),
    "leave_p":      (("campaign",), _NUM),
    "storm":        (("campaign",), _BOOL),    # seeded tag-73 event live
    "burst":        (("campaign",), _BOOL),    # seeded tag-79 event live
    "preempt_now":  (("campaign",), _BOOL),    # deterministic preempt_at
    "phase":        (("campaign",), _STR),     # trough|shoulder|peak|...
    # serving plane (schema v13; serve/).  Pure subset first (re-derived
    # by control.replay from the header serve_spec + round index), then
    # the advisory timing/eval telemetry; no time_unix on the record —
    # wall-clock facts ride ONLY in advisory fields.
    "weights_version": (("serve",), _INT),     # 1 + ridx // swap_every
    "requests":     (("serve",), _INT),        # seeded traffic draw (tag 83)
    "batches":      (("serve",), _INT),        # dispatched micro-batches
    "padded_slots": (("serve",), _INT),        # bucket slots left empty
    "padding_waste_frac": (("serve",), _NUM),  # padded / total slots
    "drift_injected": (("serve",), _BOOL),     # ridx >= drift_at
    "swap":         (("serve",), _BOOL),       # ridx % swap_every == 0
    "serve_p50_ms": (("serve",), _NUM),        # advisory from here down
    "serve_p99_ms": (("serve",), _NUM),
    "serve_qps":    (("serve",), _NUM),
    "swap_gap_seconds": (("serve",), _NUM),    # double-buffer publish gap
    "serve_accuracy": (("serve",), _NUM),      # eval-stream live accuracy
    "drift_score":  (("serve",), _NUM),        # 1 - acc/EMA, floored at 0
    "forced_refresh": (("serve",), _BOOL),     # control-plane republish
    # summary totals / rates
    "status":       (("summary",), _STR),
    "rounds":       (("summary",), _INT),
    "total_seconds": (("summary",), _NUM),
    "round_seconds_total": (("summary",), _NUM),
    "stage_seconds_total": (("summary",), _NUM),
    "comm_seconds_total": (("summary",), _NUM),
    "bytes_on_wire_total": (("summary",), _INT),
    "bytes_dense_total": (("summary",), _INT),
    "images_total": (("summary",), _INT),
    "guard_trips_total": (("summary",), _NUM),
    "fault_dropped_total": (("summary",), _INT),
    "fault_straggled_total": (("summary",), _INT),
    "fault_corrupted_total": (("summary",), _INT),
    "quarantined_last": (("summary",), _INT),
    "loss_first":   (("summary",), _NUM),
    "loss_final":   (("summary",), _NUM),
    "rounds_per_sec": (("summary",), _NUM),
    "images_per_sec": (("summary",), _NUM),
    "comm_overhead_frac": (("summary",), _NUM),
    "compression_savings_frac": (("summary",), _NUM),
    "alerts_total": (("summary",), _INT),
    "interventions_total": (("summary",), _INT),
    # device-cost + memory-watermark summary (schema v6)
    "compile_events_total": (("summary",), _INT),
    "compile_seconds_total": (("summary",), _NUM),
    "cache_hits_total": (("summary",), _INT),
    "cache_misses_total": (("summary",), _INT),
    "mem_peak_bytes_watermark": (("summary",), _INT),
    "mem_final_vs_peak_bytes": (("summary",), _INT),
}

REQUIRED = {
    "run_header": ("event", "schema", "run_id", "engine", "time_unix"),
    "round": ("event", "schema", "run_id", "round_index", "engine",
              "round_seconds"),
    "summary": ("event", "schema", "run_id", "status", "rounds"),
    "span": ("event", "schema", "run_id", "span_id", "name", "t_start",
             "t_end"),
    "alert": ("event", "schema", "run_id", "rule", "round_index"),
    "compile": ("event", "schema", "run_id", "site", "compile_seconds"),
    "control": ("event", "schema", "run_id", "round_index", "source",
                "intervention"),
    "client": ("event", "schema", "run_id", "round_index", "clients"),
    "campaign": ("event", "schema", "run_id", "round_index",
                 "virtual_seconds"),
    "serve": ("event", "schema", "run_id", "round_index",
              "weights_version", "requests"),
}

def json_safe(obj):
    """Coerce ``obj`` into JSON-serialisable types.

    numpy arrays/scalars become lists/Python scalars, tuples become
    lists, dataclasses become dicts, anything else falls back to
    ``repr`` — so a config snapshot or an ``accuracy`` ndarray can ride
    in a record without the caller caring.
    """
    import numpy as np

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [json_safe(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return json_safe(dataclasses.asdict(obj))
    return repr(obj)


def _type_ok(value, types) -> bool:
    if types is _ANY or types is None:
        return True
    if isinstance(value, bool) and bool not in types:
        return False            # bool passes isinstance(int) checks
    if isinstance(value, types):
        return True
    # json round-trips ints inside float fields and vice versa
    if float in types and isinstance(value, int):
        return True
    return False


def validate_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Validate one record against the schema; returns it unchanged.

    Raises :class:`SchemaError` on: non-dict input, unknown/missing
    ``event``, missing ``schema`` version or one newer than this reader,
    a missing required field, or a known field of the wrong type.
    Unknown fields pass (forward compatibility).
    """
    if not isinstance(rec, dict):
        raise SchemaError(f"record must be a dict, got {type(rec).__name__}")
    event = rec.get("event")
    if event not in EVENTS:
        raise SchemaError(f"unknown event {event!r}; expected one of {EVENTS}")
    ver = rec.get("schema")
    if not isinstance(ver, int) or isinstance(ver, bool) or ver < 1:
        raise SchemaError(f"bad schema version {ver!r}")
    if ver > SCHEMA_VERSION:
        raise SchemaError(
            f"record schema v{ver} is newer than this reader "
            f"(v{SCHEMA_VERSION})")
    for name in REQUIRED[event]:
        if rec.get(name) is None:
            raise SchemaError(f"{event} record missing required {name!r}")
    for name, value in rec.items():
        spec = FIELDS.get(name)
        if spec is None or value is None:
            continue                       # unknown field / JSON null: pass
        kinds, types = spec
        if event not in kinds:
            raise SchemaError(
                f"field {name!r} is not valid on a {event!r} record")
        if not _type_ok(value, types):
            raise SchemaError(
                f"field {name!r} on {event!r} has type "
                f"{type(value).__name__}, expected one of "
                f"{tuple(t.__name__ for t in types)}")
    return rec
