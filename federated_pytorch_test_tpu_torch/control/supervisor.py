"""Restart supervisor: bounded retry, seeded backoff, degradation ladder.

Port of ``federated_pytorch_test_tpu/control/supervisor.py`` with its
elastic ``reshape`` rung: the same backoff, ladder and records, so the
JAX package's ``control.replay`` checks the port's streams as they are.
The rung rebuilds the trainer over a smaller logical client mesh
(``parallel/mesh.py``); what triggers it is a ``CollectiveTimeoutError``:
the simulated preemption of the ``preempt=`` fault family, or a peer
process lost under ``--barrier-timeout``, whose survivor resumes in a
fresh run from the newest checkpoint with ``--elastic-resume`` (it does
not re-form a smaller process group in place, as the JAX package does
not).

The supervisor is the recovery half of the control plane.  It wraps an
engine run so a :class:`~..obs.health.RunHealthAbort` (or a policy
:class:`~.policy.ControlRestart`, or an injected crash the caller opts
into via ``retry_on``) triggers resume-from-verified-checkpoint instead
of killing the job:

- **Bounded budget**: at most ``--max-restarts`` restarts; when the
  budget is spent the supervisor appends a structured ``give_up``
  control record to the run's JSONL stream and raises
  :class:`RestartBudgetExhausted` chained onto the original failure.
- **Seeded backoff**: attempt ``k`` sleeps
  ``restart_backoff * 2**(k-1) * jitter`` where the jitter in
  ``[0.5, 1.5)`` comes from ``np.random.default_rng([seed, tag, k])``
  — deterministic per (seed, attempt), recomputable by
  ``control.replay`` from the run-header config alone.
- **Degradation ladder**: attempt 1 resumes with NO config changes, so
  a supervised restart with no interventions is bitwise identical to a
  manual kill/resume (PARITY.md).  Attempt ``k >= 2`` applies ladder
  stages ``0..k-2`` cumulatively:

  1. ``shield`` — turn on update guards + quarantine and escalate the
     compression ladder one rung (cheaper wire while unstable);
  2. ``robust_agg`` — upgrade the aggregator to coordinate-wise median
     (skipped when fused_collective/sharded_update own the chokepoint);
  3. ``reduced_cohort`` — halve client participation (floor 0.25).

  A stage override that would violate an engine construction rule
  (e.g. ``update_guard`` under ``bb_update``, or a compress escalation
  on the CPC engine, which has no compression path) is skipped, not
  forced — degradation must never introduce a new failure mode.  Engine
  incompatibilities are declared in :data:`ENGINE_LADDER_EXCLUSIONS`
  and every suppressed rung field is logged as a ``ladder_override``
  control record with ``applied: false`` and the skip reason.  Every
  override and every restart is appended to the stream as a ``control``
  record with ``source="supervisor"``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from federated_pytorch_test_tpu_torch.control.policy import (
    COMPRESS_LADDER, ControlRestart)
from federated_pytorch_test_tpu_torch.obs.health import RunHealthAbort
from federated_pytorch_test_tpu_torch.obs.schema import (
    SCHEMA_VERSION, validate_record)
from federated_pytorch_test_tpu_torch.parallel.mesh import CollectiveTimeoutError
from federated_pytorch_test_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError, NoUsableCheckpointError)

#: distinguishes the supervisor's backoff stream from any other consumer
#: of the run seed (stateless-seed idiom, see utils/serialization notes)
_BACKOFF_TAG = 0xC791

#: exceptions the supervisor always converts into a restart attempt.
#: CollectiveTimeoutError is the preemption signal (on the port the
#: simulated preempt= fault family or a campaign's preempt_at) — under
#: cfg.elastic_resume the classifier supervisor additionally reshapes
#: the mesh before resuming (see supervise_classifier's reshape rung).
RETRYABLE = (RunHealthAbort, ControlRestart, CheckpointCorruptError,
             CollectiveTimeoutError)


class RestartBudgetExhausted(RuntimeError):
    """Every restart attempt failed; carries the attempt count and the
    terminal record that was appended to the stream."""

    def __init__(self, attempts: int, record: Dict[str, Any]):
        self.attempts = int(attempts)
        self.record = dict(record)
        super().__init__(
            f"run still failing after {attempts} supervised restart(s); "
            "giving up with a structured terminal record")


def restart_backoff_seconds(base: float, seed: int, attempt: int) -> float:
    """Deterministic exponential backoff with seeded jitter.

    Pure function of (base, seed, attempt) — ``control.replay`` recomputes
    it from the run-header config to verify recorded restart records.
    """
    if base <= 0:
        return 0.0
    rng = np.random.default_rng([int(seed), _BACKOFF_TAG, int(attempt)])
    jitter = 0.5 + float(rng.random())
    return float(base * (2.0 ** (attempt - 1)) * jitter)


# -- degradation ladder -----------------------------------------------

#: ladder fields an engine's constructor rejects outright.  The ladder
#: must never degrade a run into a config the engine cannot build:
#: classifier and VAE share the full blockwise feature set, while the
#: CPC chain has no compression path (the residual/error-feedback
#: machinery assumes the classifier's blockwise layout), so the shield
#: rung's compress escalation is skipped there — with a logged reason —
#: rather than forced into a constructor ValueError.
ENGINE_LADDER_EXCLUSIONS: Dict[str, Tuple[str, ...]] = {
    "classifier": (),
    "vae": (),
    "cpc": ("compress",),
}


def _stage_shield(cfg, engine: str = "classifier") -> Dict[str, Any]:
    excluded = ENGINE_LADDER_EXCLUSIONS.get(engine, ())
    ov: Dict[str, Any] = {}
    # guards mask poisoned updates pre-aggregation; forbidden under
    # bb_update (engine constructor rule), so skip rather than crash
    if not getattr(cfg, "bb_update", False):
        if not cfg.update_guard:
            ov["update_guard"] = True
        if cfg.quarantine_rounds < 2:
            ov["quarantine_rounds"] = 2
    if "compress" not in excluded and cfg.compress in COMPRESS_LADDER:
        idx = COMPRESS_LADDER.index(cfg.compress)
        cap = (COMPRESS_LADDER.index("q4") if cfg.fused_collective
               else len(COMPRESS_LADDER) - 1)
        if idx < cap:
            ov["compress"] = COMPRESS_LADDER[idx + 1]
    return ov


def _stage_robust_agg(cfg, engine: str = "classifier") -> Dict[str, Any]:
    # fused_collective/sharded_update replace the aggregation chokepoint
    # the robust estimators need (engine constructor rule)
    if (cfg.robust_agg == "none" and not cfg.fused_collective
            and not cfg.sharded_update
            and "robust_agg" not in ENGINE_LADDER_EXCLUSIONS.get(engine, ())):
        return {"robust_agg": "median"}
    return {}


def _stage_reduced_cohort(cfg, engine: str = "classifier") -> Dict[str, Any]:
    # population mode: the cohort is the scheduling unit, so degrade the
    # sampled-cohort fraction (the knob the round kernel reads per
    # round) instead of the per-slot participation coin
    if int(getattr(cfg, "population", 0) or 0) > 0:
        f = float(getattr(cfg, "cohort_frac", 1.0) or 1.0)
        if f > 0.5:
            return {"cohort_frac": 0.5}
        if f > 0.25:
            return {"cohort_frac": round(f / 2.0, 4)}
        return {}
    # partial participation is forbidden under bb_update
    if (getattr(cfg, "bb_update", False)
            or "participation" in ENGINE_LADDER_EXCLUSIONS.get(engine, ())):
        return {}
    p = float(cfg.participation)
    if p > 0.5:
        return {"participation": 0.5}
    if p > 0.25:
        return {"participation": round(p / 2.0, 4)}
    return {}


#: (name, override builder) — applied cumulatively from attempt 2 on
DEGRADATION_LADDER: Tuple[Tuple[str, Callable], ...] = (
    ("shield", _stage_shield),
    ("robust_agg", _stage_robust_agg),
    ("reduced_cohort", _stage_reduced_cohort),
)


def surviving_device_count(devices: int, K: int) -> int:
    """Largest device count ``d < devices`` with ``K % d == 0``.

    The reshape rung's target mesh after a preemption: losing any slice
    of a ``devices``-chip mesh leaves at most ``devices - 1`` usable,
    and the client axis needs ``K`` divisible by the mesh size.  Returns
    ``devices`` unchanged when no smaller divisor exists (a 1-device
    mesh has nothing to shrink to — the restart resumes in place).
    """
    for d in range(min(devices - 1, K), 0, -1):
        if K % d == 0:
            return d
    return devices


def ladder_overrides(cfg, attempt: int, engine: str = "classifier"):
    """Config after the ladder for restart ``attempt`` (1-based).

    Attempt 1 is a PLAIN resume — bitwise the manual kill/resume path.
    Attempt ``k >= 2`` applies stages ``0..k-2`` cumulatively (capped at
    the ladder length).  Returns ``(stage_index, new_cfg, changes)``
    where ``changes`` is ``[(stage_name, field, old, new), ...]`` and
    ``stage_index`` is the highest rung reached (0 = none).  ``engine``
    suppresses rung fields the target engine cannot build (see
    :data:`ENGINE_LADDER_EXCLUSIONS`); :func:`ladder_skips` reports
    what was suppressed so it can be logged.
    """
    changes: List[Tuple[str, str, Any, Any]] = []
    cur = cfg
    stage_index = min(max(0, attempt - 1), len(DEGRADATION_LADDER))
    for name, build in DEGRADATION_LADDER[:stage_index]:
        ov = build(cur, engine=engine)
        if not ov:
            continue
        for field, new in sorted(ov.items()):
            changes.append((name, field, getattr(cur, field), new))
        cur = dataclasses.replace(cur, **ov)
    return stage_index, cur, changes


def ladder_skips(cfg, attempt: int, engine: str):
    """Rung fields suppressed for ``engine`` at restart ``attempt``.

    Returns ``[(stage_name, field, reason), ...]`` — the overrides the
    classifier ladder WOULD have applied but this engine's constructor
    rejects.  The supervisor logs each as a ``ladder_override`` control
    record with ``applied: false`` so a degraded CPC/VAE run's stream
    still explains why a rung did nothing.
    """
    if not ENGINE_LADDER_EXCLUSIONS.get(engine, ()):
        return []
    skips: List[Tuple[str, str, str]] = []
    cur = cfg          # evolves with the engine-filtered overrides that run
    stage_index = min(max(0, attempt - 1), len(DEGRADATION_LADDER))
    for name, build in DEGRADATION_LADDER[:stage_index]:
        full = build(cur, engine="classifier")
        kept = build(cur, engine=engine)
        for field in sorted(set(full) - set(kept)):
            skips.append((name, field,
                          f"engine '{engine}' cannot build "
                          f"{field}={full[field]!r}; rung field skipped"))
        if kept:
            cur = dataclasses.replace(cur, **kept)
    return skips


def ladder_records(cfg, attempt: int, *, run_id: str, ridx: int,
                   engine: str = "classifier") -> List[Dict[str, Any]]:
    """``ladder_override`` control records for restart ``attempt``.

    Applied overrides carry from/to values; engine-suppressed rung
    fields carry ``applied: false`` and the skip reason.  Shared by
    :func:`supervise_classifier` and the bare-``supervise`` CPC/VAE
    driver path so both streams explain their degradation identically.
    """
    stage, _, changes = ladder_overrides(cfg, attempt, engine=engine)
    recs: List[Dict[str, Any]] = []
    for stage_name, field, old, new in changes:
        recs.append(dict(
            _base_record(run_id or "unknown", ridx),
            intervention="ladder_override", param=field,
            from_value=old, to_value=new, scope="restart",
            attempt=attempt, ladder_stage=stage,
            reason=f"degradation ladder stage {stage} ({stage_name})"))
    for stage_name, field, why in ladder_skips(cfg, attempt, engine):
        recs.append(dict(
            _base_record(run_id or "unknown", ridx),
            intervention="ladder_override", param=field,
            scope="restart", attempt=attempt, ladder_stage=stage,
            applied=False,
            reason=f"degradation ladder stage ({stage_name}) "
                   f"skipped: {why}"))
    return recs


# -- record plumbing ---------------------------------------------------


def _append_control_records(jsonl_path: Optional[str],
                            records: List[Dict[str, Any]]) -> None:
    """Append supervisor control records to the segment's JSONL stream.

    The segment's recorder already closed (the run aborted), so the
    supervisor appends validated lines directly; they land between the
    dead segment's summary and the next segment's run_header, which is
    where ``control.replay`` expects them.  Best-effort: a sink failure
    must not stop the restart.
    """
    if not jsonl_path:
        return
    try:
        with open(jsonl_path, "a") as f:
            for rec in records:
                f.write(json.dumps(validate_record(rec)) + "\n")
    except OSError:
        pass


def _failure_round(exc: BaseException) -> int:
    alert = getattr(exc, "alert", None)
    if isinstance(alert, dict) and isinstance(
            alert.get("round_index"), int):
        return alert["round_index"]
    decision = getattr(exc, "decision", None)
    if isinstance(decision, dict) and isinstance(
            decision.get("round_index"), int):
        return decision["round_index"]
    # CollectiveTimeoutError carries the round directly (no alert dict:
    # a hung collective never reached the telemetry layer)
    ridx = getattr(exc, "round_index", None)
    if isinstance(ridx, int):
        return ridx
    return -1


def _base_record(run_id: str, ridx: int) -> Dict[str, Any]:
    # control records deliberately carry no time_unix: the determinism
    # contract (PARITY.md) makes them a pure function of the stream
    return {"event": "control", "schema": SCHEMA_VERSION,
            "run_id": run_id, "round_index": ridx,
            "source": "supervisor", "mode": "act", "applied": True}


# -- the supervisor ----------------------------------------------------


def supervise(run_attempt: Callable[[int, bool], Any], *,
              max_restarts: int, backoff_base: float, seed: int,
              retry_on: Tuple = (), log: Callable[[str], None] = print,
              sleep: Callable[[float], None] = time.sleep,
              describe: Callable[[int], Tuple[Optional[str], int, List[Dict[str, Any]]]] = None):
    """Generic retry/backoff loop around ``run_attempt(attempt, resume)``.

    ``run_attempt`` is called with the 1-based attempt number and a
    resume flag (False only for attempt 1 when the caller starts fresh —
    the caller decides; here it is simply ``attempt > 1`` or what the
    caller closed over).  A retryable failure (``RETRYABLE`` plus any
    ``retry_on`` extras) consumes one unit of restart budget; anything
    else propagates untouched.

    ``describe(attempt, exc)`` (optional) returns
    ``(jsonl_path, run_id_hint, extra_records)`` for the segment that
    just failed so restart/terminal records land in its stream —
    classifier runs use :func:`supervise_classifier` which wires this to
    the trainer's recorder (``exc`` lets its reshape rung react to the
    failure TYPE, not just the count); bare callers may pass None and
    get log-only supervision (CPC/VAE path).  A one-argument
    ``describe(attempt)`` keeps working (pre-reshape callers).
    """
    retryable = RETRYABLE + tuple(retry_on)
    attempt = 0
    while True:
        try:
            return run_attempt(attempt + 1, attempt > 0)
        except NoUsableCheckpointError as e:
            # no recovery point exists: retrying cannot help
            log(f"supervisor: no usable checkpoint to resume from "
                f"({e}); giving up")
            raise
        except retryable as e:
            attempt += 1
            ridx = _failure_round(e)
            jsonl_path, run_id, extra = (None, "", [])
            if describe is not None:
                try:
                    try:
                        jsonl_path, run_id, extra = describe(attempt, e)
                    except TypeError:       # legacy one-arg describe
                        jsonl_path, run_id, extra = describe(attempt)
                except Exception:
                    jsonl_path, run_id, extra = (None, "", [])
            if attempt > max_restarts:
                rec = dict(_base_record(run_id or "unknown", ridx),
                           intervention="give_up", param="run",
                           attempt=attempt,
                           reason=f"{type(e).__name__}: restart budget "
                                  f"({max_restarts}) exhausted")
                _append_control_records(jsonl_path, [rec])
                raise RestartBudgetExhausted(attempt - 1, rec) from e
            backoff = restart_backoff_seconds(backoff_base, seed, attempt)
            rec = dict(_base_record(run_id or "unknown", ridx),
                       intervention="restart", param="run",
                       attempt=attempt, backoff_seconds=backoff,
                       reason=f"{type(e).__name__}: resume from the "
                              "last verified checkpoint")
            recs = [rec] + list(extra)
            _append_control_records(jsonl_path, recs)
            log(f"supervisor: attempt {attempt}/{max_restarts} after "
                f"{type(e).__name__} at round {ridx}; backoff "
                f"{backoff:.2f}s")
            if backoff > 0:
                sleep(backoff)


def supervise_classifier(build_trainer, cfg, checkpoint_path: str, *,
                         state=None, resume: bool = False,
                         run_kwargs: Optional[Dict[str, Any]] = None,
                         retry_on: Tuple = (),
                         log: Callable[[str], None] = print,
                         sleep: Callable[[float], None] = time.sleep,
                         engine: str = "classifier"):
    """Supervised blockwise-engine run with the full degradation ladder.

    ``build_trainer(cfg, attempt)`` constructs the trainer for each
    attempt's (possibly degraded) config — it MUST return a fresh
    trainer for ``attempt > 1`` (an aborted trainer's staging pool is
    closed); the supervisor threads the ladder through
    ``dataclasses.replace`` and records every override as a
    ``ladder_override`` control record in the failed segment's stream.
    ``engine`` makes the ladder constraint-aware: rung fields the
    target engine cannot build are suppressed and logged with
    ``applied: false`` instead of forced (the VAE driver passes
    ``engine="vae"``; CPC, whose ``run`` takes no state, goes through
    bare :func:`supervise` + :func:`ladder_records` instead).
    Returns whatever ``trainer.run`` returns.
    """
    kwargs = dict(run_kwargs or {})
    box: Dict[str, Any] = {"trainer": None, "cfg": cfg, "stage": 0}

    def run_attempt(attempt: int, resume_now: bool):
        if attempt > 1:
            # attempt is the 1-based RUN number; the restart number is
            # attempt - 1.  Restart 1 resumes plain (ladder stage 0 —
            # bitwise the manual kill/resume path); the ladder engages
            # from restart 2 on.
            stage, degraded, changes = ladder_overrides(
                cfg, attempt - 1, engine=engine)
            box["stage"], box["cfg"] = stage, degraded
            box["changes"] = changes
        if box.get("reshape_to"):
            # reshape rung (elastic federation): a CollectiveTimeoutError
            # marked the mesh as having lost a slice — rebuild the
            # trainer over the surviving device count recorded by
            # describe(); sticky across later attempts (the lost slice
            # does not come back mid-run)
            box["cfg"] = dataclasses.replace(
                box["cfg"], num_devices=box["reshape_to"])
        trainer = build_trainer(box["cfg"], attempt)
        box["trainer"] = trainer
        st = (state if attempt == 1 and state is not None
              else trainer.init_state())
        return trainer.run(st, checkpoint_path=checkpoint_path,
                           resume=resume or resume_now, **kwargs)

    def describe(attempt: int, exc: Optional[BaseException] = None):
        trainer = box["trainer"]
        rec = getattr(trainer, "obs_recorder", None)
        jsonl_path = getattr(rec, "jsonl_path", None)
        run_id = getattr(rec, "run_id", "") or ""
        ridx = getattr(rec, "_last_index", -1)
        if not isinstance(ridx, int):
            ridx = -1
        if ridx < 0:
            ridx = max(-1, _failure_round(exc) if exc is not None else -1)
        extra: List[Dict[str, Any]] = []
        if (isinstance(exc, CollectiveTimeoutError)
                and getattr(box["cfg"], "elastic_resume", False)
                and trainer is not None):
            # reshape rung: the timeout says a slice is gone — resume
            # the newest checkpoint onto the largest surviving mesh that
            # still divides the client axis, and append the typed
            # `reshape` decision to the dying segment's stream so
            # control.replay can verify it against the next segment's
            # run_header mesh_shape
            d_here = int(box.get("reshape_to") or trainer.D)
            d_next = surviving_device_count(d_here, cfg.K)
            if d_next != d_here:
                box["reshape_to"] = d_next
                extra.append(dict(
                    _base_record(run_id or "unknown", ridx),
                    intervention="reshape", param="num_devices",
                    from_value=d_here, to_value=d_next, scope="restart",
                    attempt=attempt,
                    reason=f"CollectiveTimeoutError: resume from the "
                           f"newest checkpoint on the surviving "
                           f"{d_next}-device mesh"))
        if attempt <= max(0, cfg.max_restarts):
            # `attempt` here is the restart number about to run; its
            # ladder stage is recorded against the segment that just
            # died so replay sees cause before effect
            extra.extend(ladder_records(
                cfg, attempt, run_id=run_id, ridx=ridx, engine=engine))
        return jsonl_path, run_id, extra

    return supervise(
        run_attempt, max_restarts=cfg.max_restarts,
        backoff_base=cfg.restart_backoff, seed=cfg.seed,
        retry_on=retry_on, log=log, sleep=sleep, describe=describe)
