"""Replay CLI: re-derive control decisions from a recorded stream.

Port of ``federated_pytorch_test_tpu/control/replay.py`` with the checks
of what the port emits: policy decisions, supervisor records, population
cohorts, campaign windows and serving rounds (the elastic reshape check
waits for the multi-card mesh).

``python -m federated_pytorch_test_tpu_torch.control.replay run.jsonl``
reads an obs JSONL artifact, rebuilds the :class:`~.policy.ControlPolicy`
from each segment's run-header ``config`` snapshot, feeds the segment's
round, alert and client records through it IN FILE ORDER, and diffs the
derived decision sequence against the recorded ``control`` records.
Supervisor records are checked too: the seeded backoff of every
``restart`` record is recomputed from (``restart_backoff``, ``seed``,
``attempt``) and the attempt numbers must count up from 1.  Under
population federation every ``client`` record's ``registry_ids`` must
re-derive from the seeded sampler; every ``campaign`` record must equal the
schedule window of the header's ``campaign_spec``, and the pure fields of
every ``serve`` record the plan of its ``serve_spec``.  Exit 0 when every
recorded decision is reproduced bit-exactly; exit 1 (with a diff) on any
divergence.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from federated_pytorch_test_tpu_torch.control.policy import (
    Controller, ControlPolicy)
from federated_pytorch_test_tpu_torch.obs.schema import (
    SchemaError, validate_record)

#: decision-content fields replay compares (mode/applied are engine-side
#: facts — whether the knob was actually turned — not decision content)
_COMPARE_FIELDS = ("round_index", "intervention", "param", "from_value",
                   "to_value", "scope", "reason", "observed", "threshold",
                   "streak")

def _decision_key(rec: Dict[str, Any]) -> Tuple:
    return tuple(rec.get(k) for k in _COMPARE_FIELDS)


def _fmt(rec: Dict[str, Any]) -> str:
    return ", ".join(f"{k}={rec.get(k)!r}" for k in _COMPARE_FIELDS
                     if rec.get(k) is not None)


def segment_stream(records: List[Dict[str, Any]]
                   ) -> List[List[Dict[str, Any]]]:
    """Split a (possibly multi-segment) stream at run_header records.

    Supervisor records appended after a dead segment's summary belong to
    that segment (they are written between the summary and the next
    header), which this split preserves.  Records before the first
    header (none in practice) form a headerless leading segment.
    """
    segments: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("event") == "run_header" and cur:
            segments.append(cur)
            cur = []
        cur.append(rec)
    if cur:
        segments.append(cur)
    return segments


def derive_segment_decisions(segment: List[Dict[str, Any]]
                             ) -> Optional[List[Dict[str, Any]]]:
    """Policy decisions this segment's telemetry implies, in order.

    Returns None when the segment ran with ``control == "off"`` (or
    predates the control plane): no policy existed, so no decisions can
    be derived — any recorded policy record in such a segment is a
    divergence the caller reports.
    """
    header = next((r for r in segment
                   if r.get("event") == "run_header"), None)
    config = (header or {}).get("config")
    if not isinstance(config, dict):
        return None
    mode = config.get("control", "off")
    if mode not in ("observe", "act"):
        return None
    # Controller (not bare policy) so exception-swallowing matches the
    # in-run path exactly; no recorder attached — we only want .records
    ctl = Controller(ControlPolicy.from_config(config), mode=mode,
                     can_restart=True)
    for rec in segment:
        # client records are policy input too (schema v10 advisory
        # client-health rule) — file order IS the in-process feed order
        if rec.get("event") in ("round", "alert", "client"):
            ctl.observe(rec)
    return ctl.records


def check_policy_records(segments: List[List[Dict[str, Any]]],
                         errors: List[str]) -> int:
    """Diff derived vs recorded policy decisions per segment."""
    checked = 0
    for si, segment in enumerate(segments):
        recorded = [r for r in segment if r.get("event") == "control"
                    and r.get("source") == "policy"]
        derived = derive_segment_decisions(segment)
        if derived is None:
            if recorded:
                errors.append(
                    f"segment {si}: {len(recorded)} policy control "
                    "record(s) but the header config has control off "
                    "(or no config snapshot) — cannot have been "
                    "produced by this configuration")
            continue
        checked += len(recorded)
        for i in range(max(len(derived), len(recorded))):
            if i >= len(derived):
                errors.append(
                    f"segment {si} decision {i}: recorded but NOT "
                    f"derivable from telemetry: {_fmt(recorded[i])}")
                continue
            if i >= len(recorded):
                errors.append(
                    f"segment {si} decision {i}: derived from telemetry "
                    f"but missing from the stream: {_fmt(derived[i])}")
                continue
            if _decision_key(derived[i]) != _decision_key(recorded[i]):
                errors.append(
                    f"segment {si} decision {i} diverges:\n"
                    f"    recorded: {_fmt(recorded[i])}\n"
                    f"    derived:  {_fmt(derived[i])}")
    return checked


def check_supervisor_records(records: List[Dict[str, Any]],
                             errors: List[str]) -> int:
    """Verify restart attempt numbering and recomputed seeded backoff."""
    header = next((r for r in records
                   if r.get("event") == "run_header"), None)
    config = (header or {}).get("config")
    sup = [r for r in records if r.get("event") == "control"
           and r.get("source") == "supervisor"]
    restarts = [r for r in sup if r.get("intervention") == "restart"]
    for i, rec in enumerate(restarts):
        if rec.get("attempt") != i + 1:
            errors.append(
                f"supervisor restart {i}: attempt={rec.get('attempt')!r}"
                f" but restarts must count up from 1 (expected {i + 1})")
    if isinstance(config, dict):
        # ladder never overrides restart_backoff/seed, so the FIRST
        # header's values govern every segment's backoff
        from federated_pytorch_test_tpu_torch.control.supervisor import (
            restart_backoff_seconds)
        base = config.get("restart_backoff")
        seed = config.get("seed")
        if isinstance(base, (int, float)) and isinstance(seed, int):
            for rec in restarts:
                attempt = rec.get("attempt")
                got = rec.get("backoff_seconds")
                if not isinstance(attempt, int):
                    continue
                want = restart_backoff_seconds(float(base), seed, attempt)
                if got != want:
                    errors.append(
                        f"supervisor restart attempt {attempt}: recorded "
                        f"backoff_seconds={got!r} but the seeded formula "
                        f"gives {want!r} (base={base}, seed={seed})")
    return len(sup)


def check_cohort_records(segments: List[List[Dict[str, Any]]],
                         errors: List[str]) -> int:
    """Verify recorded population cohorts against the seeded sampler.

    Population mode: every ``client`` record's ``registry_ids`` must
    equal ``population.sampler.sample_cohort`` recomputed from the
    header config (``seed``/``population``/``K``/``cohort_sampling``)
    and the matching round record's loop coordinates.  The cohort draw
    is stateless and frac-free (the control plane's cohort rung masks
    slots, it never perturbs WHICH ids were drawn), so the whole
    sequence re-derives from the header alone — across kill/resume and
    mesh-reshape segment boundaries exactly like policy decisions.
    """
    from federated_pytorch_test_tpu_torch.population.sampler import sample_cohort

    checked = 0
    for si, segment in enumerate(segments):
        header = next((r for r in segment
                       if r.get("event") == "run_header"), None)
        config = (header or {}).get("config")
        crecs = [r for r in segment if r.get("event") == "client"
                 and isinstance(r.get("registry_ids"), list)]
        if not crecs:
            continue
        pop = (config or {}).get("population") if isinstance(config, dict) \
            else None
        if not isinstance(pop, int) or pop <= 0:
            errors.append(
                f"segment {si}: client record(s) carry registry_ids but "
                "the header config has population off (or no config "
                "snapshot) — cannot have been produced by this "
                "configuration")
            continue
        K = int(config.get("K", 0))
        seed = int(config.get("seed", 0))
        method = str(config.get("cohort_sampling", "uniform"))
        coords: Dict[int, Tuple] = {}
        for r in segment:
            if (r.get("event") == "round"
                    and isinstance(r.get("round_index"), int)):
                coords.setdefault(
                    r["round_index"],
                    (r.get("nloop"), r.get("block"), r.get("nadmm")))
        for rec in crecs:
            ridx = rec.get("round_index")
            c = coords.get(ridx)
            if c is None or not all(isinstance(v, int) for v in c):
                errors.append(
                    f"segment {si} round {ridx}: client record carries "
                    "registry_ids but no round record supplies the loop "
                    "coordinates to recompute the draw")
                continue
            checked += 1
            want = sample_cohort(pop, K, seed=seed, nloop=c[0], ci=c[1],
                                 nadmm=c[2], method=method).tolist()
            got = [int(v) for v in rec["registry_ids"]]
            if got != want:
                errors.append(
                    f"segment {si} round {ridx}: recorded cohort "
                    f"{got[:8]}{'...' if len(got) > 8 else ''} diverges "
                    f"from the seeded draw "
                    f"{want[:8]}{'...' if len(want) > 8 else ''} "
                    f"(seed={seed}, population={pop}, method={method})")
    return checked


def check_campaign_records(segments: List[List[Dict[str, Any]]],
                           errors: List[str]) -> int:
    """Verify recorded campaign windows against the compiled schedule.

    Soak campaigns: every ``campaign`` record is a
    pure function of (header ``campaign_spec``, the round indices this
    segment completed) — the schedule compiler is stateless, so the
    exact emission sequence (first round of the segment, every
    virtual-hour boundary, every deterministic-preemption window)
    re-derives from the header alone and must match the stream
    field-by-field, bit-exactly.  A campaign record in a segment whose
    header has no campaign is a forgery, exactly like cohorts.
    """
    from federated_pytorch_test_tpu_torch.campaign.schedule import (
        CAMPAIGN_FIELDS, CampaignSchedule)

    checked = 0
    for si, segment in enumerate(segments):
        header = next((r for r in segment
                       if r.get("event") == "run_header"), None)
        config = (header or {}).get("config")
        crecs = [r for r in segment if r.get("event") == "campaign"]
        spec = (config or {}).get("campaign_spec") \
            if isinstance(config, dict) else None
        try:
            sched = CampaignSchedule.parse(spec)
        except ValueError as e:
            errors.append(f"segment {si}: unparseable campaign_spec "
                          f"{spec!r} in the header config: {e}")
            continue
        if sched is None:
            if crecs:
                errors.append(
                    f"segment {si}: {len(crecs)} campaign record(s) but "
                    "the header config has no campaign (or no config "
                    "snapshot) — cannot have been produced by this "
                    "configuration")
            continue
        rounds = [r["round_index"] for r in segment
                  if r.get("event") == "round"
                  and isinstance(r.get("round_index"), int)]
        expected = sched.expected_emissions(rounds)
        checked += len(crecs)
        for i in range(max(len(expected), len(crecs))):
            if i >= len(expected):
                errors.append(
                    f"segment {si} campaign record {i}: recorded but NOT "
                    "derivable from the schedule (round_index="
                    f"{crecs[i].get('round_index')!r})")
                continue
            ridx, fields = expected[i]
            if i >= len(crecs):
                errors.append(
                    f"segment {si} campaign record {i}: derived from the "
                    f"schedule (round {ridx}) but missing from the stream")
                continue
            got = {k: crecs[i].get(k) for k in CAMPAIGN_FIELDS}
            if got != fields:
                diff = ", ".join(
                    f"{k}: recorded {got[k]!r} != derived {fields[k]!r}"
                    for k in CAMPAIGN_FIELDS if got[k] != fields[k])
                errors.append(
                    f"segment {si} campaign record {i} (round {ridx}) "
                    f"diverges: {diff}")
    return checked


def check_serve_records(segments: List[List[Dict[str, Any]]],
                        errors: List[str]) -> int:
    """Verify recorded serving rounds against the serve schedule.

    Serving plane: every round a serving segment
    completes emits exactly one ``serve`` record whose PURE fields —
    ``weights_version`` (= 1 + round // swap_every), the tag-83
    ``requests`` draw, the batch plan (``batches``/``padded_slots``/
    ``padding_waste_frac``), ``swap`` and ``drift_injected`` — are
    functions of (header ``serve_spec``, round_index) alone, so the
    whole sequence re-derives from the header and must match the stream
    field-by-field, bit-exactly.  Latency/QPS/swap-gap/accuracy fields
    are advisory wall-clock telemetry and are NOT compared.  A serve
    record in a serving-off segment is a forgery, exactly like cohorts
    and campaign windows.
    """
    from federated_pytorch_test_tpu_torch.serve.batcher import (
        SERVE_FIELDS, ServeSchedule)

    checked = 0
    for si, segment in enumerate(segments):
        header = next((r for r in segment
                       if r.get("event") == "run_header"), None)
        config = (header or {}).get("config")
        srecs = [r for r in segment if r.get("event") == "serve"]
        spec = (config or {}).get("serve_spec") \
            if isinstance(config, dict) else None
        try:
            sched = ServeSchedule.parse(spec)
        except ValueError as e:
            errors.append(f"segment {si}: unparseable serve_spec "
                          f"{spec!r} in the header config: {e}")
            continue
        if sched is None:
            if srecs:
                errors.append(
                    f"segment {si}: {len(srecs)} serve record(s) but "
                    "the header config has serving off (or no config "
                    "snapshot) — cannot have been produced by this "
                    "configuration")
            continue
        rounds = [r["round_index"] for r in segment
                  if r.get("event") == "round"
                  and isinstance(r.get("round_index"), int)]
        expected = sched.expected_records(rounds)
        checked += len(srecs)
        for i in range(max(len(expected), len(srecs))):
            if i >= len(expected):
                errors.append(
                    f"segment {si} serve record {i}: recorded but NOT "
                    "derivable from the schedule (round_index="
                    f"{srecs[i].get('round_index')!r})")
                continue
            ridx, fields = expected[i]
            if i >= len(srecs):
                errors.append(
                    f"segment {si} serve record {i}: derived from the "
                    f"schedule (round {ridx}) but missing from the stream")
                continue
            got = {k: srecs[i].get(k) for k in SERVE_FIELDS}
            if got != fields:
                diff = ", ".join(
                    f"{k}: recorded {got[k]!r} != derived {fields[k]!r}"
                    for k in SERVE_FIELDS if got[k] != fields[k])
                errors.append(
                    f"segment {si} serve record {i} (round {ridx}) "
                    f"diverges: {diff}")
    return checked


def read_records(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    """Parse a JSONL run file; optionally schema-validate every record."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: not JSON ({e})")
            if validate:
                try:
                    validate_record(rec)
                except SchemaError as e:
                    raise SchemaError(f"{path}:{lineno}: {e}")
            records.append(rec)
    return records


def replay(records: List[Dict[str, Any]]) -> Tuple[List[str], Dict[str, int]]:
    """Full replay check; returns (errors, stats)."""
    errors: List[str] = []
    segments = segment_stream(records)
    n_policy = check_policy_records(segments, errors)
    n_sup = check_supervisor_records(records, errors)
    n_cohort = check_cohort_records(segments, errors)
    n_campaign = check_campaign_records(segments, errors)
    n_serve = check_serve_records(segments, errors)
    return errors, {"segments": len(segments), "policy_records": n_policy,
                    "supervisor_records": n_sup,
                    "cohort_records": n_cohort,
                    "campaign_records": n_campaign,
                    "serve_records": n_serve}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m federated_pytorch_test_tpu_torch.control.replay",
        description="Re-derive control decisions from a recorded obs "
                    "JSONL and diff against the recorded control "
                    "records")
    p.add_argument("path", help="run JSONL file")
    args = p.parse_args(argv)
    try:
        records = read_records(args.path)
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    errors, stats = replay(records)
    if errors:
        print(f"REPLAY DIVERGED ({len(errors)} problem(s)) over "
              f"{stats['segments']} segment(s):")
        for e in errors:
            print(f"  - {e}")
        return 1
    print(f"replay OK: {stats['policy_records']} policy decision(s), "
          f"{stats['supervisor_records']} supervisor record(s), "
          f"{stats['cohort_records']} cohort record(s), "
          f"{stats['campaign_records']} campaign record(s) and "
          f"{stats['serve_records']} serve record(s) reproduce "
          f"across {stats['segments']} segment(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
