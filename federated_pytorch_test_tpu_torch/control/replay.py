"""Replay CLI: re-derive control decisions from a recorded stream.

Port of ``federated_pytorch_test_tpu/control/replay.py`` with the checks
of what the port emits: policy decisions, supervisor records, population
cohorts, campaign windows, serving rounds and the elastic reshapes.

``python -m federated_pytorch_test_tpu_torch.control.replay run.jsonl``
reads an obs JSONL artifact, rebuilds the :class:`~.policy.ControlPolicy`
from each segment's run-header ``config`` snapshot, feeds the segment's
round, alert and client records through it IN FILE ORDER, and diffs the
derived decision sequence against the recorded ``control`` records.
Supervisor records are checked too: the seeded backoff of every
``restart`` record is recomputed from (``restart_backoff``, ``seed``,
``attempt``) and the attempt numbers must count up from 1, and every
change of the client mesh between two segments must be announced by one
supervisor ``reshape`` record that names both meshes
(:func:`check_reshape_records`).  Under population federation every
``client`` record's ``registry_ids`` must re-derive from the seeded
sampler; every ``campaign`` record must equal the
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
from federated_pytorch_test_tpu_torch.obs.report import read_records
from federated_pytorch_test_tpu_torch.obs.schema import SchemaError

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


def _segment_mesh(segment: List[Dict[str, Any]]) -> Optional[int]:
    header = next((r for r in segment
                   if r.get("event") == "run_header"), None)
    mesh = (header or {}).get("mesh_shape")
    if isinstance(mesh, dict) and isinstance(mesh.get("clients"), int):
        return mesh["clients"]
    return None


def check_reshape_records(segments: List[List[Dict[str, Any]]],
                          errors: List[str]) -> int:
    """Verify supervisor ``reshape`` records against the mesh headers.

    The elastic-federation contract: every mesh-size change between
    consecutive segments must be announced by EXACTLY ONE ``reshape``
    control record in the dying segment, whose ``from_value`` is that
    segment's header mesh and ``to_value`` the next segment's — a
    dropped or tampered record is a replay divergence (exit 1), like
    any other decision.  A reshape record in the final segment (no
    successor header to check against) is left unverified: the
    resumed process may simply have been killed before its header.
    """
    checked = 0
    for si, segment in enumerate(segments):
        reshapes = [r for r in segment if r.get("event") == "control"
                    and r.get("source") == "supervisor"
                    and r.get("intervention") == "reshape"]
        checked += len(reshapes)
        d_here = _segment_mesh(segment)
        d_next = (_segment_mesh(segments[si + 1])
                  if si + 1 < len(segments) else None)
        if d_here is None or d_next is None:
            continue
        if d_here != d_next:
            if not reshapes:
                errors.append(
                    f"segment {si}: mesh reshaped {d_here} -> {d_next} "
                    "devices with NO reshape control record in the dying "
                    "segment (record dropped?)")
                continue
            if len(reshapes) > 1:
                errors.append(
                    f"segment {si}: {len(reshapes)} reshape records for "
                    "one mesh change (expected exactly one)")
            rec = reshapes[0]
            if (rec.get("from_value") != d_here
                    or rec.get("to_value") != d_next):
                errors.append(
                    f"segment {si}: reshape record says "
                    f"{rec.get('from_value')!r} -> {rec.get('to_value')!r}"
                    f" but the run headers say {d_here} -> {d_next} "
                    "(record tampered?)")
        elif reshapes:
            errors.append(
                f"segment {si}: reshape record(s) present but the next "
                f"segment resumed on the SAME {d_here}-device mesh "
                "(record forged?)")
    return checked


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


def replay(records: List[Dict[str, Any]]) -> Tuple[List[str], Dict[str, int]]:
    """Full replay check; returns (errors, stats)."""
    errors: List[str] = []
    segments = segment_stream(records)
    n_policy = check_policy_records(segments, errors)
    n_sup = check_supervisor_records(records, errors)
    n_reshape = check_reshape_records(segments, errors)
    n_cohort = check_cohort_records(segments, errors)
    n_campaign = check_campaign_records(segments, errors)
    n_serve = check_serve_records(segments, errors)
    return errors, {"segments": len(segments), "policy_records": n_policy,
                    "supervisor_records": n_sup,
                    "reshape_records": n_reshape,
                    "cohort_records": n_cohort,
                    "campaign_records": n_campaign,
                    "serve_records": n_serve}


def selftest() -> str:
    """Synthesize a stream through the REAL recorder+controller pipeline,
    then assert replay reproduces it (exit 0) and detects tampering
    (exit 1) — chained into ``report --selftest``."""
    import os
    import tempfile

    from federated_pytorch_test_tpu_torch.control.policy import (
        controller_from_config)
    from federated_pytorch_test_tpu_torch.obs.recorder import make_recorder

    config = {"K": 2, "control": "observe", "control_policy": "eager",
              "compress": "none", "max_staleness": 4, "trim_frac": 0.1,
              "default_batch": 128, "robust_agg": "none",
              "fused_collective": False, "async_rounds": False,
              "health_window": 8, "seed": 0, "restart_backoff": 1.0}

    def synth(d: str, rounds, mesh: Optional[int] = None,
              name: str = "ctl-selftest") -> str:
        rec = make_recorder("jsonl", d, run_name=name,
                            engine="selftest", algorithm="fedavg")
        controller_from_config(config, recorder=rec)
        rec.open(config=config,
                 mesh_shape=None if mesh is None else {"clients": mesh})
        for i, comm in enumerate(rounds):
            rec.round({"round_index": i, "nloop": 0, "block": 0,
                       "nadmm": i, "N": 10, "loss": 1.0, "rho": 1.0,
                       "round_seconds": 1.0, "comm_seconds": comm,
                       "images": 256})
        rec.close()
        return os.path.join(d, f"{name}.jsonl")

    with tempfile.TemporaryDirectory() as d:
        # comm fraction 0.8 for 2 rounds trips the eager preset's
        # escalation streak — exactly one decision fires
        path = synth(d, [0.8, 0.8, 0.1, 0.1])
        records = read_records(path)
        ctl_recs = [r for r in records if r.get("event") == "control"]
        assert len(ctl_recs) == 1, ctl_recs
        assert ctl_recs[0]["intervention"] == "escalate_compression", \
            ctl_recs
        assert ctl_recs[0]["to_value"] == "q8", ctl_recs
        assert "time_unix" not in ctl_recs[0], \
            "control records must not carry wall-clock time"
        errors, stats = replay(records)
        assert not errors, errors
        assert stats["policy_records"] == 1, stats

        # healthy stream: zero decisions, replay still passes
        d2 = os.path.join(d, "healthy")
        os.makedirs(d2, exist_ok=True)
        errors2, _ = replay(read_records(synth(d2, [0.1, 0.1, 0.1])))
        assert not errors2, errors2

        # tampering: flip the decision's to_value -> divergence
        tampered = []
        for r in records:
            r = dict(r)
            if r.get("event") == "control":
                r["to_value"] = "topk"
            tampered.append(r)
        errors3, _ = replay(tampered)
        assert errors3 and "diverges" in errors3[0], errors3

        # tampering: drop the record entirely -> "missing from stream"
        dropped = [r for r in records if r.get("event") != "control"]
        errors4, _ = replay(dropped)
        assert errors4 and "missing from the stream" in errors4[0], \
            errors4

        # supervisor backoff verification catches a forged value
        from federated_pytorch_test_tpu_torch.control.supervisor import (
            restart_backoff_seconds)
        from federated_pytorch_test_tpu_torch.obs.schema import SCHEMA_VERSION
        good = restart_backoff_seconds(1.0, 0, 1)
        sup = {"event": "control", "schema": SCHEMA_VERSION,
               "run_id": "x", "round_index": 3, "source": "supervisor",
               "mode": "act", "applied": True, "intervention": "restart",
               "param": "run", "attempt": 1, "backoff_seconds": good,
               "reason": "selftest"}
        errors5, _ = replay(records + [sup])
        assert not errors5, errors5
        errors6, _ = replay(records
                            + [dict(sup, backoff_seconds=good + 1.0)])
        assert errors6 and "seeded formula" in errors6[0], errors6

        # elastic reshape verification: a two-segment stream whose mesh
        # shrinks 8 -> 4 with the matching reshape record replays clean;
        # tampering the record or dropping it is a divergence
        d3 = os.path.join(d, "reshape")
        os.makedirs(d3, exist_ok=True)
        seg_a = read_records(synth(d3, [0.1, 0.1], mesh=8, name="seg-a"))
        seg_b = read_records(synth(d3, [0.1], mesh=4, name="seg-b"))
        reshape = {"event": "control", "schema": SCHEMA_VERSION,
                   "run_id": "x", "round_index": 1,
                   "source": "supervisor", "mode": "act", "applied": True,
                   "intervention": "reshape", "param": "num_devices",
                   "from_value": 8, "to_value": 4, "scope": "restart",
                   "attempt": 1, "reason": "selftest preemption"}
        elastic = seg_a + [sup, reshape] + seg_b
        errors7, stats7 = replay(elastic)
        assert not errors7, errors7
        assert stats7["reshape_records"] == 1, stats7
        errors8, _ = replay(
            [dict(r, to_value=3) if r.get("intervention") == "reshape"
             else r for r in elastic])
        assert errors8 and "tampered" in errors8[0], errors8
        errors9, _ = replay(
            [r for r in elastic if r.get("intervention") != "reshape"])
        assert errors9 and "dropped" in errors9[0], errors9

        # population cohorts: registry_ids re-derive from the seeded
        # sampler; a tampered id list is a divergence
        from federated_pytorch_test_tpu_torch.population.sampler import (
            sample_cohort)
        d5 = os.path.join(d, "pop")
        os.makedirs(d5, exist_ok=True)
        base = read_records(synth(d5, [0.1, 0.1], name="pop"))
        popped = [dict(r, config=dict(config, population=16))
                  if r.get("event") == "run_header" else r for r in base]
        clients = []
        for r in base:
            if r.get("event") == "round":
                ids = sample_cohort(16, 2, seed=0, nloop=r["nloop"],
                                    ci=r["block"], nadmm=r["nadmm"],
                                    method="uniform")
                clients.append({"event": "client",
                                "schema": SCHEMA_VERSION, "run_id": "x",
                                "round_index": r["round_index"],
                                "clients": 2,
                                "registry_ids": ids.tolist()})
        errors10, stats10 = replay(popped + clients)
        assert not errors10, errors10
        assert stats10["cohort_records"] == 2, stats10
        bad = [dict(c) for c in clients]
        bad[0]["registry_ids"] = [(v + 1) % 16
                                  for v in bad[0]["registry_ids"]]
        errors11, _ = replay(popped + bad)
        assert errors11 and "seeded draw" in errors11[0], errors11
        # registry_ids on a population-off stream is itself a divergence
        errors12, _ = replay(base + clients)
        assert errors12 and "population off" in errors12[0], errors12

        # campaign windows: records re-derive from the header's
        # campaign_spec + completed round indices; tampering a window
        # field, dropping an emission, or forging a record on a
        # campaign-off stream all diverge
        from federated_pytorch_test_tpu_torch.campaign.schedule import (
            CampaignSchedule)
        spec = "hours=3,round_minutes=30,diurnal=0.5,drop=0.2,seed=9"
        sched = CampaignSchedule.parse(spec)
        d6 = os.path.join(d, "campaign")
        os.makedirs(d6, exist_ok=True)
        camp_base = read_records(
            synth(d6, [0.1] * sched.total_rounds, name="campaign"))
        camped = [dict(r, config=dict(config, campaign_spec=spec))
                  if r.get("event") == "run_header" else r
                  for r in camp_base]
        camp_recs = [dict({"event": "campaign",
                           "schema": SCHEMA_VERSION, "run_id": "x"},
                          **fields)
                     for _, fields in sched.expected_emissions(
                         range(sched.total_rounds))]
        errors13, stats13 = replay(camped + camp_recs)
        assert not errors13, errors13
        assert stats13["campaign_records"] == len(camp_recs) >= 3, stats13
        bad_camp = [dict(c) for c in camp_recs]
        bad_camp[1]["drop_p"] = round(bad_camp[1]["drop_p"] + 0.01, 6)
        errors14, _ = replay(camped + bad_camp)
        assert errors14 and "diverges" in errors14[0], errors14
        errors15, _ = replay(camped + camp_recs[:-1])
        assert errors15 and "missing from the stream" in errors15[0], \
            errors15
        # campaign record on a campaign-off stream is a forgery
        errors16, _ = replay(camp_base + camp_recs[:1])
        assert errors16 and "no campaign" in errors16[0], errors16

        # serve records: the pure fields re-derive from the header's
        # serve_spec + completed rounds; tampering the version, dropping
        # a round, or forging a record on a serving-off stream diverge
        from federated_pytorch_test_tpu_torch.serve.batcher import ServeSchedule
        sspec = "qps=16,round_minutes=0.5,swap_every=2,seed=5"
        ssched = ServeSchedule.parse(sspec)
        d7 = os.path.join(d, "serve")
        os.makedirs(d7, exist_ok=True)
        serve_base = read_records(synth(d7, [0.1] * 4, name="serve"))
        served = [dict(r, config=dict(config, serve_spec=sspec))
                  if r.get("event") == "run_header" else r
                  for r in serve_base]
        serve_recs = [dict({"event": "serve", "schema": SCHEMA_VERSION,
                            "run_id": "x", "serve_qps": 123.4}, **fields)
                      for _, fields in ssched.expected_records(range(4))]
        errors17, stats17 = replay(served + serve_recs)
        assert not errors17, errors17
        assert stats17["serve_records"] == 4, stats17
        bad_serve = [dict(c) for c in serve_recs]
        bad_serve[2]["weights_version"] += 1
        errors18, _ = replay(served + bad_serve)
        assert errors18 and "diverges" in errors18[0], errors18
        errors19, _ = replay(served + serve_recs[:-1])
        assert errors19 and "missing from the stream" in errors19[0], \
            errors19
        errors20, _ = replay(serve_base + serve_recs[:1])
        assert errors20 and "serving off" in errors20[0], errors20
        json.dumps(stats)  # stats stay JSON-representable
    return "control replay selftest: OK (decisions reproduce; tampering detected)"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m federated_pytorch_test_tpu_torch.control.replay",
        description="Re-derive control decisions from a recorded obs "
                    "JSONL and diff against the recorded control "
                    "records")
    p.add_argument("path", nargs="?", help="run JSONL file")
    p.add_argument("--selftest", action="store_true",
                   help="run the built-in replay selftest and exit")
    args = p.parse_args(argv)
    if args.selftest:
        print(selftest())
        return 0
    if not args.path:
        p.error("a run JSONL path is required (or --selftest)")
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
          f"{stats['reshape_records']} reshape record(s), "
          f"{stats['cohort_records']} cohort record(s), "
          f"{stats['campaign_records']} campaign record(s) and "
          f"{stats['serve_records']} serve record(s) reproduce "
          f"across {stats['segments']} segment(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
