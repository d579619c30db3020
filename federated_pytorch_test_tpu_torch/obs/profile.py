"""Device-cost profile CLI over the obs JSONL artifact (schema v6).

A copy of ``federated_pytorch_test_tpu/obs/profile.py`` for the port, whole:
``python -m federated_pytorch_test_tpu_torch.obs.profile run.jsonl`` reads
the ``compile`` records and cost-annotated ``round`` records of a stream
and renders the sections below.  The JAX package's cost ledger
(``obs/costs.py``) writes those records; the port has no jit and writes
none, so on the port's own streams the compile, cache, cold/warm and
reconciliation sections come out empty (as they do on a JAX stream without
compiles) and the attribution splits each round into execute, stage and
host.

- **jit sites** — top-N sites by total compile wall-seconds, with event
  counts, cold (first-trace) vs warm split, per-site cache hits/misses
  and cost-model FLOPs.
- **attribution** — round wall-clock split compile / execute / stage /
  host, summed over rounds; the four segments reconstruct round_seconds
  (the selftest asserts the identity, the CLI prints the coverage %).
- **cache** — persistent-compile-cache effectiveness: hit/miss/unknown
  tallies, hit rate, and the mean compile seconds of hits vs misses.
- **utilization** — achieved FLOP/s and HLO bytes/s per
  (engine, algorithm) over the execute seconds, against peak figures
  from ``FEDTPU_PEAK_FLOPS`` / ``FEDTPU_PEAK_BYTES_PER_S`` (no peak is
  assumed; without one the achieved numbers print alone).  Cost-model
  FLOPs are *advisory* (PARITY.md).
- **reconciliation** — predicted ``bytes_on_wire`` from the compress/
  accounting vs the HLO bytes-accessed of the comm-step program(s).
  HLO bytes include parameter/activation traffic, so the ratio is a
  sanity band, not an equality; fused train+comm sites are flagged.
- **pareto** — bytes-on-wire × round-seconds rows per
  (engine, algorithm), front-marked (both-minimizing).

``--selftest`` synthesises a run through the real recorder (its
``compile`` records written straight to the recorder's JSONL sink, the
port's recorder having no ``compile_event``) and asserts the analysis
math (attribution identity, reconciliation ratio, cold/warm split) —
chained into ``report --selftest``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from federated_pytorch_test_tpu_torch.obs.report import read_records
from federated_pytorch_test_tpu_torch.obs.schema import SchemaError

#: peak device figures for utilization; only trusted when the operator
#: sets them (per device, in FLOP/s and bytes/s)
_PEAK_ENV = {"flops": "FEDTPU_PEAK_FLOPS",
             "bytes": "FEDTPU_PEAK_BYTES_PER_S"}

_DEVICE_PHASES = ("train_seconds", "comm_seconds", "sync_seconds",
                  "compute_seconds")


def _num(v) -> Optional[float]:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return None


def _peak(kind: str) -> Optional[float]:
    raw = os.environ.get(_PEAK_ENV[kind], "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def collect(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate compile records + cost-annotated rounds into the
    analysis dict the report sections render from."""
    rounds = [r for r in records if r.get("event") == "round"]
    compiles = [r for r in records if r.get("event") == "compile"]

    # ---- per-site ledger table ------------------------------------
    sites: Dict[str, Dict[str, Any]] = {}
    for c in compiles:
        site = c.get("site") or "?"
        s = sites.setdefault(site, {
            "site": site, "events": 0, "seconds": 0.0, "cold_events": 0,
            "cold_seconds": 0.0, "warm_seconds": 0.0, "cache_hits": 0,
            "cache_misses": 0, "flops": None, "hlo_bytes_accessed": None,
            "peak_device_bytes": None})
        secs = _num(c.get("compile_seconds")) or 0.0
        s["events"] += 1
        s["seconds"] += secs
        if c.get("trace_count") == 1:
            s["cold_events"] += 1
            s["cold_seconds"] += secs
        else:
            s["warm_seconds"] += secs
        if c.get("cache_hit") is True:
            s["cache_hits"] += 1
        elif c.get("cache_hit") is False:
            s["cache_misses"] += 1
        for k in ("flops", "hlo_bytes_accessed", "peak_device_bytes"):
            v = _num(c.get(k))
            if v is not None:
                s[k] = max(v, s[k]) if s[k] is not None else v
    site_rows = sorted(sites.values(), key=lambda s: -s["seconds"])

    # ---- round attribution ----------------------------------------
    # Per round: compile (in-window ledger seconds) | execute (device
    # phases minus compile — the compile wall-time sits inside the
    # train/comm dispatch windows) | stage (H2D) | host (the rest).
    # With no phase breakdown (no-consensus epochs) execute degrades to
    # total - compile so the identity still holds.
    att = {"round_seconds": 0.0, "compile": 0.0, "execute": 0.0,
           "stage": 0.0, "host": 0.0, "rounds": len(rounds),
           "rounds_with_compile": 0}
    for r in rounds:
        total = _num(r.get("round_seconds")) or 0.0
        compile_s = _num(r.get("compile_seconds")) or 0.0
        if compile_s:
            att["rounds_with_compile"] += 1
        stage_s = _num(r.get("stage_seconds")) or 0.0
        device_s = sum(_num(r.get(k)) or 0.0 for k in _DEVICE_PHASES)
        if device_s > 0:
            execute_s = max(0.0, device_s - compile_s)
            host_s = max(0.0, total - stage_s - device_s)
        else:
            execute_s = max(0.0, total - stage_s - compile_s)
            host_s = 0.0
        att["round_seconds"] += total
        att["compile"] += min(compile_s, total)
        att["execute"] += execute_s
        att["stage"] += stage_s
        att["host"] += host_s
    attributed = (att["compile"] + att["execute"] + att["stage"]
                  + att["host"])
    att["attributed"] = attributed
    att["coverage"] = (attributed / att["round_seconds"]
                       if att["round_seconds"] > 0 else None)

    # ---- cache effectiveness --------------------------------------
    hits = [c for c in compiles if c.get("cache_hit") is True]
    misses = [c for c in compiles if c.get("cache_hit") is False]
    cache = {
        "hits": len(hits), "misses": len(misses),
        "unknown": len(compiles) - len(hits) - len(misses),
        "hit_rate": (len(hits) / (len(hits) + len(misses))
                     if hits or misses else None),
        "hit_seconds_mean": (
            sum(_num(c.get("compile_seconds")) or 0.0 for c in hits)
            / len(hits) if hits else None),
        "miss_seconds_mean": (
            sum(_num(c.get("compile_seconds")) or 0.0 for c in misses)
            / len(misses) if misses else None),
    }

    # ---- cold / warm split ----------------------------------------
    cold = [c for c in compiles if c.get("trace_count") == 1]
    warm = [c for c in compiles if c.get("trace_count") not in (None, 1)]
    coldwarm = {
        "cold_events": len(cold),
        "cold_seconds": sum(_num(c.get("compile_seconds")) or 0.0
                            for c in cold),
        "warm_events": len(warm),
        "warm_seconds": sum(_num(c.get("compile_seconds")) or 0.0
                            for c in warm),
    }

    # ---- per-(engine, algorithm) utilization ----------------------
    groups: Dict[tuple, Dict[str, Any]] = {}
    for r in rounds:
        key = (r.get("engine") or "?", r.get("algorithm") or "-")
        g = groups.setdefault(key, {
            "engine": key[0], "algorithm": key[1], "rounds": 0,
            "flops": 0.0, "hlo_bytes": 0.0, "execute_seconds": 0.0,
            "round_seconds": 0.0, "wire_rounds": 0, "wire_bytes": 0.0,
            "peak_device_bytes": None})
        g["rounds"] += 1
        total = _num(r.get("round_seconds")) or 0.0
        g["round_seconds"] += total
        compile_s = _num(r.get("compile_seconds")) or 0.0
        device_s = sum(_num(r.get(k)) or 0.0 for k in _DEVICE_PHASES)
        if device_s > 0:
            g["execute_seconds"] += max(0.0, device_s - compile_s)
        else:
            g["execute_seconds"] += max(
                0.0, total - (_num(r.get("stage_seconds")) or 0.0)
                - compile_s)
        g["flops"] += _num(r.get("flops_round")) or 0.0
        g["hlo_bytes"] += _num(r.get("hlo_bytes_accessed")) or 0.0
        wire = _num(r.get("bytes_on_wire"))
        if wire is not None:
            g["wire_rounds"] += 1
            g["wire_bytes"] += wire
        pk = _num(r.get("peak_device_bytes"))
        if pk is not None:
            g["peak_device_bytes"] = (max(pk, g["peak_device_bytes"])
                                      if g["peak_device_bytes"] is not None
                                      else pk)
    peak_flops, peak_bytes = _peak("flops"), _peak("bytes")
    util_rows = []
    for g in groups.values():
        row = dict(g)
        ex = g["execute_seconds"]
        row["achieved_flops"] = g["flops"] / ex if ex > 0 else None
        row["achieved_bytes"] = g["hlo_bytes"] / ex if ex > 0 else None
        row["flops_utilization"] = (
            row["achieved_flops"] / peak_flops
            if row["achieved_flops"] is not None and peak_flops else None)
        row["bytes_utilization"] = (
            row["achieved_bytes"] / peak_bytes
            if row["achieved_bytes"] is not None and peak_bytes else None)
        util_rows.append(row)
    util_rows.sort(key=lambda r: (r["engine"], r["algorithm"]))

    # ---- bytes-on-wire reconciliation -----------------------------
    # predicted wire bytes (compress/ accounting on the round records)
    # vs the comm-step program's HLO bytes accessed.  HLO bytes include
    # every buffer the program touches, so ratio >> 1 is normal — the
    # row is a sanity band (a predicted figure LARGER than what the
    # program could move is the anomaly).
    wire_rounds = [r for r in rounds
                   if _num(r.get("bytes_on_wire")) is not None]
    wire_mean = (sum(_num(r["bytes_on_wire"]) for r in wire_rounds)
                 / len(wire_rounds)) if wire_rounds else None
    recon_rows = []
    for s in site_rows:
        name = s["site"]
        is_comm = name.startswith("comm[") or name.startswith("round[")
        is_fused = name.startswith("fused_round[")
        if not (is_comm or is_fused):
            continue
        hlo = s["hlo_bytes_accessed"]
        if hlo is None or wire_mean is None:
            continue
        recon_rows.append({
            "site": name, "predicted_wire_bytes": wire_mean,
            "hlo_bytes_accessed": hlo,
            "ratio": hlo / wire_mean if wire_mean > 0 else None,
            "fused": is_fused,
        })

    # ---- bytes-on-wire x round-seconds pareto ---------------------
    pareto_rows = []
    for g in groups.values():
        if not g["wire_rounds"] or not g["rounds"]:
            continue
        pareto_rows.append({
            "engine": g["engine"], "algorithm": g["algorithm"],
            "mean_wire_bytes": g["wire_bytes"] / g["wire_rounds"],
            "mean_round_seconds": g["round_seconds"] / g["rounds"],
        })
    for row in pareto_rows:
        row["pareto"] = not any(
            o is not row
            and o["mean_wire_bytes"] <= row["mean_wire_bytes"]
            and o["mean_round_seconds"] <= row["mean_round_seconds"]
            and (o["mean_wire_bytes"] < row["mean_wire_bytes"]
                 or o["mean_round_seconds"] < row["mean_round_seconds"])
            for o in pareto_rows)
    pareto_rows.sort(key=lambda r: r["mean_wire_bytes"])

    summaries = [r for r in records if r.get("event") == "summary"]
    mem = {}
    if summaries:
        last = summaries[-1]
        for k in ("mem_peak_bytes_watermark", "mem_final_vs_peak_bytes"):
            v = _num(last.get(k))
            if v is not None:
                mem[k] = int(v)

    return {"sites": site_rows, "attribution": att, "cache": cache,
            "coldwarm": coldwarm, "utilization": util_rows,
            "reconciliation": recon_rows, "pareto": pareto_rows,
            "memory": mem, "compile_events": len(compiles),
            "rounds": len(rounds),
            "peak_flops": peak_flops, "peak_bytes": peak_bytes}


def profile_metrics(records: List[Dict[str, Any]]) -> Dict[str, float]:
    """Flat direction-aware metrics for obs/compare.py (present-only:
    a run without ledger data contributes nothing)."""
    a = collect(records)
    out: Dict[str, float] = {}
    if a["compile_events"]:
        out["compile_seconds"] = float(
            sum(s["seconds"] for s in a["sites"]))
        out["compile_seconds_cold"] = float(a["coldwarm"]["cold_seconds"])
    peaks = [s["peak_device_bytes"] for s in a["sites"]
             if s["peak_device_bytes"] is not None]
    peaks += [g["peak_device_bytes"] for g in a["utilization"]
              if g.get("peak_device_bytes") is not None]
    if peaks:
        out["peak_device_bytes"] = float(max(peaks))
    utils = [g["flops_utilization"] for g in a["utilization"]
             if g.get("flops_utilization") is not None]
    if utils:
        out["utilization"] = float(max(utils))
    if a["cache"]["hit_rate"] is not None:
        out["cache_hit_rate"] = float(a["cache"]["hit_rate"])
    return out


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.0f} B" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


def _fmt_rate(n, unit: str) -> str:
    if n is None:
        return "-"
    for prefix, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6),
                          ("k", 1e3)):
        if abs(n) >= scale:
            return f"{n / scale:.2f} {prefix}{unit}"
    return f"{n:.2f} {unit}"


def format_report(a: Dict[str, Any], top: int = 10) -> str:
    """Render the collected analysis as the multi-section text report."""
    lines: List[str] = []
    lines.append(f"device-cost profile · {a['rounds']} round(s), "
                 f"{a['compile_events']} compile event(s)")

    att = a["attribution"]
    if att["round_seconds"] > 0:
        def seg(name, v):
            pct = 100.0 * v / att["round_seconds"]
            return f"{name} {v:.3f}s ({pct:.1f}%)"
        cov = att["coverage"]
        lines.append("attribution      "
                     + "  ".join([seg("compile", att["compile"]),
                                  seg("execute", att["execute"]),
                                  seg("stage", att["stage"]),
                                  seg("host", att["host"])]))
        lines.append(f"                 round wall-clock "
                     f"{att['round_seconds']:.3f}s, attributed "
                     f"{att['attributed']:.3f}s"
                     + (f" ({100.0 * cov:.1f}% coverage)"
                        if cov is not None else ""))

    cw = a["coldwarm"]
    if a["compile_events"]:
        lines.append(f"cold vs warm     cold {cw['cold_events']} event(s) "
                     f"{cw['cold_seconds']:.3f}s · warm "
                     f"{cw['warm_events']} event(s) "
                     f"{cw['warm_seconds']:.3f}s")

    cache = a["cache"]
    if cache["hits"] or cache["misses"] or cache["unknown"]:
        msg = (f"compile cache    hits={cache['hits']} "
               f"misses={cache['misses']} unknown={cache['unknown']}")
        if cache["hit_rate"] is not None:
            msg += f" · hit rate {100.0 * cache['hit_rate']:.0f}%"
        if (cache["hit_seconds_mean"] is not None
                and cache["miss_seconds_mean"] is not None):
            msg += (f" · mean hit {cache['hit_seconds_mean'] * 1e3:.1f}ms"
                    f" vs miss {cache['miss_seconds_mean'] * 1e3:.1f}ms")
        lines.append(msg)

    if a["memory"]:
        m = a["memory"]
        msg = ("device memory    watermark "
               + _fmt_bytes(m.get("mem_peak_bytes_watermark")))
        if "mem_final_vs_peak_bytes" in m:
            msg += (" · final vs peak "
                    + _fmt_bytes(m["mem_final_vs_peak_bytes"]))
        lines.append(msg)

    if a["sites"]:
        lines.append(f"top jit sites by compile seconds "
                     f"(showing {min(top, len(a['sites']))} of "
                     f"{len(a['sites'])}):")
        lines.append("  site                                   "
                     "events  cold   seconds   hit/miss  flops")
        for s in a["sites"][:top]:
            flops = _fmt_rate(s["flops"], "FLOP") if s["flops"] else "-"
            lines.append(
                f"  {s['site']:<38} {s['events']:>6} "
                f"{s['cold_events']:>5} {s['seconds']:>9.3f} "
                f"{s['cache_hits']:>5}/{s['cache_misses']:<4} {flops}")

    if a["utilization"]:
        lines.append("utilization per (engine, algorithm) "
                     "[cost-model FLOPs over execute seconds; advisory]:")
        for g in a["utilization"]:
            fl = _fmt_rate(g["achieved_flops"], "FLOP/s")
            by = _fmt_rate(g["achieved_bytes"], "B/s")
            msg = (f"  {g['engine']}/{g['algorithm']:<12} "
                   f"{fl:>14}  {by:>14}")
            if g["flops_utilization"] is not None:
                msg += f"  {100.0 * g['flops_utilization']:.1f}% of peak"
            elif a["peak_flops"] is None and g["achieved_flops"]:
                msg += "  (set FEDTPU_PEAK_FLOPS for % of peak)"
            lines.append(msg)

    if a["reconciliation"]:
        lines.append("bytes-on-wire reconciliation "
                     "(predicted wire bytes vs comm-step HLO bytes):")
        for r in a["reconciliation"]:
            ratio = (f"{r['ratio']:.2f}x" if r["ratio"] is not None
                     else "-")
            tag = " [fused train+comm]" if r["fused"] else ""
            lines.append(
                f"  {r['site']:<38} predicted "
                f"{_fmt_bytes(r['predicted_wire_bytes']):>10} · HLO "
                f"{_fmt_bytes(r['hlo_bytes_accessed']):>10} · "
                f"{ratio}{tag}")

    if a["pareto"]:
        lines.append("pareto rows (bytes-on-wire x round seconds):")
        for r in a["pareto"]:
            mark = "*" if r["pareto"] else " "
            lines.append(
                f" {mark} {r['engine']}/{r['algorithm']:<12} "
                f"{_fmt_bytes(r['mean_wire_bytes']):>10}/round · "
                f"{r['mean_round_seconds']:.3f} s/round")
    return "\n".join(lines)


def selftest() -> str:
    """Synthesise a cost-annotated run through the real recorder and
    assert the analysis math end to end."""
    import tempfile
    import uuid

    from federated_pytorch_test_tpu_torch.obs.recorder import make_recorder
    from federated_pytorch_test_tpu_torch.obs.schema import (
        SCHEMA_VERSION,
        json_safe,
        validate_record,
    )
    from federated_pytorch_test_tpu_torch.obs.sinks import JsonlSink

    def compile_record(rec, fields):
        """A ``compile`` record as the JAX recorder's ``compile_event``
        writes it (a span under the run span), validated and written
        through the recorder's JSONL sink."""
        out = {"event": "compile", "schema": SCHEMA_VERSION,
               "run_id": rec.run_id, "engine": rec.engine,
               "algorithm": rec.algorithm, **json_safe(fields),
               "span_id": uuid.uuid4().hex[:12],
               "parent_span": rec.run_span_id}
        validate_record(out)
        rec._grow_extent(out["t_start"], out["t_end"])
        for sink in rec.sinks:
            if isinstance(sink, JsonlSink):
                sink.emit(out)

    with tempfile.TemporaryDirectory() as d:
        rec = make_recorder("jsonl", d, run_name="profselftest",
                            engine="selftest", algorithm="fedavg")
        rec.open(config={"K": 2}, mesh_shape={"clients": 1})
        # round 0: cold compiles for train (0.30s) + comm (0.10s);
        # phases: stage .05 train .60 comm .20 sync .05, total 1.00
        rec.round({"round_index": 0, "round_seconds": 1.0,
                   "stage_seconds": 0.05, "train_seconds": 0.60,
                   "comm_seconds": 0.20, "sync_seconds": 0.05,
                   "compile_seconds": 0.40, "cache_hit": False,
                   "flops_round": 2.0e9, "hlo_bytes_accessed": 3.0e6,
                   "bytes_on_wire": 1000, "images": 256,
                   "t_start": 100.0, "loss": 2.0})
        compile_record(rec, {"site": "train_epoch[blk=0]",
                             "compile_seconds": 0.30, "trace_count": 1,
                             "cache_hit": False, "flops": 1.0e9,
                             "hlo_bytes_accessed": 1.5e6,
                             "t_start": 100.05, "t_end": 100.35,
                             "round_index": 0})
        compile_record(rec, {"site": "comm[dense,blk=0]",
                             "compile_seconds": 0.10, "trace_count": 1,
                             "cache_hit": False, "flops": 4.0e6,
                             "hlo_bytes_accessed": 1.5e4,
                             "t_start": 100.65, "t_end": 100.75,
                             "round_index": 0})
        # round 1: warm retrace served from the persistent cache
        rec.round({"round_index": 1, "round_seconds": 0.5,
                   "stage_seconds": 0.05, "train_seconds": 0.25,
                   "comm_seconds": 0.10, "sync_seconds": 0.05,
                   "compile_seconds": 0.02, "cache_hit": True,
                   "flops_round": 2.0e9, "hlo_bytes_accessed": 3.0e6,
                   "bytes_on_wire": 3000, "images": 256,
                   "t_start": 101.2, "loss": 1.5})
        compile_record(rec, {"site": "train_epoch[blk=1]",
                             "compile_seconds": 0.02, "trace_count": 2,
                             "cache_hit": True, "flops": 1.0e9,
                             "hlo_bytes_accessed": 1.5e6,
                             "t_start": 101.25, "t_end": 101.27,
                             "round_index": 1})
        rec.close()
        path = os.path.join(d, "profselftest.jsonl")
        records = read_records(path)
    a = collect(records)
    assert a["compile_events"] == 3 and a["rounds"] == 2, a
    att = a["attribution"]
    # attribution identity: compile .42 + execute (1.15 device - .42)
    # + stage .10 + host (1.50 - .10 - 1.15) = 1.50 == round total
    assert abs(att["round_seconds"] - 1.5) < 1e-9, att
    assert abs(att["compile"] - 0.42) < 1e-9, att
    assert abs(att["attributed"] - att["round_seconds"]) < 1e-9, att
    assert att["coverage"] is not None and abs(att["coverage"] - 1.0) < 1e-9
    cw = a["coldwarm"]
    assert cw["cold_events"] == 2 and abs(cw["cold_seconds"] - 0.40) < 1e-9
    assert cw["warm_events"] == 1 and abs(cw["warm_seconds"] - 0.02) < 1e-9
    cache = a["cache"]
    assert cache["hits"] == 1 and cache["misses"] == 2, cache
    assert abs(cache["hit_rate"] - 1 / 3) < 1e-9, cache
    # reconciliation: mean predicted wire bytes (1000+3000)/2 = 2000 vs
    # the comm site's 1.5e4 HLO bytes -> ratio 7.5
    recon = [r for r in a["reconciliation"]
             if r["site"] == "comm[dense,blk=0]"]
    assert recon and abs(recon[0]["predicted_wire_bytes"] - 2000.0) < 1e-9
    assert abs(recon[0]["ratio"] - 7.5) < 1e-9, recon
    # utilization: 4e9 flops over execute seconds —
    # (.85 device - .40 compile) + (.40 device - .02 compile) = .83
    util = a["utilization"]
    assert len(util) == 1, util
    assert abs(util[0]["achieved_flops"] - 4.0e9 / 0.83) < 1e-3, util
    assert a["pareto"] and a["pareto"][0]["pareto"] is True, a["pareto"]
    # metric extraction for obs/compare.py
    m = profile_metrics(records)
    assert abs(m["compile_seconds"] - 0.42) < 1e-9, m
    assert abs(m["compile_seconds_cold"] - 0.40) < 1e-9, m
    assert abs(m["cache_hit_rate"] - 1 / 3) < 1e-9, m
    table = format_report(a)
    assert "attribution" in table and "reconciliation" in table, table
    assert "pareto" in table, table
    return "obs profile selftest: OK (cost attribution reconstructs)"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m federated_pytorch_test_tpu_torch.obs.profile",
        description="Device-cost profile over an obs run JSONL "
                    "(see README 'Device cost observability')")
    p.add_argument("path", nargs="?", help="run JSONL file")
    p.add_argument("--top", type=int, default=10,
                   help="jit sites to show (default 10)")
    p.add_argument("--json", action="store_true",
                   help="print the analysis as one JSON object")
    p.add_argument("--no-validate", action="store_true",
                   help="skip schema validation while parsing")
    p.add_argument("--selftest", action="store_true",
                   help="run the built-in analysis selftest and exit")
    args = p.parse_args(argv)
    if args.selftest:
        print(selftest())
        return 0
    if not args.path:
        p.error("a run JSONL path is required (or --selftest)")
    try:
        records = read_records(args.path, validate=not args.no_validate)
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not records:
        print(f"error: {args.path} holds no records", file=sys.stderr)
        return 1
    a = collect(records)
    if args.json:
        print(json.dumps(a))
    else:
        print(format_report(a, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
