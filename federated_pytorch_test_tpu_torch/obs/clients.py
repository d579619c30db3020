"""Client-grain flight recorder (schema v11): ledger, ranking, cohorts.

A copy of ``federated_pytorch_test_tpu/obs/clients.py`` for the port: the
writer side (:func:`client_round_fields`) and the reader side, with the
JAX module's names, flags, output keys and exit codes, so either package
ranks either package's streams alike.

The engines emit one ``client`` record per communication round — the
round record's counters, un-aggregated: parallel length-K lists of
per-client update norms, delta-vs-z distance, loss contribution, guard
verdicts, quarantine state, fault tags, async staleness/admission, and
churn membership (``obs/schema.py`` v10).  Under population federation
(``--population K``, schema v11) each record additionally carries
``registry_ids`` — the registry ids of the sampled cohort occupying the
K device slots that round — and the ledger rekeys every aggregate by
registry id: records stay cohort-sized while the ledger grows to the
set of clients ever sampled, byte-exactly reproducible from the stream
even though K vastly exceeds any single record's length.  The reader
side:

- :class:`ClientLedger` — streaming accumulator over ``client`` records
  (pure function of the stream, float64 host math: replaying the same
  JSONL reproduces every aggregate byte-exactly, across resume/restart
  segments too, because segments simply append records in file order).
- :func:`anomaly_scores` / :meth:`ClientLedger.ranking` — deterministic
  per-client anomaly composite::

      score_k = z(mean_norm_k) + z(mean_staleness_k)
                + 4 * guard_fail_rate_k + 4 * nonfinite_rate_k

  where ``z`` is the population z-score across clients that produced
  the statistic (clients without data score 0 on that term), computed
  in float64 with ties broken by ascending client id.  NaN/inf update
  norms are counted into ``nonfinite_rate`` — a ``corrupt=nan`` client
  tops the ranking even with guards off.
- ``python -m federated_pytorch_test_tpu_torch.obs.clients run.jsonl`` —
  per-client timelines (one glyph per round), the anomaly ranking, and
  an optional ``--cohorts N`` rollup view (contiguous id ranges).
- :func:`summarize_clients` — the dispersion fields ``obs/report.py``
  and ``obs/compare.py`` surface (max/median norm skew, top offender).

``--selftest`` round-trips a synthetic two-segment stream through the
real recorder and asserts the ranking (chained into
``report --selftest``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

#: timeline glyphs, highest-priority first (one per client per round)
_GLYPHS = (
    ("out", "_"),         # not a member this round (churn)
    ("quar", "q"),        # quarantined (sat the round out)
    ("drop", "D"),        # fault: dropped
    ("strag", "S"),       # fault: straggled (shipped stale params)
    ("corr", "C"),        # fault: corrupted delta on the wire
    ("gfail", "!"),       # guard rejected the update
    ("rej", "x"),         # async: arrived too stale, admission rejected
    ("ok", "."),          # participated cleanly
    ("idle", "-"),        # inactive (not sampled / update in flight)
)


def client_round_fields(round_index: int, clients: int, *,
                        update_norm=None, dist_z=None, loss=None,
                        weight=None, active=None, guard_ok=None,
                        quarantine=None, dropped=None, straggled=None,
                        corrupted=None, staleness=None, admitted=None,
                        members=None, registry_ids=None,
                        payload_bytes: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Assemble a schema-v11 ``client`` record body from host arrays.

    Every array argument is optional (advisory fields — absent means
    "that subsystem was off") and is coerced to a plain length-K Python
    list so the record validates and JSON-round-trips (NaN entries
    survive: the JSONL sink writes ``NaN``, ``json.loads`` reads it
    back).  ``staleness`` uses -1 for "no arrival this round".
    ``registry_ids`` (population mode) maps slot k to the registry id
    of the virtual client that occupied it this round.
    """
    fields: Dict[str, Any] = {"round_index": int(round_index),
                              "clients": int(clients)}

    def put(name, arr, cast):
        if arr is None:
            return
        a = np.asarray(arr).reshape(-1)
        if a.shape[0] != clients:
            raise ValueError(f"{name}: expected length {clients}, "
                             f"got {a.shape[0]}")
        fields[name] = [cast(v) for v in a.tolist()]

    put("update_norm", update_norm, float)
    put("dist_z", dist_z, float)
    put("loss_client", loss, float)
    put("weight", weight, float)
    put("active", active, float)
    put("guard_ok", guard_ok, float)
    put("quarantine", quarantine, int)
    put("dropped", dropped, float)
    put("straggled", straggled, float)
    put("corrupted", corrupted, float)
    put("staleness", staleness, int)
    put("admitted", admitted, float)
    put("members", members, float)
    put("registry_ids", registry_ids, int)
    if payload_bytes is not None:
        fields["payload_bytes"] = int(payload_bytes)
    return fields


#: per-client float64 aggregate arrays (one row per ledger client)
_STATS = ("norm_sum", "norm_n", "nonfinite", "dist_sum",
          "dist_n", "loss_sum", "weight_sum", "active_rounds",
          "guard_checks", "guard_fails", "quar_rounds",
          "drops", "straggles", "corrupts", "arrivals",
          "admits", "rejects", "stale_sum", "bytes",
          "member_rounds", "joins", "leaves")


class ClientLedger:
    """Streaming per-client accumulator over ``client`` records.

    Feed records in file order via :meth:`observe` (non-client events
    are ignored, so the whole stream can be piped through).  All
    aggregates are float64 numpy — a pure function of the stream, so
    recomputing from the recorded JSONL reproduces them bit-exactly
    (the replay contract the anomaly ranking inherits).

    Ledger rows are keyed by REGISTRY id: a record with
    ``registry_ids`` (population mode, schema v11) contributes its
    cohort-sized lists to the rows of the sampled clients only; rows
    are allocated on first sighting, so the ledger grows to the set of
    clients ever sampled while every record stays cohort-bounded.
    Records without ``registry_ids`` key slot k to client id k — the
    mapping is the identity for dense streams, so every pre-population
    aggregate is byte-identical.
    """

    def __init__(self):
        self.clients = 0              # distinct clients observed (rows)
        self.records = 0              # client records observed
        self.sparse = False           # saw a registry_ids record
        self._rounds: List[int] = []  # round_index per record, file order
        #: per record: (ledger-row index array, [k] glyphs)
        self._glyphs: List[Any] = []
        self._idmap: Dict[int, int] = {}   # registry id -> ledger row
        self._rids: List[int] = []         # ledger row -> registry id
        self._prev_members = np.zeros(0, bool)
        self._prev_seen = np.zeros(0, bool)

    def _rows(self, rids: List[int]) -> np.ndarray:
        """Ledger rows for this record's ids, allocating new rows (and
        growing every aggregate array) for first-seen clients."""
        pad = 0
        for r in rids:
            if r not in self._idmap:
                self._idmap[r] = len(self._rids)
                self._rids.append(r)
                pad += 1
        if pad:
            z = lambda: np.zeros(pad, np.float64)
            if self.clients == 0:
                for name in _STATS:
                    setattr(self, name, z())
            else:
                for name in _STATS:
                    setattr(self, name,
                            np.concatenate([getattr(self, name), z()]))
            self._prev_members = np.concatenate(
                [self._prev_members, np.zeros(pad, bool)])
            self._prev_seen = np.concatenate(
                [self._prev_seen, np.zeros(pad, bool)])
            self.clients = len(self._rids)
        return np.asarray([self._idmap[r] for r in rids], np.int64)

    def observe(self, rec: Dict[str, Any]) -> None:
        """Accumulate one record; ignores everything but ``client``."""
        if rec.get("event") != "client":
            return
        k = int(rec.get("clients", 0))
        if k <= 0:
            return
        reg = rec.get("registry_ids")
        if isinstance(reg, list) and len(reg) == k:
            rids = [int(r) for r in reg]
            self.sparse = True
        else:
            rids = list(range(k))
        idx = self._rows(rids)
        self.records += 1
        self._rounds.append(int(rec.get("round_index", -1)))

        def arr(name, default=None):
            v = rec.get(name)
            if not isinstance(v, list) or len(v) != k:
                return default
            return np.asarray(v, np.float64)

        norm = arr("update_norm")
        if norm is not None:
            finite = np.isfinite(norm)
            self.norm_sum[idx[finite]] += norm[finite]
            self.norm_n[idx[finite]] += 1.0
            self.nonfinite[idx[~finite]] += 1.0
        dist = arr("dist_z")
        if dist is not None:
            fin = np.isfinite(dist)
            self.dist_sum[idx[fin]] += dist[fin]
            self.dist_n[idx[fin]] += 1.0
        loss = arr("loss_client")
        if loss is not None:
            fin = np.isfinite(loss)
            self.loss_sum[idx[fin]] += loss[fin]
        active = arr("active")
        act = (active > 0) if active is not None else np.zeros(k, bool)
        if active is not None:
            self.active_rounds[idx] += act.astype(np.float64)
        weight = arr("weight")
        if weight is not None:
            self.weight_sum[idx] += weight
        gok = arr("guard_ok")
        gfail = np.zeros(k, bool)
        if gok is not None and active is not None:
            gfail = act & (gok < 0.5)
            self.guard_checks[idx] += act.astype(np.float64)
            self.guard_fails[idx] += gfail.astype(np.float64)
        quar = arr("quarantine")
        quarm = (quar > 0) if quar is not None else np.zeros(k, bool)
        self.quar_rounds[idx] += quarm.astype(np.float64)
        drop = arr("dropped")
        strag = arr("straggled")
        corr = arr("corrupted")
        dropm = (drop > 0) if drop is not None else np.zeros(k, bool)
        stragm = (strag > 0) if strag is not None else np.zeros(k, bool)
        corrm = (corr > 0) if corr is not None else np.zeros(k, bool)
        self.drops[idx] += dropm.astype(np.float64)
        self.straggles[idx] += stragm.astype(np.float64)
        self.corrupts[idx] += corrm.astype(np.float64)
        stale = arr("staleness")
        admitted = arr("admitted")
        rejm = np.zeros(k, bool)
        if stale is not None:
            arrived = stale >= 0
            adm = (admitted > 0) if admitted is not None else arrived
            rejm = arrived & ~adm
            self.arrivals[idx] += arrived.astype(np.float64)
            self.admits[idx] += (arrived & adm).astype(np.float64)
            self.rejects[idx] += rejm.astype(np.float64)
            self.stale_sum[idx[arrived & adm]] += stale[arrived & adm]
        pb = rec.get("payload_bytes")
        if isinstance(pb, (int, float)) and not isinstance(pb, bool):
            self.bytes[idx] += float(pb) * act.astype(np.float64)
        members = arr("members")
        outm = np.zeros(k, bool)
        if members is not None:
            mem = members > 0
            outm = ~mem
            self.member_rounds[idx] += mem.astype(np.float64)
            # join/leave transitions only for rows with a known previous
            # state: a first sighting is baseline, not a transition —
            # exactly the old dense behaviour (no counting on record 1)
            seen = self._prev_seen[idx]
            prev = self._prev_members[idx]
            self.joins[idx[seen & mem & ~prev]] += 1.0
            self.leaves[idx[seen & ~mem & prev]] += 1.0
            self._prev_members[idx] = mem
            self._prev_seen[idx] = True
        else:
            # no churn field: first-seen rows default to member (the
            # old `ones(k)` baseline), known rows keep their last state
            fresh = idx[~self._prev_seen[idx]]
            self._prev_members[fresh] = True
            self._prev_seen[fresh] = True

        # one glyph per client for the timeline view (priority order)
        nonfin = (~np.isfinite(norm)) if norm is not None \
            else np.zeros(k, bool)
        row = []
        for i in range(k):
            if outm[i]:
                g = "_"
            elif quarm[i]:
                g = "q"
            elif dropm[i]:
                g = "D"
            elif stragm[i]:
                g = "S"
            elif corrm[i] or nonfin[i]:
                g = "C"
            elif gfail[i]:
                g = "!"
            elif rejm[i]:
                g = "x"
            elif act[i]:
                g = "."
            else:
                g = "-"
            row.append(g)
        self._glyphs.append((idx, row))

    # -- derived statistics ---------------------------------------------

    def _rate(self, num: np.ndarray, den: np.ndarray) -> np.ndarray:
        return num / np.maximum(den, 1.0)

    def mean_norms(self) -> np.ndarray:
        """Per-client mean of FINITE update norms; NaN when none seen."""
        out = np.full(self.clients, np.nan, np.float64)
        have = self.norm_n > 0
        out[have] = self.norm_sum[have] / self.norm_n[have]
        return out

    def anomaly_scores(self) -> np.ndarray:
        """The deterministic composite (module docstring formula)."""
        k = self.clients
        if k == 0:
            return np.zeros(0, np.float64)

        def zscore(values: np.ndarray, have: np.ndarray) -> np.ndarray:
            z = np.zeros(k, np.float64)
            if have.sum() >= 2:
                v = values[have]
                sd = float(np.std(v))
                if sd > 0.0:
                    z[have] = (v - float(np.mean(v))) / sd
            return z

        mean_norm = self.mean_norms()
        z_norm = zscore(np.nan_to_num(mean_norm, nan=0.0),
                        self.norm_n > 0)
        stale_mean = self._rate(self.stale_sum, self.admits)
        z_stale = zscore(stale_mean, self.admits > 0)
        gfail_rate = self._rate(self.guard_fails, self.guard_checks)
        nobs = self.norm_n + self.nonfinite
        nonfin_rate = self._rate(self.nonfinite, nobs)
        return z_norm + z_stale + 4.0 * gfail_rate + 4.0 * nonfin_rate

    def ids(self) -> List[int]:
        """Observed client (registry) ids, ascending; dense streams
        yield ``0..K-1``."""
        return sorted(self._rids)

    def ranking(self) -> List[Dict[str, Any]]:
        """Clients sorted by anomaly score (desc), ties by id (asc).

        ``client`` is the REGISTRY id (== the dense slot id on
        non-population streams)."""
        scores = self.anomaly_scores()
        rids = np.asarray(self._rids, np.int64).reshape(-1)
        order = np.lexsort((rids, -scores))
        mean_norm = self.mean_norms()
        out = []
        for i in order:
            i = int(i)
            out.append({
                "client": int(rids[i]),
                "score": float(scores[i]),
                "mean_norm": (None if not np.isfinite(mean_norm[i])
                              else float(mean_norm[i])),
                "nonfinite": int(self.nonfinite[i]),
                "guard_fails": int(self.guard_fails[i]),
                "drops": int(self.drops[i]),
                "straggles": int(self.straggles[i]),
                "corrupts": int(self.corrupts[i]),
                "rejects": int(self.rejects[i]),
                "active_rounds": int(self.active_rounds[i]),
                "bytes": int(self.bytes[i]),
            })
        return out

    def summary_fields(self) -> Dict[str, Any]:
        """Dispersion fields for report/compare ({} with no records)."""
        if self.records == 0:
            return {}
        mean_norm = self.mean_norms()
        finite = mean_norm[np.isfinite(mean_norm)]
        scores = self.anomaly_scores()
        rids = np.asarray(self._rids, np.int64).reshape(-1)
        top = int(np.lexsort((rids, -scores))[0])
        out: Dict[str, Any] = {
            "client_records": self.records,
            "clients_observed": self.clients,
            "top_offender": int(rids[top]),
            "top_offender_score": float(scores[top]),
        }
        if finite.size:
            mx, med = float(np.max(finite)), float(np.median(finite))
            out["client_norm_max"] = mx
            out["client_norm_median"] = med
            if med > 0.0:
                out["client_norm_skew"] = mx / med
        if np.any(self.bytes > 0):
            out["client_bytes_max"] = float(np.max(self.bytes))
            out["client_bytes_median"] = float(np.median(self.bytes))
        return out

    def cohorts(self, n: int) -> List[Dict[str, Any]]:
        """Contiguous-id cohort rollup (the virtualization-ready view:
        when clients outnumber chips, a cohort is the scheduling unit
        and the ledger key stays ``client_id``)."""
        k = self.clients
        n = max(1, min(int(n), k)) if k else 0
        out = []
        scores = self.anomaly_scores()
        mean_norm = self.mean_norms()
        rids = np.asarray(self._rids, np.int64).reshape(-1)
        order = np.argsort(rids, kind="stable")   # rows in id order
        bounds = [round(j * k / n) for j in range(n + 1)]
        for j in range(n):
            lo, hi = bounds[j], bounds[j + 1]
            if hi <= lo:
                continue
            rows = order[lo:hi]
            mn = mean_norm[rows]
            mn = mn[np.isfinite(mn)]
            out.append({
                "cohort": j,
                "clients": f"{rids[rows[0]]}..{rids[rows[-1]]}",
                "mean_norm": float(np.mean(mn)) if mn.size else None,
                "faults": int(self.drops[rows].sum()
                              + self.straggles[rows].sum()
                              + self.corrupts[rows].sum()),
                "guard_fails": int(self.guard_fails[rows].sum()),
                "bytes": int(self.bytes[rows].sum()),
                "score_max": float(np.max(scores[rows])),
            })
        return out

    def timelines(self) -> List[str]:
        """One glyph string per client (ascending id — :meth:`ids`
        order), rounds left to right; '-' where a client was not in
        that round's record (population mode: not sampled)."""
        cols = []
        for idx, row in self._glyphs:
            col = np.full(self.clients, "-", dtype="<U1")
            col[idx] = row
            cols.append(col)
        rids = np.asarray(self._rids, np.int64).reshape(-1)
        order = np.argsort(rids, kind="stable")
        return ["".join(col[i] for col in cols) for i in order]


def ledger_from_records(records: Sequence[Dict[str, Any]]) -> ClientLedger:
    led = ClientLedger()
    for rec in records:
        led.observe(rec)
    return led


def summarize_clients(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Client-dispersion summary fields of a stream ({} when none)."""
    return ledger_from_records(records).summary_fields()


def format_clients(led: ClientLedger, *, top: int = 10,
                   cohorts: int = 0) -> str:
    """Human-readable flight-recorder view."""
    if led.records == 0:
        return "no client records in stream (client_ledger off, or a " \
               "pre-v10 artifact)"
    if led.sparse:
        lines = [f"client ledger: {led.clients} registry client(s) "
                 f"observed (sparse cohorts), {led.records} round "
                 f"record(s)"]
    else:
        lines = [f"client ledger: K={led.clients}, {led.records} round "
                 f"record(s)"]
    lines.append("  timeline glyphs: " + " ".join(
        f"{g}={name}" for name, g in _GLYPHS))
    tls = led.timelines()
    ids = led.ids()
    width = max(len(str(max(ids))), 2)
    for i, tl in zip(ids, tls):
        lines.append(f"  c{i:<{width}} |{tl}|")
    rank = led.ranking()
    lines.append(f"anomaly ranking (top {min(top, len(rank))}; "
                 "score = z(norm) + z(staleness) + 4*guard_fail_rate "
                 "+ 4*nonfinite_rate):")
    hdr = (f"  {'rank':<5}{'client':<7}{'score':>8}  {'mean_norm':>10}"
           f"  {'nonfin':>6}{'gfail':>6}{'drop':>5}{'strag':>6}"
           f"{'corr':>5}{'rej':>4}  {'bytes':>10}")
    lines.append(hdr)
    for r, row in enumerate(rank[:top], 1):
        mn = ("-" if row["mean_norm"] is None
              else f"{row['mean_norm']:.4g}")
        lines.append(
            f"  {r:<5}{row['client']:<7}{row['score']:>8.3f}  {mn:>10}"
            f"  {row['nonfinite']:>6}{row['guard_fails']:>6}"
            f"{row['drops']:>5}{row['straggles']:>6}{row['corrupts']:>5}"
            f"{row['rejects']:>4}  {row['bytes']:>10}")
    s = led.summary_fields()
    if "client_norm_skew" in s:
        lines.append(f"norm skew: max={s['client_norm_max']:.4g} "
                     f"median={s['client_norm_median']:.4g} "
                     f"skew={s['client_norm_skew']:.3f}")
    if cohorts:
        lines.append(f"cohort rollup ({cohorts} cohort(s)):")
        for c in led.cohorts(cohorts):
            mn = ("-" if c["mean_norm"] is None
                  else f"{c['mean_norm']:.4g}")
            lines.append(
                f"  cohort {c['cohort']} [{c['clients']}] "
                f"mean_norm={mn} faults={c['faults']} "
                f"guard_fails={c['guard_fails']} bytes={c['bytes']} "
                f"score_max={c['score_max']:.3f}")
    return "\n".join(lines)


def selftest() -> str:
    """Synthesize a two-segment stream through the REAL recorder, then
    assert ledger units, ranking determinism, and the JSONL replay
    contract (chained into tier-1 ``report --selftest``)."""
    import os
    import tempfile

    from federated_pytorch_test_tpu_torch.obs.recorder import make_recorder
    from federated_pytorch_test_tpu_torch.obs.report import read_records

    K = 4
    nan = float("nan")

    def emit_round(rec, i, *, resumed_offset=0):
        ri = i + resumed_offset
        rec.round({"round_index": ri, "nloop": 0, "block": 0, "nadmm": ri,
                   "N": 10, "loss": 1.0, "rho": 1.0, "round_seconds": 0.1,
                   "images": 64})
        # client 2 ships NaN every round; client 3 straggles on round 1
        norm = [1.0, 1.1, nan, 0.9]
        rec.client_event(client_round_fields(
            ri, K,
            update_norm=norm,
            dist_z=[0.5, 0.6, nan, 0.4],
            loss=[0.2, 0.3, 0.1, 0.4],
            weight=[1.0, 1.0, 1.0, 1.0],
            active=[1.0, 1.0, 1.0, 0.0 if i == 1 else 1.0],
            guard_ok=[1.0, 1.0, 0.0, 1.0],
            quarantine=[0, 0, 0, 0],
            dropped=[0.0, 0.0, 0.0, 0.0],
            straggled=[0.0, 0.0, 0.0, 1.0 if i == 1 else 0.0],
            corrupted=[0.0, 0.0, 1.0, 0.0],
            staleness=[0, 0, 0, -1],
            admitted=[1.0, 1.0, 1.0, 0.0],
            members=[1.0, 1.0, 1.0, 1.0],
            payload_bytes=40))

    with tempfile.TemporaryDirectory() as d:
        # two segments in one file: a resumed run appends to the stream,
        # and the ledger/ranking must be a pure function of file order
        rec = make_recorder("jsonl", d, run_name="clients_selftest",
                            engine="selftest", algorithm="fedavg")
        rec.open(config={"K": K})
        for i in range(2):
            emit_round(rec, i)
        rec.close(status="aborted")
        rec2 = make_recorder("jsonl", d, run_name="clients_selftest",
                             engine="selftest", algorithm="fedavg")
        rec2.jsonl_path = rec.jsonl_path
        rec2.open(config={"K": K}, resumed=True, rounds_prior=2)
        emit_round(rec2, 0, resumed_offset=2)
        rec2.close()
        path = os.path.join(d, "clients_selftest.jsonl")
        records = read_records(path)
        crecs = [r for r in records if r["event"] == "client"]
        assert len(crecs) == 3, \
            f"segment 2 must append to the same stream: {len(crecs)}"
        led = ledger_from_records(records)
        # ledger units vs hand-computed values (2 rounds + 1 resumed)
        assert led.clients == K and led.records == 3
        assert led.nonfinite[2] == 3 and led.norm_n[2] == 0, \
            (led.nonfinite, led.norm_n)
        assert abs(led.mean_norms()[0] - 1.0) < 1e-12
        assert led.guard_fails.tolist() == [0.0, 0.0, 3.0, 0.0]
        assert led.straggles.tolist() == [0.0, 0.0, 0.0, 1.0]
        assert led.active_rounds.tolist() == [3.0, 3.0, 3.0, 2.0]
        assert led.bytes.tolist() == [120.0, 120.0, 120.0, 80.0]
        rank = led.ranking()
        assert rank[0]["client"] == 2, rank
        assert rank[0]["score"] > rank[1]["score"], rank
        # replay contract: recompute from the SAME parsed stream —
        # byte-identical scores (float64 repr equality)
        led2 = ledger_from_records(read_records(path))
        assert (led.anomaly_scores().tobytes()
                == led2.anomaly_scores().tobytes()), "ranking not replayable"
        s = led.summary_fields()
        assert s["top_offender"] == 2, s
        assert s["client_norm_max"] >= s["client_norm_median"] > 0, s
        cz = led.cohorts(2)
        assert len(cz) == 2 and cz[1]["guard_fails"] == 3, cz
        table = format_clients(led, cohorts=2)
        assert "anomaly ranking" in table and "cohort 1" in table
        tls = led.timelines()
        assert tls[2][0] == "C", tls     # corrupted glyph wins
        assert tls[3][1] == "S", tls     # straggle on round 1

    # sparse population cohorts (schema v11): each record carries only
    # the sampled cohort, keyed by registry id — the ledger grows to
    # the clients ever seen and '-' fills unsampled rounds
    nan = float("nan")
    recs = [dict(event="client", schema=11, run_id="x", round_index=0,
                 clients=2, registry_ids=[3, 900],
                 update_norm=[1.0, 1.0], active=[1.0, 1.0]),
            dict(event="client", schema=11, run_id="x", round_index=1,
                 clients=2, registry_ids=[3, 41],
                 update_norm=[1.0, nan], active=[1.0, 1.0])]
    sled = ledger_from_records(recs)
    assert sled.sparse and sled.clients == 3
    assert sled.ids() == [3, 41, 900]
    assert sled.ranking()[0]["client"] == 41          # NaN shipper, by rid
    assert sled.summary_fields()["top_offender"] == 41
    tl = dict(zip(sled.ids(), sled.timelines()))
    assert tl[3] == ".." and tl[41] == "-C" and tl[900] == ".-", tl
    assert (ledger_from_records(recs).anomaly_scores().tobytes()
            == sled.anomaly_scores().tobytes())
    return "obs clients selftest: OK (NaN client ranks first; replayable)"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m federated_pytorch_test_tpu_torch.obs.clients",
        description="Per-client flight-recorder view of an obs run JSONL "
                    "(see README 'Observability')")
    p.add_argument("paths", nargs="*",
                   help="run JSONL file(s); multi-segment streams and "
                        "multiple files are folded in argument order")
    p.add_argument("--top", type=int, default=10,
                   help="ranking rows to print (default 10)")
    p.add_argument("--cohorts", type=int, default=0,
                   help="also print an N-cohort contiguous rollup")
    p.add_argument("--expect-top", type=int, default=None, metavar="ID",
                   help="exit 2 unless the anomaly rank-1 client is ID "
                        "(CI assertion hook; ID is the REGISTRY id on "
                        "population streams)")
    p.add_argument("--json", action="store_true",
                   help="print {ranking, summary, cohorts} as one JSON "
                        "object (deterministic: byte-identical across "
                        "recomputations of the same stream)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip schema validation while parsing")
    p.add_argument("--selftest", action="store_true",
                   help="run the built-in selftest and exit")
    args = p.parse_args(argv)
    if args.selftest:
        print(selftest())
        return 0
    if not args.paths:
        p.error("at least one run JSONL path is required (or --selftest)")
    from federated_pytorch_test_tpu_torch.obs.report import read_records
    from federated_pytorch_test_tpu_torch.obs.schema import SchemaError
    led = ClientLedger()
    try:
        for path in args.paths:
            for rec in read_records(path, validate=not args.no_validate):
                led.observe(rec)
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json:
        out = {"ranking": led.ranking(), "summary": led.summary_fields()}
        if args.cohorts:
            out["cohorts"] = led.cohorts(args.cohorts)
        print(json.dumps(out))
    else:
        print(format_clients(led, top=args.top, cohorts=args.cohorts))
    if args.expect_top is not None:
        rank = led.ranking()
        got = rank[0]["client"] if rank else None
        if got != args.expect_top:
            print(f"error: expected client {args.expect_top} at anomaly "
                  f"rank 1, got {got!r}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
