"""The port's stream readers (``obs/report``, ``obs/trace``,
``obs/clients``, ``obs/profile``, ``obs/compare``), their selftests and
``--be-verbose``, against the JAX package.

- Two streams of the same tiny run (FedAvg, K=4, Net, partial
  participation, drops, x100 corruption and the guard): one written by the
  JAX engine, one by the port's.  Every reader of each package reads both,
  and the port's output equals JAX's exactly: the ``--json`` object of
  ``report``, ``clients`` and ``profile``, the Chrome trace JSON of
  ``trace``, and ``compare``'s JSON and exit code.  The text formats agree
  once the port's module path in the hint strings is mapped to JAX's.
- ``compare`` on the repo's own ``BASELINE.json``, ``BENCH_r0*.json`` and
  ``artifacts/bench_*.json``: the same JSON and exit codes.
- ``python -m federated_pytorch_test_tpu_torch.obs.report --selftest`` in
  a subprocess exits 0 without ``jax`` in ``sys.modules``; each chained
  selftest also runs on its own.
- ``--be-verbose``: the same run prints one ``verbose:`` line an epoch in
  both packages, with the same coordinates; the per-client losses agree
  at the engine pair's loss tolerance, rtol 1e-4, plus 1e-4 for the two
  four-digit prints.  Through a port driver on the CPU, the lines sum to
  each round record's ``loss``.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from _torch_engine_pair import run_both, torch_threads
from _torch_tmp_cwd import tmp_cwd  # noqa: F401

from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.obs import clients as j_clients
from federated_pytorch_test_tpu.obs import compare as j_compare
from federated_pytorch_test_tpu.obs import profile as j_profile
from federated_pytorch_test_tpu.obs import report as j_report
from federated_pytorch_test_tpu.obs import trace as j_trace
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.control import replay as t_replay
from federated_pytorch_test_tpu_torch.drivers import fedprox_multi
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.obs import clients as t_clients
from federated_pytorch_test_tpu_torch.obs import compare as t_compare
from federated_pytorch_test_tpu_torch.obs import profile as t_profile
from federated_pytorch_test_tpu_torch.obs import report as t_report
from federated_pytorch_test_tpu_torch.obs import trace as t_trace
from federated_pytorch_test_tpu_torch.train import algorithms as talg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTACK = dict(participation=0.5, update_guard=True,
              fault_spec="drop=0.2,corrupt=0.3,mode=scale,scale=100,seed=1")
NADMM = 2
BLOCKS = 2
STREAMS = ("jax", "port")
READERS = {"report": (j_report, t_report), "clients": (j_clients, t_clients),
           "profile": (j_profile, t_profile)}
VERBOSE = re.compile(r"verbose: block=(\d+) nadmm=(\d+) epoch=(\d+) "
                     r"client_loss=\[(.*)\]", re.S)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny run of each package with ``be_verbose``; their streams and
    their log lines."""
    d = tmp_path_factory.mktemp("readers")
    jlines, tlines = [], []
    out = run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(),
                   dict(Nadmm=NADMM, check_results=False, be_verbose=True,
                        obs_dir=str(d / "jax"), obs_sinks="jsonl,memory",
                        **ATTACK),
                   blocks=BLOCKS, port_cfg=dict(obs_dir=str(d / "port")),
                   jlog=jlines.append, tlog=tlines.append)
    paths = {}
    for side in STREAMS:
        files = [f for f in os.listdir(d / side) if f.endswith(".jsonl")]
        assert len(files) == 1
        paths[side] = str(d / side / files[0])
    return dict(out, paths=paths, jlines=jlines, tlines=tlines, dir=d)


def call(main, argv) -> tuple:
    """(exit code, stdout, stderr) of a reader's ``main(argv)``."""
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = main(argv)
        except SystemExit as ex:
            rc = ex.code
    return rc, o.getvalue(), e.getvalue()


def unport(text: str) -> str:
    return text.replace("federated_pytorch_test_tpu_torch",
                        "federated_pytorch_test_tpu")


# ---------------------------------------------------------------------------
# report, clients, profile


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("reader", sorted(READERS))
def test_json_equals_jax(run, reader, stream):
    jmod, tmod = READERS[reader]
    argv = ["--json", run["paths"][stream]]
    if reader == "clients":
        argv += ["--cohorts", "2"]
    got, want = call(tmod.main, argv), call(jmod.main, argv)
    assert got == want
    assert got[0] == 0 and json.loads(got[1])


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("reader", sorted(READERS))
def test_text_equals_jax(run, reader, stream):
    jmod, tmod = READERS[reader]
    argv = [run["paths"][stream]]
    if reader == "clients":
        argv += ["--cohorts", "2", "--top", "3"]
    rc, out, err = call(tmod.main, argv)
    assert (rc, unport(out), err) == call(jmod.main, argv)
    assert rc == 0 and out


@pytest.mark.parametrize("stream", STREAMS)
def test_report_counts_the_stream(run, stream):
    """The summary's totals are the stream's own."""
    recs = t_report.read_records(run["paths"][stream])
    s = t_report.summarize(recs)
    rounds = [r for r in recs if r["event"] == "round"]
    assert s["rounds"] == len(rounds) == BLOCKS * NADMM
    assert s["bytes_on_wire_total"] == sum(r["bytes_on_wire"]
                                           for r in rounds)
    assert s["clients_observed"] == 4 and s["client_records"] == len(rounds)


@pytest.mark.parametrize("expect,rc", [(None, 0), (99, 2)])
def test_clients_expect_top_exit_codes(run, expect, rc):
    argv = [run["paths"]["port"], "--json", "--no-validate"]
    if expect is not None:
        argv += ["--expect-top", str(expect)]
    got = call(t_clients.main, argv)
    assert got[0] == rc and got == call(j_clients.main, argv)


# ---------------------------------------------------------------------------
# trace


@pytest.mark.parametrize("stream", STREAMS)
def test_trace_equals_jax(run, stream, tmp_path):
    src = run["paths"][stream]
    tout, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    rc, out, err = call(t_trace.main, [src, "-o", tout])
    want = call(j_trace.main, [src, "-o", jout])
    assert (rc, out.replace(tout, jout), err) == want and rc == 0
    with open(tout) as f, open(jout) as g:
        text = f.read()
        assert text == g.read()
    trace = json.loads(text)
    t_trace.validate_chrome_trace(trace)
    cats = {e.get("cat") for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"run", "round", "phase"} <= cats, cats


# ---------------------------------------------------------------------------
# compare


@pytest.mark.parametrize("pair", ["self", "cross"])
def test_compare_streams_equal_jax(run, pair):
    p = run["paths"]
    base = p["jax"] if pair == "cross" else p["port"]
    argv = [p["port"], "--baseline", base, "--json"]
    got = call(t_compare.main, argv)
    assert got == call(j_compare.main, argv)
    res = json.loads(got[1])
    if pair == "self":
        assert got[0] == 0 and res["regressions"] == 0
        assert {c["verdict"] for row in res["rows"]
                for c in row["cells"]} <= {"ok(noise)", "info"}
    md = [p["port"], p["jax"], "--baseline", base]
    rc, out, err = call(t_compare.main, md)
    assert (rc, out, err) == call(j_compare.main, md)


COMPARE_CASES = {
    "bench_vs_baseline": ["BENCH_r05.json", "--baseline", "BASELINE.json"],
    "artifact_vs_baseline": ["artifacts/bench_tpu_2026-07-30.json",
                             "--baseline", "BASELINE.json"],
    "artifacts_vs_artifact": ["artifacts/bench_tpu_2026-07-30.json",
                              "artifacts/bench_tpu_2026-07-31_devdata.json",
                              "--baseline",
                              "artifacts/bench_tpu_2026-07-30.json"],
    "glob_vs_bench": ["artifacts/bench_tpu_*.json", "--baseline",
                      "BENCH_r05.json"],
    "unparsed_wrapper": ["BENCH_r01.json", "--baseline", "BASELINE.json"],
    "soak": ["artifacts/soak.json", "--baseline",
             "artifacts/SOAK_BASELINE.json"],
}


@pytest.mark.parametrize("fmt", ["json", "markdown"])
@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_repo_artifacts_equal_jax(case, fmt, monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = COMPARE_CASES[case] + (["--json"] if fmt == "json" else [])
    got = call(t_compare.main, argv)
    assert got == call(j_compare.main, argv)
    assert got[0] in (0, 1, 2)
    if case == "unparsed_wrapper":
        assert got[0] == 2


# ---------------------------------------------------------------------------
# selftests


def test_report_selftest_subprocess_without_jax():
    code = ("import sys; from federated_pytorch_test_tpu_torch.obs import "
            "report; rc = report.main(['--selftest', '--device', 'cpu']); "
            "print('jax loaded:', 'jax' in sys.modules); sys.exit(rc)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "obs report selftest: OK" in p.stdout
    assert p.stdout.strip().splitlines()[-1] == "jax loaded: False"


SELFTESTS = {
    "obs.trace": (), "obs.health": (), "obs.compare": (),
    "obs.profile": (), "obs.clients": (), "control.replay": (),
    "campaign.schedule": (), "campaign.clock": (), "campaign.harness": (),
    "serve.batcher": (), "serve.swap": ("cpu",), "serve.infer": ("cpu",),
    "serve.evalstream": (), "obs.report": ("cpu",),
}


@pytest.mark.parametrize("name", sorted(SELFTESTS))
def test_selftest(name):
    import importlib

    mod = importlib.import_module(f"federated_pytorch_test_tpu_torch.{name}")
    mod.selftest(*SELFTESTS[name])


def test_replay_reads_through_report():
    """``control.replay`` has no JSONL parser of its own."""
    assert t_replay.read_records is t_report.read_records


# ---------------------------------------------------------------------------
# --be-verbose


def verbose_lines(lines) -> list:
    """(block, nadmm, epoch, losses) of every ``verbose:`` log line."""
    out = []
    for line in lines:
        m = VERBOSE.fullmatch(line)
        if m:
            out.append((int(m[1]), int(m[2]), int(m[3]),
                        np.asarray(m[4].split(), np.float64)))
    return out


def test_be_verbose_lines_equal_jax(run):
    got, want = verbose_lines(run["tlines"]), verbose_lines(run["jlines"])
    assert len(got) == len(want) == BLOCKS * NADMM
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[3], w[3], rtol=1e-4, atol=1e-4)


def test_be_verbose_driver_lines_sum_to_round_loss(tmp_cwd):
    """Through a driver: one line an epoch of a round, and each round's
    ``loss`` is its clients' losses summed over its epochs."""
    logs = []
    _, _, history = fedprox_multi.main(
        ["--device", "cpu", "--K", "3", "--model", "net", "--Nloop", "1",
         "--Nadmm", "2", "--Nepoch", "2", "--n-train", "24", "--n-test",
         "16", "--default-batch", "16", "--no-save-model", "--obs-sinks",
         "none", "--no-check-results", "--be-verbose"], log=logs.append)
    lines = verbose_lines(logs)
    assert len(lines) == len(history) * 2
    for r, rec in enumerate(history):
        mine = lines[2 * r: 2 * r + 2]
        assert [m[:3] for m in mine] == [
            (rec["block"], rec["nadmm"], e) for e in range(2)]
        total = sum(m[3] for m in mine)
        assert total.shape == (3,)
        np.testing.assert_allclose(total.sum(), rec["loss"], rtol=0,
                                   atol=1e-4 * total.size * 2 + 1e-6)
