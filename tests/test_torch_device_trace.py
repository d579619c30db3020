"""``obs.trace --device-trace``: a ``torch.profiler`` Chrome trace's device
events placed on a record stream's timeline through the run header's
``clock_offset_ns``, and the card's idle gaps labelled by the innermost
program span or ``record_function`` range at their start.  The trace is
written by hand in kineto's shape (``baseTimeNanoseconds``, ``ts`` and
``dur`` in microseconds), with an annotation mirrored on the device and a
host operator that must both be ignored."""

import json

import pytest

from federated_pytorch_test_tpu_torch.obs import trace as obstrace

#: the stream's perf_counter clock to time.time_ns: a known offset
OFF = 1_700_000_000_000_000_000
#: the trace's base, 99 s into the stream's clock
BASE = OFF + 99_000_000_000

STREAM = [
    {"event": "run_header", "schema": 14, "run_id": "r",
     "engine": "classifier", "time_unix": OFF / 1e9,
     "clock_offset_ns": OFF, "span_id": "run"},
    {"event": "round", "schema": 14, "run_id": "r", "engine": "classifier",
     "round_index": 0, "round_seconds": 1.0, "t_start": 100.0, "t_end": 101.0,
     "span_id": "r0"},
    {"event": "span", "schema": 14, "run_id": "r", "span_id": "s0",
     "name": "train", "cat": "phase", "t_start": 100.1, "t_end": 100.8,
     "round_index": 0, "parent_span": "r0"},
    {"event": "round", "schema": 14, "run_id": "r", "engine": "classifier",
     "round_index": 1, "round_seconds": 1.0, "t_start": 101.5, "t_end": 102.5,
     "span_id": "r1"},
    {"event": "span", "schema": 14, "run_id": "r", "span_id": "s1",
     "name": "train", "cat": "phase", "t_start": 101.6, "t_end": 102.3,
     "round_index": 1, "parent_span": "r1"},
    {"event": "span", "schema": 14, "run_id": "r", "span_id": "run",
     "name": "run", "cat": "run", "t_start": 100.0, "t_end": 102.5},
]


def _ev(cat, name, t0, t1):
    """One complete event at stream-clock seconds [t0, t1]."""
    s = round(t0 * 1e9) + OFF
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": (s - BASE) / 1e3, "dur": (round(t1 * 1e9) + OFF - s) / 1e3}


TRACE = {"baseTimeNanoseconds": BASE, "traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    _ev("user_annotation", "comm_round#0", 99.9995, 101.2),
    _ev("user_annotation", "forward", 100.45, 100.6),
    _ev("user_annotation", "comm_round#1", 101.4995, 102.7),
    _ev("user_annotation", "evaluate", 102.55, 102.65),
    _ev("gpu_user_annotation", "comm_round#0", 99.9, 103.0),
    _ev("cpu_op", "aten::add", 100.5, 100.9),
    _ev("kernel", "k1", 100.0, 100.15),
    _ev("kernel", "k2", 100.25, 100.5),
    _ev("gpu_memcpy", "Memcpy HtoD", 100.85, 101.0),
    _ev("kernel", "k4", 101.0, 101.3),
    _ev("kernel", "k5", 101.7, 102.3),
    _ev("gpu_memset", "Memset", 102.5, 102.55),
]}

#: label -> (idle seconds, gaps): each gap's start and what covers it
GAPS = {"comm_round": (0.0005, 1),      # 99.9995: before round 0's record
        "train": (0.1, 1),              # 100.15: the train phase
        "forward": (0.35, 1),           # 100.5: the forward range
        "outside every span": (0.4, 1),  # 101.3: between the rounds
        "round": (0.2, 1),              # 102.3: round 1 after its train
        "evaluate": (0.15, 1)}          # 102.55: the evaluation's range


def test_device_events_land_on_the_stream_and_gaps_get_labels():
    res = obstrace.device_idle(STREAM, TRACE)
    assert res["window_s"] == pytest.approx(2.7005, abs=1e-9)
    assert res["busy_s"] == pytest.approx(1.5, abs=1e-9)
    assert res["idle_s"] == pytest.approx(1.2005, abs=1e-9)
    assert set(res["gaps"]) == set(GAPS)
    for label, (sec, n) in GAPS.items():
        assert res["gaps"][label][0] == pytest.approx(sec, abs=1e-9), label
        assert res["gaps"][label][1] == n
    assert sum(v[0] for v in res["gaps"].values()) == pytest.approx(
        res["idle_s"], abs=1e-9)
    assert res["clock_ms"] == {0: pytest.approx(-0.5, abs=1e-6),
                               1: pytest.approx(-0.5, abs=1e-6)}


def test_cli_prints_the_idle_table(tmp_path, capsys):
    jsonl, tr = tmp_path / "run.jsonl", tmp_path / "trace.json"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in STREAM))
    tr.write_text(json.dumps(TRACE))
    assert obstrace.main([str(jsonl), "--device-trace", str(tr)]) == 0
    out = capsys.readouterr().out
    assert "idle 1.200500 s" in out
    assert "forward" in out and "max |d| 0.500 ms" in out
    # a stream without the offset cannot be placed
    jsonl.write_text("".join(json.dumps({k: v for k, v in r.items()
                                         if k != "clock_offset_ns"}) + "\n"
                             for r in STREAM))
    assert obstrace.main([str(jsonl), "--device-trace", str(tr)]) == 1


def test_from_round_leaves_out_the_first_rounds():
    res = obstrace.device_idle(STREAM, TRACE, from_round=1)
    assert res["window_s"] == pytest.approx(1.2005, abs=1e-9)
    assert {k: pytest.approx(v[0], abs=1e-9) for k, v in res["gaps"].items()
            } == {"comm_round": 0.2005, "round": 0.2, "evaluate": 0.15}
    assert res["clock_ms"] == {1: pytest.approx(-0.5, abs=1e-6)}
