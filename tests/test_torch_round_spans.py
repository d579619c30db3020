"""The round's spans and counters (``train/engine.py`` ``_step_round``,
``utils/profiling.py`` ``StepClock``).

On the CPU, with a recorder writing, every round record of a fused and an
unfused Adam round of a small classifier carries the host's step phases,
the local epoch's host time, the evaluation's time and ``host_syncs`` at
the count the engine documents for its path; an L-BFGS block counts its
whole step as the optimizer's; the run's history carries none of the
fields, and without a recorder the numbers are bit for bit the same; the
run header's ``clock_offset_ns`` puts the round stamps on
``time.time_ns``'s clock;
under ``--profile-dir`` the phases are ranges inside ``comm_round#<n>``.

On the card (``card``), a steady fused Adam round of the ResNet18 stem
cell's shape runs under ``torch.cuda.set_sync_debug_mode("warn")`` with
its counted sites (``_host_wait``) let through: nothing else may sync.
The file imports no JAX, so it runs on a machine without it::

    python3 -m pytest tests/test_torch_round_spans.py --noconftest \
        -m card -q -p no:cacheprovider
"""

import contextlib
import json
import time
import warnings

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu_torch.models.resnet import ResNet18
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.train import algorithms as alg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves
from portbench.drive import HandedCifar10

K, NEPOCH = 4, 2
BASE = dict(device="cpu", K=K, Nloop=1, Nepoch=NEPOCH, Nadmm=2,
            default_batch=16, check_results=True, admm_rho0=0.1,
            biased_input=True, obs_sinks="memory")
PHASES = ("step_forward_seconds", "step_backward_seconds",
          "step_optimizer_seconds")
FIELDS = PHASES + ("epoch_host_seconds", "eval_seconds", "host_syncs")
#: the engine's documented host waits a round (device data, evaluation)
SYNCS = {"fused": 5, "unfused": 3 * NEPOCH + 4, "host": 5 * NEPOCH + 4}
PATHS = {"fused": dict(device_data=True, fused_rounds=True),
         "unfused": dict(device_data=True),
         "host": dict(device_data=False)}


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def images(k, n, batch, test, seed=0):
    """The program's CIFAR-10 pipeline over seeded random images: ``k``
    clients of ``n`` images in batches of ``batch``, ``test`` test
    images."""
    rng = np.random.default_rng(seed)
    px = lambda *s: rng.integers(0, 256, (*s, 32, 32, 3), dtype=np.uint8)
    return HandedCifar10(K=k, batch=batch, biased_input=True, handed=(
        px(k, n), rng.integers(0, 10, (k, n)), px(test),
        rng.integers(0, 10, test)))


def run(model=Net, log=lambda m: None, **kw):
    cfg = FederatedConfig(**dict(BASE, **kw))
    t = BlockwiseFederatedTrainer(model(), cfg, images(K, 40, 16, 32),
                                  alg.AdmmConsensus())
    t.L = 1
    with one_thread():
        state, hist = t.run(log=log)
    return t, state, hist


@pytest.fixture(scope="module")
def runs():
    return {name: run(**kw) for name, kw in PATHS.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_round_records_carry_the_spans(runs, path):
    t, _, hist = runs[path]
    recs = [r for r in t.obs_recorder.memory if r["event"] == "round"]
    assert len(recs) == len(hist) == 2
    for r in recs:
        assert set(FIELDS) <= set(r)
        assert "comm_device_seconds" not in r        # no card
        assert all(r[k] >= 0 for k in FIELDS)
        phases = sum(r[k] for k in PHASES)
        assert 0 < phases <= r["epoch_host_seconds"] <= r["train_seconds"]
        assert r["host_syncs"] == SYNCS[path]


def test_lbfgs_step_counts_as_optimizer():
    t, _, _ = run(optimizer="lbfgs", device_data=True, Nepoch=1)
    for r in (r for r in t.obs_recorder.memory if r["event"] == "round"):
        assert r["step_forward_seconds"] == r["step_backward_seconds"] == 0
        assert 0 < r["step_optimizer_seconds"] <= r["epoch_host_seconds"]


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_without_a_recorder_nothing_changes(runs, path):
    _, sa, ha = runs[path]
    _, sb, hb = run(obs_sinks="none", **PATHS[path])
    for ra, rb in zip(ha, hb):
        # the fields ride the round record; the history is as it was
        assert not set(FIELDS) & (set(ra) | set(rb))
        for k in ("loss", "rho", "primal_residual", "dual_residual"):
            assert ra[k] == rb[k]
        assert (ra["accuracy"] == rb["accuracy"]).all()
    for x, y in zip(leaves((sa.params, sa.batch_stats)),
                    leaves((sb.params, sb.batch_stats))):
        assert torch.equal(x, y)


def test_clock_offset_maps_round_stamps_to_time_ns(runs):
    t, _, _ = runs["fused"]
    mem = t.obs_recorder.memory
    (head,) = [r for r in mem if r["event"] == "run_header"]
    off = head["clock_offset_ns"]
    starts = [r["t_start"] * 1e9 + off for r in mem if r["event"] == "round"]
    assert head["time_unix"] * 1e9 - 1e6 <= starts[0] <= starts[1]
    assert starts[1] <= time.time_ns()


def test_profiler_ranges_nest_inside_the_round(tmp_path):
    run(profile_dir=str(tmp_path), Nadmm=1, **PATHS["fused"])
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    rounds = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "comm_round#0"]
    inner = [e for e in events if e["name"] in (
        "forward", "backward", "optimizer", "comm.mean", "evaluate")]
    assert len(rounds) == 1
    assert {e["name"] for e in inner} == {"forward", "backward", "optimizer",
                                          "comm.mean", "evaluate"}
    # one forward, backward and optimizer range a client-step
    steps = K * NEPOCH * 3
    assert sum(e["name"] == "forward" for e in inner) == steps
    (lo, hi), = rounds
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in inner)


# -- on the card ------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card test needs an NVIDIA card")
    return torch.device("cuda", 0)


def _let_through(wait):
    """``_host_wait`` with the sync debug mode off inside the site."""
    @contextlib.contextmanager
    def quiet(n=1):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with wait(n):
                yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return quiet


@pytest.mark.card
def test_steady_fused_round_syncs_only_at_counted_sites(card):
    """Cell ``resnet18.admm.stem``'s round: ResNet18, K=10, batch 128,
    1,280 images a client, the stem block, ADMM, device data, fused,
    evaluation on 1,000 test images; rounds 0 and 1 warm up, round 2 is
    watched."""
    cfg = FederatedConfig(**dict(
        BASE, device=str(card), K=10, Nepoch=1, Nadmm=3, default_batch=128,
        lr=1e-3, device_data=True, fused_rounds=True))
    t = BlockwiseFederatedTrainer(ResNet18(), cfg,
                                  images(10, 1280, 128, 1000),
                                  alg.AdmmConsensus())
    t.L = 1
    t._host_wait = _let_through(t._host_wait)
    marks = []

    def log(msg):
        if "round=1/" in msg:
            marks.append(len(seen))
            torch.cuda.set_sync_debug_mode("warn")
        elif "round=2/" in msg:
            torch.cuda.set_sync_debug_mode(0)
            marks.append(len(seen))

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            t.run(log=log)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}: {w.message}"
             for w in seen[marks[0]:marks[1]]
             if "synchroniz" in str(w.message)]
    assert syncs == [], syncs
    rec = [r for r in t.obs_recorder.memory if r["event"] == "round"][2]
    assert rec["host_syncs"] == SYNCS["fused"]
    assert 0 < rec["comm_device_seconds"] < rec["train_seconds"]
