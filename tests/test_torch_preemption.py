"""The bounded collectives and the process-group contract of the port.

The JAX package's ``TestBoundedWait`` cases, one parametrised test over
the port's ``parallel/mesh.py``: a bound of 0 is the literal call (no
thread, the return value and the error pass straight through), a hung
call raises ``CollectiveTimeoutError`` naming its site and counts it, an
error of the call itself is re-raised, a call inside its bound returns,
the bound follows ``configure_barrier_timeout`` and
``FEDTPU_BARRIER_TIMEOUT``, and a completed call stamps the heartbeat.
``initialize_multihost`` touches nothing unless ``FEDTPU_DISTRIBUTED=1``,
and refuses a partial set of the three ``FEDTPU_*`` variables.  Two gloo
ranks where rank 1 exits after the warm-up barrier: rank 0's
``sync_global("dead-peer")`` under an 8 s bound raises
``CollectiveTimeoutError`` naming ``dead-peer`` in under 30 s.  The same
in an engine run (q8 fused collective at D = 2 under
``barrier_timeout``): rank 1 leaves once round 0's checkpoint is durable,
rank 0 raises the typed error at round 1's fence with ``round_index`` 1
(and logs the JAX warning that the async writer stays off with several
processes), and a one-process ``elastic_resume`` from that checkpoint
ends bit for bit where the uninterrupted run does.
"""

import threading
import time

import numpy as np
import pytest
from _torch_engine_pair import BASE, DATA
from _torch_ranks import run_local, run_ranks

from federated_pytorch_test_tpu_torch.parallel import mesh
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    CollectiveTimeoutError,
    barrier_timeout,
    bounded_wait,
    collective_timeout_count,
    configure_barrier_timeout,
    heartbeat,
    initialize_multihost,
    last_heartbeat_age,
    process_count,
    sync_global,
)


def _zero_timeout_is_the_literal_call():
    calls, threads = [], []
    real = threading.Thread.start
    try:
        threading.Thread.start = lambda self: (threads.append(self),
                                               real(self))
        assert bounded_wait(lambda: calls.append(1) or 7, name="t",
                            timeout=0) == 7
    finally:
        threading.Thread.start = real
    assert calls == [1] and threads == []
    with pytest.raises(KeyError):
        bounded_wait(lambda: {}["missing"], name="t", timeout=0)


def _hung_callable_raises_typed_error():
    before = collective_timeout_count()
    with pytest.raises(CollectiveTimeoutError, match="sync:stuck"):
        bounded_wait(lambda: time.sleep(30), name="sync:stuck", timeout=0.1)
    assert collective_timeout_count() == before + 1


def _peer_error_re_raised_not_swallowed():
    def dead():
        raise RuntimeError("peer went away")

    with pytest.raises(RuntimeError, match="peer went away"):
        bounded_wait(dead, name="t", timeout=5.0)


def _result_returned_within_bound():
    assert bounded_wait(lambda: 42, name="t", timeout=5.0) == 42


def _configure_and_env_plumbing(monkeypatch):
    prev = configure_barrier_timeout(3.5)
    try:
        assert barrier_timeout() == 3.5
    finally:
        configure_barrier_timeout(prev)
    monkeypatch.setenv("FEDTPU_BARRIER_TIMEOUT", "2.5")
    assert mesh._env_barrier_timeout() == 2.5
    monkeypatch.setenv("FEDTPU_BARRIER_TIMEOUT", "junk")
    assert mesh._env_barrier_timeout() == 0.0


def _heartbeat_age_tracks_progress():
    heartbeat("unit")
    age = last_heartbeat_age()
    assert age is not None and age >= 0.0
    bounded_wait(lambda: None, name="site", timeout=0)
    assert mesh._HEARTBEAT["name"] == "site"


BOUNDED_WAIT = {
    "zero_timeout_is_the_literal_call": _zero_timeout_is_the_literal_call,
    "hung_callable_raises_typed_error": _hung_callable_raises_typed_error,
    "peer_error_re_raised_not_swallowed": _peer_error_re_raised_not_swallowed,
    "result_returned_within_bound": _result_returned_within_bound,
    "configure_and_env_plumbing": _configure_and_env_plumbing,
    "heartbeat_age_tracks_progress": _heartbeat_age_tracks_progress,
}


@pytest.mark.parametrize("case", list(BOUNDED_WAIT))
def test_bounded_wait(case, monkeypatch):
    fn = BOUNDED_WAIT[case]
    if case == "configure_and_env_plumbing":
        fn(monkeypatch)
    else:
        fn()


def test_one_process_is_untouched(monkeypatch):
    """Without the opt-in nothing joins a group: one process, and the
    barrier is a no-op."""
    monkeypatch.delenv("FEDTPU_DISTRIBUTED", raising=False)
    assert initialize_multihost("cpu") is False
    assert process_count() == 1
    sync_global("alone", timeout=0.01)


@pytest.mark.parametrize("present", [
    ("FEDTPU_COORDINATOR",),
    ("FEDTPU_NUM_PROCESSES", "FEDTPU_PROCESS_ID"),
    ("FEDTPU_COORDINATOR", "FEDTPU_PROCESS_ID"),
])
def test_partial_coordinator_env_is_refused(monkeypatch, present):
    monkeypatch.setenv("FEDTPU_DISTRIBUTED", "1")
    for v in ("FEDTPU_COORDINATOR", "FEDTPU_NUM_PROCESSES",
              "FEDTPU_PROCESS_ID"):
        if v in present:
            monkeypatch.setenv(v, "file:///nowhere" if "COORD" in v else "0")
        else:
            monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="FEDTPU_COORDINATOR, "
                       "FEDTPU_NUM_PROCESSES and FEDTPU_PROCESS_ID must be "
                       "set together"):
        initialize_multihost("cpu")
    assert process_count() == 1


def test_a_lost_peer_fails_the_survivors_barrier(tmp_path):
    r0, r1 = run_ranks(tmp_path, "dead_peer", timeout=60, bound=8.0)
    assert r1 is None                      # rank 1 left without a result
    assert r0["error"] is not None
    assert "'sync:dead-peer'" in r0["error"]
    assert r0["seconds"] < 30.0
    assert r0["count"] >= 1


def test_a_lost_peer_fails_the_survivors_round(tmp_path):
    cfg = dict(BASE, Nadmm=2, num_devices=2, compress="q8",
               fused_collective=True)
    ck = str(tmp_path / "midrun")
    r0, r1 = run_ranks(
        tmp_path, "lost_in_round", timeout=90, data=DATA, algo="FedAvg",
        blocks=1, checkpoint=ck,
        cfg=dict(cfg, barrier_timeout=8.0, async_checkpoint=True))
    assert r1 is None
    assert "'sync:round'" in r0["error"] and r0["round_index"] == 1
    assert r0["seconds"] < 8.0 + 20.0 and r0["count"] >= 1
    assert "WARNING: async_checkpoint is single-process only; multi-host " \
        "runs keep the synchronous save" in r0["lines"]
    want = run_local("engine", cfg=cfg, data=DATA, algo="FedAvg", blocks=1)
    got = run_local("engine", cfg=dict(cfg, elastic_resume=True), data=DATA,
                    algo="FedAvg", blocks=1, checkpoint=ck, resume=True)
    assert any("resumed mid-run checkpoint" in m for m in got["lines"])
    assert len(got["hist"]) == len(want["hist"]) == 2
    for x, y in zip(got["hist"], want["hist"]):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
