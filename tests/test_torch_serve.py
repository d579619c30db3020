"""The port's serving plane (``serve/`` and its engine, recorder, control
and replay wiring) against the JAX package's.

- The schedule: over several specs and rounds 0-500 the pure fields of
  every ``serve`` record, the batch plans and the canonical spec string
  equal the JAX package's exactly; the grammar's rejections carry its
  messages.
- The units: ``consensus_weights`` on float leaves (rtol 1e-6, float32
  means summed in another order) and integer leaves (exactly); the three
  heads on a toy forward at rtol 1e-5; padding, slicing and the bounded
  set of shapes; the drift labels and the eval stream's scores; the
  micro-batcher's order, plan and queue bound; the double buffer under a
  thread hammer never tears.
- A toy serving run (K=4, Net, ADMM, 8 rounds, the JAX test's serve
  spec, act mode) against the JAX engine (``tests/_torch_engine_pair.py``):
  the serve records' pure fields and ``serve_accuracy`` equal, the
  ``serve_drift`` alert, the ``serve_swap`` control and the forced refresh
  fall on the same rounds, and both packages' replays accept the port's
  stream and refuse it once a ``weights_version`` is tampered with.
- Serving is a read: on and off train the same parameters bit for bit;
  with no sink, watchdog or controller the plane is never built.  After a
  kill and resume the swap sequence is the uninterrupted run's.
- What cannot be served: a VAE fails at its first serving dispatch in
  both packages (the JAX forward lacks the model's ``rng`` argument; the
  port raises a ValueError naming the noise), and the CPC trainer raises
  "no serving adapter" at its first serving tick.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpc_pair import FILES2, SAPS2
from _torch_cpc_pair import jax_trainer as cpc_jax_trainer
from _torch_cpc_pair import port_trainer as cpc_port_trainer
from _torch_engine_pair import DATA, K, run_both, torch_threads

from federated_pytorch_test_tpu import serve as jserve
from federated_pytorch_test_tpu.control.replay import replay as jreplay
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.models.vae import AutoEncoderCNN as JVAE
from federated_pytorch_test_tpu.obs.report import read_records
from federated_pytorch_test_tpu.obs.schema import validate_record
from federated_pytorch_test_tpu.train import FederatedConfig as JConfig
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train.vae_engine import VAETrainer as JVAETrainer
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.control.replay import replay as treplay
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.serve import (
    HEADS,
    SERVE_FIELDS,
    SERVE_TAG,
    BatchedPredictor,
    DoubleBuffer,
    EvalStream,
    MicroBatcher,
    ServeSchedule,
    bucket_for,
    consensus_weights,
    pad_to_bucket,
    version_for,
)
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
    ClientState,
)
from federated_pytorch_test_tpu_torch.train.vae_engine import VAETrainer
from federated_pytorch_test_tpu_torch.utils.tree import leaves

#: the JAX package's serve test spec: 8 rounds, a hot-swap every 2, a total
#: label shift from round 4
SPEC = ("qps=12,round_minutes=0.5,buckets=4+16+64,swap_every=2,drift_at=4,"
        "seed=3")
SPECS = [SPEC, "qps=16,round_minutes=0.5,diurnal=0.6,buckets=4+16+64,"
         "swap_every=2,drift_at=5,seed=7", "", "none", "qps=0.5,seed=11",
         "qps=8,round_minutes=0.5,buckets=8+32+128,swap_every=2,drift_at=6,"
         "seed=5", " qps = 100 , diurnal=1, buckets=1+2+3+500,swap_every=7"]
BAD = ["qps=0", "diurnal=2", "buckets=8+4", "buckets=4+4", "buckets=0+4",
       "buckets=", "swap_every=0", "nonsense", "drift_at=-2", "bogus=1",
       "round_minutes=0"]
#: the JAX test's serve_cfg on the engine pair's start: health window 2 and
#: streak 1 warm the EMA on the pre-drift rounds
SERVE_CFG = dict(Nloop=2, Nadmm=4, check_results=False, admm_rho0=0.1,
                 seed=5, serve_spec=SPEC, control="act", health_action="warn",
                 health_window=2, health_streak=1, health_tput_frac=0.75,
                 obs_sinks="memory")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _pure(rec):
    return {k: rec.get(k) for k in SERVE_FIELDS}


# ----------------------------------------------------------------------
# the schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_equals_jax(spec):
    t, j = ServeSchedule.parse(spec), jserve.ServeSchedule.parse(spec)
    if j is None:
        assert t is None
        return
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.spec_string() == j.spec_string()
    assert ServeSchedule.parse(t.spec_string()) == t
    assert (SERVE_TAG, SERVE_FIELDS) == (jserve.SERVE_TAG,
                                         jserve.SERVE_FIELDS)
    for r in range(501):
        assert t.record_fields(r) == j.record_fields(r)
        assert t.arrival(r) == j.arrival(r)
    assert t.expected_records(range(3, 90)) == j.expected_records(range(3, 90))
    for n in (0, 1, 3, 4, 5, 63, 64, 65, 130, 1000):
        assert t.batch_plan(n) == j.batch_plan(n)
        assert t.padding_waste_frac(n) == j.padding_waste_frac(n)


@pytest.mark.parametrize("spec", BAD)
def test_grammar_rejections_match_jax(spec):
    with pytest.raises(ValueError) as terr:
        ServeSchedule.parse(spec)
    with pytest.raises(ValueError) as jerr:
        jserve.ServeSchedule.parse(spec)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------------
# the units
# ----------------------------------------------------------------------
def test_consensus_weights_match_jax():
    rng = np.random.default_rng(0)
    tree = {"p": {"w": rng.standard_normal((4, 3, 5)).astype(np.float32),
                  "b": rng.standard_normal((4, 7)).astype(np.float32)},
            "n": np.asarray([2, 4, 7, 9], np.int32),
            "c": np.asarray([[1, 2], [3, 4], [5, 7], [0, 0]], np.int64)}
    want = jserve.consensus_weights(tree)
    got = consensus_weights({"p": {k: torch.from_numpy(v)
                                   for k, v in tree["p"].items()},
                             "n": torch.from_numpy(tree["n"]),
                             "c": torch.from_numpy(tree["c"])})
    for k in ("w", "b"):
        np.testing.assert_allclose(got["p"][k].numpy(),
                                   np.asarray(want["p"][k]), rtol=1e-6)
    for k in ("n", "c"):
        assert got[k].dtype == torch.from_numpy(tree[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # a read: the stacked tensors are untouched and not aliased
    w = torch.from_numpy(tree["p"]["w"].copy())
    z = consensus_weights({"w": w})
    z["w"].add_(1.0)
    np.testing.assert_array_equal(w.numpy(), tree["p"]["w"])


def _toy_forward(kind, lib):
    """A toy model of each head's shape over ``lib`` (numpy-like ops)."""
    W = np.random.default_rng(1).standard_normal((12, 5)).astype(np.float32)

    def fwd(weights, x):
        x2 = x.reshape(x.shape[0], -1)
        if kind == "classifier":
            return x2 @ lib(W) * weights
        if kind == "vae":
            return (x * weights + 0.25, x2[:, :2], x2[:, 2:4])
        return (x2.reshape(x.shape[0], 3, 4) * weights, None)
    return fwd


@pytest.mark.parametrize("kind", ["classifier", "vae", "cpc"])
def test_heads_match_jax(kind):
    x = np.random.default_rng(2).standard_normal((6, 3, 4)).astype(np.float32)
    want = jserve.infer.HEADS[kind](_toy_forward(kind, jnp.asarray))(
        np.float32(1.5), jnp.asarray(x))
    got = HEADS[kind](_toy_forward(kind, torch.from_numpy))(
        1.5, torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_padding_slicing_and_shapes_match_jax():
    buckets = (4, 16, 64)
    for n in (1, 3, 4, 5, 16, 17, 64, 999):
        assert bucket_for(n, buckets) == jserve.bucket_for(n, buckets)
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    for b in (5, 8, 16):
        np.testing.assert_array_equal(pad_to_bucket(x, b),
                                      jserve.pad_to_bucket(x, b))
    with pytest.raises(ValueError) as terr:
        pad_to_bucket(x, 4)
    with pytest.raises(ValueError) as jerr:
        jserve.pad_to_bucket(x, 4)
    assert str(terr.value) == str(jerr.value)
    calls = []

    def head(weights, xb):
        calls.append(tuple(xb.shape))
        return xb.sum(dim=1, keepdim=True) * weights

    tp = BatchedPredictor(head, buckets)
    jp = jserve.BatchedPredictor(
        lambda w, xb: np.asarray(xb).sum(axis=1, keepdims=True) * w,
        buckets, jit=False)
    for n in (1, 3, 4, 5, 17, 64):
        xb = np.arange(n * 6, dtype=np.float32).reshape(n, 6)
        np.testing.assert_array_equal(tp(2.0, xb), jp(np.float32(2.0), xb))
    assert tp.shapes_seen == jp.shapes_seen == {(4, 6), (16, 6), (64, 6)}
    assert tp.dispatches == jp.dispatches == 6
    assert calls == [(4, 6), (4, 6), (4, 6), (16, 6), (64, 6), (64, 6)]
    with pytest.raises(ValueError, match="exceeds max bucket"):
        tp(2.0, np.zeros((65, 6), np.float32))


def test_drift_labels_and_scores_match_jax():
    t, j = (EvalStream(ServeSchedule.parse(SPEC), window=3),
            jserve.EvalStream(jserve.ServeSchedule.parse(SPEC), window=3))
    rng = np.random.default_rng(4)
    for r in range(9):
        labels = rng.integers(10, size=40)
        np.testing.assert_array_equal(t.drift_labels(labels, r, 10),
                                      j.drift_labels(labels, r, 10))
        logits = rng.standard_normal((40, 10)).astype(np.float32)
        logits[np.arange(40), labels] += 2.0
        assert t.score(r, logits, labels) == j.score(r, logits, labels)
    assert t.observe(9, 0.0) == j.observe(9, 0.0)


def test_microbatcher_order_plan_and_bound_match_jax():
    sched = ServeSchedule.parse(SPEC)
    jsched = jserve.ServeSchedule.parse(SPEC)
    tcalls, jcalls = [], []

    def dispatch(calls):
        def fn(batch):
            calls.append(batch.shape[0])
            return batch * 2.0
        return fn

    tm = MicroBatcher(sched, dispatch(tcalls), max_queue=256)
    jm = jserve.MicroBatcher(jsched, dispatch(jcalls), max_queue=256)
    reqs = [np.full((3,), i, np.float32) for i in range(150)]
    for x in reqs:
        tm.submit(x)
        jm.submit(x)
    touts, ttel = tm.drain()
    jouts, jtel = jm.drain()
    assert tcalls == jcalls == [64, 64, 64]
    assert len(touts) == 150 and len(tm) == 0
    for a, b, x in zip(touts, jouts, reqs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, x * 2.0)
    pure = ("requests", "batches", "padded_slots", "padding_waste_frac")
    assert {k: ttel[k] for k in pure} == {k: jtel[k] for k in pure}
    tiny = MicroBatcher(sched, dispatch([]), max_queue=2)
    tiny.submit(reqs[0])
    tiny.submit(reqs[1])
    with pytest.raises(OverflowError, match="serve queue full"):
        tiny.submit(reqs[2])


def test_double_buffer_never_tears():
    buf = DoubleBuffer()
    assert buf.version == -1
    with pytest.raises(RuntimeError):
        buf.acquire()
    # host tensors: nothing to wait for
    assert buf.publish(1, {"w": torch.ones(3)}, block=True) >= 0.0
    assert buf.version == 1 and buf.swaps == 1
    assert [version_for(r, 2) for r in range(6)] == \
        [jserve.version_for(r, 2) for r in range(6)] == [1, 1, 2, 2, 3, 3]
    stop = threading.Event()
    errors = []

    def writer():
        v = 2
        while not stop.is_set():
            buf.publish(v, {"w": torch.full((3,), float(v))})
            v += 1

    def reader():
        for _ in range(20000):
            version, weights = buf.acquire()
            if not bool((weights["w"] == float(version)).all()):
                errors.append(version)
                return

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader) for _ in range(4)]
    w.start()
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    stop.set()
    w.join()
    assert not errors, errors
    assert buf.swaps > 1


# ----------------------------------------------------------------------
# a toy serving run against the JAX engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return run_both(JNet, Net, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                    SERVE_CFG, blocks=1)


def _events(recs, event, **match):
    return [r for r in recs if r.get("event") == event
            and all(r.get(k) == v for k, v in match.items())]


def test_serve_records_equal_jax(pair):
    trecs = pair["tt"].obs_recorder.memory
    jrecs = pair["jt"].obs_recorder.memory
    tserve, jserve_ = _events(trecs, "serve"), _events(jrecs, "serve")
    assert len(tserve) == len(jserve_) == len(pair["thist"]) == 8
    sched = ServeSchedule.parse(SPEC)
    for t, j, (r, fields) in zip(tserve, jserve_,
                                 sched.expected_records(range(8))):
        assert _pure(t) == _pure(j) == fields
        assert t["serve_accuracy"] == j["serve_accuracy"]
        assert ("swap_gap_seconds" in t) == ("swap_gap_seconds" in j)
        assert t["serve_p99_ms"] >= t["serve_p50_ms"] > 0
    # the served accuracy clears chance before the drift
    assert min(t["serve_accuracy"] for t in tserve[:4]) > 0.1
    for rec in tserve + _events(trecs, "campaign"):
        validate_record(rec)


def test_drift_alert_control_and_refresh_fall_as_in_jax(pair):
    trecs = pair["tt"].obs_recorder.memory
    jrecs = pair["jt"].obs_recorder.memory

    def chain(recs):
        return ([a["round_index"] for a in
                 _events(recs, "alert", rule="serve_drift")],
                [(c["round_index"], c["intervention"]) for c in
                 _events(recs, "control", param="serve_swap")],
                [s["round_index"] for s in _events(recs, "serve")
                 if s.get("forced_refresh")])

    alerts, controls, forced = chain(trecs)
    assert (alerts, controls, forced) == chain(jrecs)
    assert alerts and min(alerts) >= 4
    assert controls[0][1] == "refresh_serving"
    assert forced[0] == controls[0][0] + 1
    # a forced refresh republishes without bumping the version
    s = _events(trecs, "serve", round_index=forced[0])[0]
    assert s["weights_version"] == ServeSchedule.parse(SPEC).weights_version(
        forced[0])


@pytest.mark.parametrize("replay", [jreplay, treplay],
                         ids=["jax_replay", "port_replay"])
def test_replays_accept_the_port_stream(pair, replay):
    recs = pair["tt"].obs_recorder.memory
    errors, stats = replay(recs)
    assert not errors, errors
    assert stats["serve_records"] == 8 and stats["policy_records"] >= 1
    tampered = [dict(r, weights_version=r["weights_version"] + 1)
                if r.get("event") == "serve" and r["round_index"] == 5
                else r for r in recs]
    errors2, _ = replay(tampered)
    assert errors2 and "diverges" in errors2[0]


# ----------------------------------------------------------------------
# serving is a read; kill and resume
# ----------------------------------------------------------------------
def _port(cfg: dict, start=None, **kw):
    t = BlockwiseFederatedTrainer(
        Net(), FederatedConfig(device="cpu", K=K, Nepoch=1, default_batch=16,
                               biased_input=True, **dict(cfg, **kw)),
        FederatedCifar10(**DATA), talg.AdmmConsensus())
    t.L = 1
    return t


def test_serving_never_perturbs_training(pair):
    start = ClientState(*bridge.classifier_state_from_jax(pair["p0"],
                                                          pair["b0"]))
    off = _port(SERVE_CFG, serve_spec="none")
    s_off, h_off = off.run(start, log=lambda m: None)
    assert off._serve_sched is None and off._serve_plane is None
    assert not _events(off.obs_recorder.memory, "serve")
    for a, b in zip(leaves(pair["tstate"].params), leaves(s_off.params)):
        assert a.equal(b)
    for a, b in zip(leaves(pair["tstate"].batch_stats),
                    leaves(s_off.batch_stats)):
        assert a.equal(b)
    assert [r["loss"] for r in pair["thist"]] == [r["loss"] for r in h_off]


def test_serving_without_obs_does_nothing():
    t = _port(dict(SERVE_CFG, Nloop=1, Nadmm=2), obs_sinks="none",
              control="off", health_action="off")
    t.run(log=lambda m: None)
    assert t._serve_sched is not None and t._serve_plane is None


class Killed(Exception):
    pass


def test_swap_sequence_survives_kill_and_resume(pair, tmp_path):
    cfg = dict(SERVE_CFG, obs_sinks="jsonl", obs_dir=str(tmp_path))
    ck = str(tmp_path / "ck")
    t1 = _port(cfg)
    t1.obs_run_name = "seg"
    emit = t1._emit_round_obs

    def bomb(obs, rec, **kw):
        emit(obs, rec, **kw)
        if kw["round_index"] == 4:        # dies after round 4
            raise Killed

    t1._emit_round_obs = bomb
    with pytest.raises(Killed):
        t1.run(log=lambda m: None, checkpoint_path=ck)
    t2 = _port(cfg)
    t2.obs_run_name = "seg"
    t2.run(log=lambda m: None, checkpoint_path=ck, resume=True)
    recs = read_records(str(tmp_path / "seg.jsonl"), validate=True)
    for replay in (jreplay, treplay):
        errors, stats = replay(recs)
        assert not errors, errors
        assert stats["segments"] == 2 and stats["serve_records"] == 8
    want = {r["round_index"]: _pure(r) for r in
            _events(pair["tt"].obs_recorder.memory, "serve")}
    got = _events(recs, "serve")
    assert [r["round_index"] for r in got] == list(range(8))
    for rec in got:
        assert _pure(rec) == want[rec["round_index"]]
    # the resumed segment republishes its round's version on its first tick
    assert "swap_gap_seconds" in got[5]


# ----------------------------------------------------------------------
# what cannot be served
# ----------------------------------------------------------------------
def test_vae_fails_at_its_first_serving_dispatch_in_both():
    vae_cfg = dict(K=2, Nloop=1, Nadmm=1, default_batch=16,
                   check_results=False, serve_spec=SPEC)
    vdata = dict(K=2, batch=16, limit_per_client=16, limit_test=16)
    jt = JVAETrainer(JVAE(), JConfig(device_data=False, **vae_cfg),
                     JData(**vdata), jalg.FedAvg())
    with pytest.raises(TypeError, match="rng"):
        jt._serve_tick(None, 0, jt.init_state())
    assert jt._serve_plane["buffer"].version == 1
    tt = VAETrainer(AutoEncoderCNN(), FederatedConfig(device="cpu", **vae_cfg),
                    FederatedCifar10(**vdata), talg.FedAvg())
    with pytest.raises(ValueError, match="reparametrisation noise"):
        tt._serve_tick(None, 0, tt.init_state())
    assert tt._serve_plane["buffer"].version == 1


def test_cpc_has_no_serving_adapter_in_both():
    jt = cpc_jax_trainer(FILES2, SAPS2, serve_spec=SPEC)
    with pytest.raises(ValueError, match="no serving adapter") as jerr:
        jt._serve_tick(None, 0, jt.state0)
    tt = cpc_port_trainer(FILES2, SAPS2, serve_spec=SPEC, obs_sinks="memory")
    with pytest.raises(ValueError, match="no serving adapter") as terr:
        tt.run(Nloop=1, Nadmm=1, log=lambda m: None, prefetch=False)
    assert str(terr.value) == str(jerr.value)
    # it fell at the first round's serving tick, behind its round record
    mem = tt.obs_recorder.memory
    assert [r["round_index"] for r in _events(mem, "round")] == [0]
    assert not _events(mem, "serve")
    assert _events(mem, "summary")[0]["status"] == "aborted"
