"""The elastic federation of the port, against its own uninterrupted runs
and the JAX package's elastic runs.

ADMM on Net at K=8 (batch 8, 16 images a client, Nadmm 3, one block), the
JAX package's own elastic geometry (``tests/test_resume.py``
``TestElasticResume``), both sides from the JAX trainer's common init:

- a run killed after round 0 on a D-shard client mesh and resumed with
  ``elastic_resume`` on a D'-shard mesh (8 -> 8, 8 -> 4, 4 -> 8) ends bit
  for bit where the uninterrupted D run ends when D' == D, and within
  rtol 1e-4, atol 1e-6 in every history field and the final parameters
  when D' != D (the shards' summation order moves), as JAX's contract
  says; against JAX's elastic run at the same (D, D'): counts equal, loss
  at rtol 1e-4, residuals at rtol 1e-3, parameters at atol 5e-4 (the
  engine pair's tolerances);
- without the flag the resume fails with ``CheckpointGeometryError``
  naming ``--elastic-resume``; a K change is refused even with it;
- ``surviving_device_count`` equals JAX's on a grid of (devices, K);
- the supervised preemption of ``tests/test_control.py`` (``preempt=1``
  at D=8 under ``elastic_resume``): the trainers built are (1, 8) and
  (2, 4), the one ``reshape`` record equals JAX's in every field but the
  run id, and the port's ``control.replay`` exits 0 on the stream and 1
  with the record tampered or dropped (JAX's replay agrees); the readers
  of both packages count the reshape;
- the CPC trainer's elastic restore (D=2 -> 1 and 2 -> 2).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_cpc_pair import FILES2, SAPS2, SILENT, port_trainer as cpc_trainer
from _torch_engine_pair import max_param_diff, torch_threads
from _torch_tmp_cwd import tmp_cwd  # noqa: F401
from federated_pytorch_test_tpu.control.replay import main as jreplay
from federated_pytorch_test_tpu.control.supervisor import (
    supervise_classifier as jsupervise,
    surviving_device_count as jsurviving,
)
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.obs.report import read_records as jread
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.control.replay import main as treplay
from federated_pytorch_test_tpu_torch.control.supervisor import (
    supervise_classifier as tsupervise,
    surviving_device_count,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import common, federated_multi
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.obs.report import read_records
from federated_pytorch_test_tpu_torch.parallel.mesh import CollectiveTimeoutError
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
    ClientState,
)
from federated_pytorch_test_tpu_torch.train.faults import FaultSpec
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils.tree import leaves

DATA = dict(K=8, batch=8, limit_per_client=16, limit_test=8)
CASES = {"8to8": (8, 8), "8to4": (8, 4), "4to8": (4, 8)}
SOURCES = sorted({a for a, _ in CASES.values()})


class Killed(Exception):
    pass


def cfg_fields(d, **kw):
    return dict(K=8, Nloop=1, Nepoch=1, Nadmm=3, default_batch=8,
                check_results=False, admm_rho0=0.1, seed=5, num_devices=d,
                **kw)


def numeric(rec):
    """The history fields of the trajectory contract: numbers, not
    timings (JAX's ``strip``)."""
    return {k: v for k, v in rec.items()
            if isinstance(v, (int, float)) and not k.endswith("_seconds")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _jax_trainer(d, **kw):
    t = JTrainer(JNet(), JConfig(device_data=False, **cfg_fields(d, **kw)),
                 JData(**DATA), jalg.AdmmConsensus())
    t.L = 1
    return t


def _port_trainer(d, **kw):
    t = TTrainer(TNet(), TConfig(device="cpu", **cfg_fields(d, **kw)),
                 TData(**DATA), talg.AdmmConsensus())
    t.L = 1
    return t


def _port_killer(msg):
    """The port's kill after round 0's checkpoint: its round log line
    comes after the save."""
    if "round=0/" in msg:
        raise Killed


def _jax_killer(state, rec):
    if rec["nadmm"] == 0:
        raise Killed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX: the common init, each source D's killed run and each case's
    elastic resume.  The port: each source D's uninterrupted and killed
    run from the same init, and each case's elastic resume.  Every resume
    reads its own copy of the killed run's checkpoint."""
    root = tmp_path_factory.mktemp("elastic")
    jt0 = _jax_trainer(8)
    p0 = jax.tree.map(np.asarray, jt0.params0)
    b0 = jax.tree.map(np.asarray, jt0.batch_stats0)
    start = ClientState(*bridge.classifier_state_from_jax(p0, b0))
    out = {"jax": {}, "port": {}, "full": {}, "full_state": {}}
    for d in SOURCES:
        with pytest.raises(Killed):
            _jax_trainer(d).run(log=SILENT, on_round=_jax_killer,
                                checkpoint_path=str(root / f"j{d}"))
        with pytest.raises(Killed):
            _port_trainer(d).run(start, log=_port_killer,
                                 checkpoint_path=str(root / f"t{d}"))
        s, h = _port_trainer(d).run(start, log=SILENT)
        out["full"][d], out["full_state"][d] = h, s
    for name, (a, b) in CASES.items():
        jck, tck = str(root / f"j{name}"), str(root / f"t{name}")
        shutil.copytree(str(root / f"j{a}"), jck)
        shutil.copytree(str(root / f"t{a}"), tck)
        js, jh = _jax_trainer(b, elastic_resume=True).run(
            log=SILENT, checkpoint_path=jck, resume=True)
        lines = []
        ts, th = _port_trainer(b, elastic_resume=True).run(
            start, log=lines.append, checkpoint_path=tck, resume=True)
        assert any(m.startswith("resumed mid-run checkpoint") for m in lines)
        out["jax"][name] = (jax.tree.map(np.asarray, js.params), jh)
        out["port"][name] = (ts, th)
    out["root"] = root
    out["start"] = start
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_resume_holds_the_elastic_contract(runs, case):
    a, b = CASES[case]
    ts, th = runs["port"][case]
    full, fs = runs["full"][a], runs["full_state"][a]
    assert len(th) == len(full) == 3
    for x, y in zip(th, full):
        sx, sy = numeric(x), numeric(y)
        assert sx.keys() == sy.keys()
        for k in sx:
            if a == b:
                assert sx[k] == sy[k], k
            else:
                np.testing.assert_allclose(sx[k], sy[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    for u, v in zip(leaves(ts.params) + leaves(ts.batch_stats),
                    leaves(fs.params) + leaves(fs.batch_stats)):
        if a == b:
            assert torch.equal(u, v)
        else:
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_matches_jax_elastic_run(runs, case):
    jparams, jh = runs["jax"][case]
    ts, th = runs["port"][case]
    assert len(th) == len(jh) == 3
    for t, j in zip(th, jh):
        for k in ("nloop", "block", "nadmm", "N", "bytes_on_wire"):
            assert t[k] == j[k], k
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        for k in ("dual_residual", "primal_residual"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3)
    tparams, _ = bridge.classifier_state_to_jax(ts.params, ts.batch_stats)
    assert max_param_diff(tparams, jparams) <= 5e-4


def test_geometry_change_without_the_flag_raises(runs):
    ck = str(runs["root"] / "noflag")
    shutil.copytree(str(runs["root"] / "t8"), ck)
    with pytest.raises(ckpt.CheckpointGeometryError, match="elastic-resume"):
        _port_trainer(4).run(runs["start"], log=SILENT, checkpoint_path=ck,
                             resume=True)
    # the error is actionable: the same resume passes once opted in
    _, h = _port_trainer(4, elastic_resume=True).run(
        runs["start"], log=SILENT, checkpoint_path=ck, resume=True)
    assert len(h) == 3


def test_k_change_refused_even_with_the_flag(runs):
    _, meta = ckpt.load_checkpoint(ckpt.checkpoint_slots(
        str(runs["root"] / "t8"))[0])
    assert (meta["geom_devices"], meta["geom_K"]) == (8, 8)
    with pytest.raises(ckpt.CheckpointGeometryError, match="K=8 clients"):
        ckpt.validate_geometry(meta, devices=4, processes=1, K=4,
                               elastic=True)
    ckpt.validate_geometry(meta, devices=4, processes=1, K=8, elastic=True)
    with pytest.raises(ckpt.CheckpointGeometryError, match="elastic"):
        ckpt.validate_geometry(meta, devices=8, processes=2, K=8)
    ckpt.validate_geometry(meta, devices=8, processes=2, K=8, elastic=True)
    # a checkpoint without geometry keys passes unchecked
    ckpt.validate_geometry({}, devices=3, processes=2, K=5)


@pytest.mark.parametrize("K", [1, 2, 3, 4, 6, 8, 10, 12, 16])
def test_surviving_device_count_matches_jax(K):
    for devices in range(1, 17):
        got = surviving_device_count(devices, K)
        assert got == jsurviving(devices, K), (devices, K)
        assert got == devices or (got < devices and K % got == 0)


def test_surviving_device_count_anchors():
    assert surviving_device_count(8, 8) == 4
    assert surviving_device_count(5, 10) == 2
    assert surviving_device_count(1, 10) == 1
    assert surviving_device_count(2, 3) == 1


def test_drivers_take_the_flags():
    cfg, _ = common.parse_config(TConfig(), "x", [
        "--elastic-resume", "--sanitize", "--num-devices", "2"])
    assert cfg.elastic_resume and cfg.sanitize and cfg.num_devices == 2
    cfg, _ = common.parse_config(TConfig(), "x", [])
    assert not cfg.elastic_resume and not cfg.sanitize


# -- the supervised preemption -------------------------------------------

SUP = dict(K=8, Nloop=1, Nepoch=1, Nadmm=3, default_batch=16,
           check_results=False, admm_rho0=0.1, num_devices=8,
           fault_spec="preempt=1,seed=3", elastic_resume=True,
           max_restarts=2, restart_backoff=0.0, obs_sinks="jsonl,memory")
SUP_DATA = dict(K=8, batch=16, limit_per_client=32, limit_test=32)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    root = tmp_path_factory.mktemp("sup")
    out = {}
    for side in ("jax", "port"):
        built = []

        def build(c, attempt, side=side, built=built):
            if side == "jax":
                t = JTrainer(JNet(), c, JData(**SUP_DATA),
                             jalg.AdmmConsensus())
            else:
                t = TTrainer(TNet(), c, TData(**SUP_DATA),
                             talg.AdmmConsensus())
            t.L = 1
            t.obs_run_name = "elastic"
            built.append((attempt, c.num_devices))
            return t

        obs = str(root / side / "obs")
        if side == "jax":
            cfg = JConfig(device_data=False, obs_dir=obs, **SUP)
            sup = jsupervise
        else:
            cfg = TConfig(device="cpu", obs_dir=obs, **SUP)
            sup = tsupervise
        _, hist = sup(build, cfg, str(root / side / "ck"),
                      run_kwargs={"log": SILENT}, log=SILENT,
                      sleep=lambda s: None)
        out[side] = dict(built=built, hist=hist,
                         path=os.path.join(obs, "elastic.jsonl"))
    out["root"] = root
    return out


def _reshapes(path, reader):
    return [r for r in reader(path, validate=True)
            if r["event"] == "control" and r["intervention"] == "reshape"]


def test_supervised_preemption_reshapes_8_to_4(supervised):
    t = supervised["port"]
    assert len(t["hist"]) == 3
    assert t["built"] == [(1, 8), (2, 4)] == supervised["jax"]["built"]
    recs = read_records(t["path"], validate=True)
    headers = [r for r in recs if r["event"] == "run_header"]
    assert [h["mesh_shape"]["clients"] for h in headers] == [8, 4]


def test_reshape_record_equals_jax(supervised):
    (t,) = _reshapes(supervised["port"]["path"], read_records)
    (j,) = _reshapes(supervised["jax"]["path"], jread)
    assert (t["from_value"], t["to_value"]) == (8, 4)
    assert t["source"] == "supervisor" and t["scope"] == "restart"
    strip = lambda r: {k: v for k, v in r.items() if k != "run_id"}
    assert strip(t) == strip(j)


def test_replay_verifies_the_reshape(supervised, capsys):
    path = supervised["port"]["path"]
    assert treplay([path]) == 0 and jreplay([path]) == 0
    assert "1 reshape record(s)" in capsys.readouterr().out
    lines = open(path).read().splitlines()
    root = supervised["root"]
    tampered, dropped = str(root / "tampered.jsonl"), str(root / "dropped.jsonl")
    with open(tampered, "w") as f:
        for line in lines:
            rec = json.loads(line)
            if rec.get("intervention") == "reshape":
                rec["to_value"] = 2
            f.write(json.dumps(rec) + "\n")
    with open(dropped, "w") as f:
        for line in lines:
            if json.loads(line).get("intervention") != "reshape":
                f.write(line + "\n")
    assert treplay([tampered]) == 1 and jreplay([tampered]) == 1
    assert treplay([dropped]) == 1 and jreplay([dropped]) == 1


def test_readers_count_the_reshape(supervised):
    """``obs.report`` and ``obs.compare`` of either package read the
    port's reshape: one in the summary, a note in the comparison."""
    from federated_pytorch_test_tpu.obs.compare import (
        load_source as jload,
    )
    from federated_pytorch_test_tpu.obs.report import summarize as jsummarize
    from federated_pytorch_test_tpu_torch.obs.compare import load_source
    from federated_pytorch_test_tpu_torch.obs.report import summarize

    path = supervised["port"]["path"]
    assert summarize(read_records(path))["reshapes"] == 1
    assert jsummarize(jread(path))["reshapes"] == 1
    for load in (load_source, jload):
        assert any("1 mesh reshape(s)" in n for n in load(path)["notes"])


def test_campaign_preemption_reshapes_through_the_soak_harness(tmp_path):
    """A campaign's ``preempt_at`` under ``--elastic-resume`` takes the
    reshape rung too (``run_soak`` goes through ``supervise_classifier``):
    4 -> 2 at the preempted round, replayed clean by both packages."""
    log = []
    federated_multi.main([
        "--device", "cpu", "--K", "4", "--model", "net", "--Nloop", "1",
        "--Nadmm", "1", "--n-train", "40", "--n-test", "32",
        "--default-batch", "16", "--update-guard", "--num-devices", "4",
        "--elastic-resume", "--campaign-spec",
        "hours=4,round_minutes=60,drop=0.1,preempt_at=2,seed=3",
        "--campaign-accel", "3600", "--max-restarts", "1",
        "--restart-backoff", "1", "--no-save-model", "--checkpoint-dir",
        str(tmp_path)], log=log.append)
    assert any("CollectiveTimeoutError at round 2" in m for m in log)
    path = str(tmp_path / "obs" / "federated_multi.jsonl")
    records = read_records(path, validate=True)
    assert [r["mesh_shape"]["clients"] for r in records
            if r["event"] == "run_header"] == [4, 2]
    assert [(r["from_value"], r["to_value"]) for r in records
            if r["event"] == "control"
            and r["intervention"] == "reshape"] == [(4, 2)]
    assert treplay([path]) == 0 and jreplay([path]) == 0


# -- the CPC trainer's elastic restore ----------------------------------

CPC_BASE = "corrupt=0.5,clients=0,mode=scale,scale=9"


def _cpc_preempt_seed():
    """A fault seed whose preempt=0.5 draw fires first after round 0 of
    the one-rotation run (4 blocks of 2 rounds)."""
    for seed in range(100):
        sp = FaultSpec.parse(f"preempt=0.5,seed={seed}")
        fires = [bi * 2 + n for bi in range(4) for n in range(2)
                 if sp.round_preempt(0, bi, n)]
        if fires and fires[0] > 0:
            return seed
    raise AssertionError("no seed preempts after round 0")


@pytest.fixture(scope="module")
def cpc_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cpc")
    seed = _cpc_preempt_seed()
    spec, pre = f"{CPC_BASE},seed={seed}", f"{CPC_BASE},preempt=0.5,seed={seed}"

    def run(d, fault, ck=None, resume=False, **kw):
        t = cpc_trainer(FILES2, SAPS2, fault_spec=fault, num_devices=d, **kw)
        s, h = t.run(Nloop=1, Nadmm=2, log=SILENT, checkpoint_path=ck,
                     resume=resume, prefetch=False)
        return bridge.cpc_state_to_jax(s), h

    full = run(2, spec)
    with pytest.raises(CollectiveTimeoutError):
        run(2, pre, str(root / "ck"))
    out = {"full": full, "root": root, "run": run, "pre": pre}
    for d in (2, 1):
        ck = str(root / f"ck{d}")
        shutil.copytree(str(root / "ck"), ck)
        out[d] = run(d, pre, ck, resume=True, elastic_resume=True)
    return out


@pytest.mark.parametrize("d", [2, 1])
def test_cpc_elastic_restore(cpc_runs, d):
    (ws, wh), (gs, gh) = cpc_runs["full"], cpc_runs[d]
    assert len(gh) == len(wh) > 2
    for x, y in zip(gh, wh):
        sx, sy = numeric(x), numeric(y)
        assert sx.keys() == sy.keys()
        for k in sx:
            if d == 2:
                assert sx[k] == sy[k], k
            else:
                np.testing.assert_allclose(sx[k], sy[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    if d == 2:
        jax.tree.map(np.testing.assert_array_equal, gs, ws)
    else:
        jax.tree.map(lambda u, v: np.testing.assert_allclose(
            u, v, rtol=1e-4, atol=1e-6), gs, ws)


def test_cpc_geometry_change_without_the_flag_raises(cpc_runs):
    ck = str(cpc_runs["root"] / "noflag")
    shutil.copytree(str(cpc_runs["root"] / "ck"), ck)
    with pytest.raises(ckpt.CheckpointGeometryError, match="elastic-resume"):
        cpc_runs["run"](1, cpc_runs["pre"], ck, resume=True)
