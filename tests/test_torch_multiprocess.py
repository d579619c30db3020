"""Two processes running one federation: the port's counterpart of
``tests/test_multiprocess.py``, with gloo ranks on the CPU.

Each rank holds K/P clients (``local_client_rows``: rank p of two owns
rows 2p and 2p+1 at K = 4, D = 4) and stages only those rows of the
seeded data; every host read of a client-stacked value is gathered whole,
so both ranks write the same records.  Held bit for bit against the
port's one-process run at the same D: a FedAvg round on Net (K = 4, D = 4,
two blocks), a VAE round and a CPC rotation (D = 2).  The FedAvg run is
held against the JAX engine's ``client_mesh(4)`` run from the same weights
within the tolerances of ``test_torch_engine_algorithms.py`` (loss rtol
1e-4, dual residual 1e-3, final parameters atol 5e-4).  Checkpoints: a
two-rank run (ADMM, q8 fused collective, D = 2) killed after its first
round, at a block boundary (Nadmm 1) and mid-block (Nadmm 2), resumes on
two ranks bit for bit the uninterrupted run; the mid-block checkpoint
resumes in one process under ``elastic_resume`` bit for bit (the same D),
and without it raises ``CheckpointGeometryError`` naming the process
count.  Each rank pins one torch thread.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from _torch_engine_pair import (
    BASE,
    DATA,
    max_param_diff,
    run_both,
    torch_threads,
)
from _torch_ranks import Ranks, run_local
from _torch_tmp_cwd import tmp_cwd  # noqa: F401

from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils.tree import tree_map

FEDAVG = dict(Nadmm=1, num_devices=4, check_results=True)
CKPT = dict(num_devices=2, compress="q8", fused_collective=True)
VAE = ["--device", "cpu", "--Nloop", "1", "--Nadmm", "1", "--n-train", "40",
       "--n-test", "32", "--default-batch", "16", "--K", "4",
       "--num-devices", "2", "--obs-sinks", "none", "--no-save-model"]
CPC = ["--device", "cpu", "--Lc", "8", "--Rc", "4", "--batch-size", "2",
       "--Niter", "1", "--file-list", "a.h5", "b.h5", "c.h5", "d.h5",
       "--sap-list", "0", "1", "0", "1", "--num-devices", "2",
       "--obs-sinks", "none", "--no-save-model"]


def _engine(nadmm, ck=None, **kw):
    return dict(cfg=dict(BASE, Nadmm=nadmm, **CKPT, **kw.pop("cfg", {})),
                data=DATA, algo="AdmmConsensus", blocks=2, checkpoint=ck,
                **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One rank pair runs every case; its FedAvg run waits for the JAX
    common init, which the JAX run of this process writes meanwhile."""
    tmp = tmp_path_factory.mktemp("world")
    start = str(tmp / "p0.pkl")
    ck = {name: str(tmp / name) for name in ("edge", "mid")}
    mid = lambda tag: str(tmp / f"mid_{tag}")
    ranks = Ranks(tmp, "bundle", timeout=150, calls=[
        ["rows", dict(K=4, D=4)],
        ["engine", _engine(1, ck["edge"] + "/midrun", kill_at="round=0/")],
        ["engine", _engine(2, ck["mid"] + "/midrun", kill_at="round=0/")],
        # the mid-block checkpoint, copied for the one-process resumes
        ["copy", dict(src=ck["mid"], dst=mid("elastic"))],
        ["copy", dict(src=ck["mid"], dst=mid("strict"))],
        ["engine", _engine(1, ck["edge"] + "/midrun", resume=True)],
        ["engine", _engine(2, ck["mid"] + "/midrun", resume=True)],
        ["vae", dict(argv=VAE)],
        ["driver", dict(module="federated_cpc", argv=CPC)],
        ["engine", dict(cfg=dict(BASE, **FEDAVG), data=DATA, algo="FedAvg",
                        blocks=2, start=start)],
    ])
    try:
        with torch_threads(1):
            pair = run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(), FEDAVG)
        with open(start + ".tmp", "wb") as f:
            pickle.dump((pair["p0"], pair["b0"]), f)
        os.replace(start + ".tmp", start)
    finally:
        res = ranks.wait()
    return dict(tmp=tmp, pair=pair, res=res)


def _same_run(a, b):
    """Every number of every record, and every parameter, bit for bit."""
    assert len(a["hist"]) == len(b["hist"])
    for x, y in zip(a["hist"], b["hist"]):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
    _same_tree(a["params"], b["params"])


def _numpy(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_local_client_rows_and_the_fetch_round_trip(world):
    full = np.arange(12, dtype=np.float32).reshape(4, 3)
    for p, ranks in enumerate(world["res"]):
        got = ranks[0]
        assert got["rows"] == [2 * p, 2 * p + 1]
        np.testing.assert_array_equal(got["staged"], full[2 * p:2 * p + 2])
        np.testing.assert_array_equal(got["fetched"], full)


def test_fedavg_round_matches_one_process(world):
    """Both ranks write the same records and end with the same clients as
    the one-process port at D = 4 from the same weights."""
    pair = world["pair"]
    want = {"hist": [{k: v for k, v in r.items()
                      if not k.endswith("_seconds")
                      and k != "kernel_launches"} for r in pair["thist"]],
            "params": {"params": _numpy(pair["tstate"].params),
                       "batch_stats": _numpy(pair["tstate"].batch_stats)}}
    r0, r1 = (r[9] for r in world["res"])
    _same_run(r0, r1)
    _same_run(r0, want)


def test_fedavg_round_matches_jax_client_mesh(world):
    pair = world["pair"]
    r0 = world["res"][0][9]
    assert len(r0["hist"]) == len(pair["jhist"]) == 2
    for t, j in zip(r0["hist"], pair["jhist"]):
        assert (t["block"], t["N"], t["bytes_on_wire"]) == \
            (j["block"], j["N"], j["bytes_on_wire"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["dual_residual"], j["dual_residual"],
                                   rtol=1e-3)
        np.testing.assert_allclose(t["accuracy"], j["accuracy"], rtol=0,
                                   atol=100.0 / 32 + 1e-9)
    to_t = lambda t: tree_map(torch.from_numpy, t)
    tparams, _ = bridge.classifier_state_to_jax(
        to_t(r0["params"]["params"]), to_t(r0["params"]["batch_stats"]))
    assert max_param_diff(tparams, pair["jparams"]) <= 5e-4


@pytest.mark.parametrize("nadmm,name", [(1, "edge"), (2, "mid")])
def test_two_rank_checkpoint_resumes_on_two_ranks(world, nadmm, name):
    i = {"edge": 0, "mid": 1}[name]
    killed = [r[1 + i] for r in world["res"]]
    assert all(k["killed"] for k in killed)
    want = run_local("engine", **_engine(nadmm))
    for r in world["res"]:
        got = r[5 + i]
        assert any("resumed mid-run checkpoint" in m for m in got["lines"])
        _same_run(got, want)


def test_two_rank_checkpoint_resumes_in_one_process_when_elastic(world):
    tmp = world["tmp"]
    want = run_local("engine", **_engine(2))
    got = run_local("engine", **_engine(
        2, str(tmp / "mid_elastic" / "midrun"), resume=True,
        cfg=dict(elastic_resume=True)))
    assert any("resumed mid-run checkpoint" in m for m in got["lines"])
    _same_run(got, want)
    _, meta = ckpt.load_checkpoint(str(tmp / "mid_strict" / "midrun"))
    assert (meta["geom_processes"], meta["geom_devices"]) == (2, 2)
    with pytest.raises(ckpt.CheckpointGeometryError,
                       match="2-process job but this run has 1 processes"):
        run_local("engine", **_engine(
            2, str(tmp / "mid_strict" / "midrun"), resume=True))


@pytest.mark.parametrize("which", ["vae", "cpc"])
def test_vae_and_cpc_rounds_match_one_process(world, which):
    i = {"vae": 7, "cpc": 8}[which]
    want = (run_local("vae", argv=VAE) if which == "vae" else
            run_local("driver", module="federated_cpc", argv=CPC))
    for r in world["res"]:
        _same_run(r[i], want)
    if which == "cpc":
        assert (world["res"][0][i]["processes"],
                world["res"][0][i]["D"]) == (2, 2)
