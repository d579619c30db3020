"""The port's record stream (``obs/``) against the JAX package's.

- Every record the port writes, for a classifier run, a CPC run, a VAE
  driver run and the no-consensus baseline, passes the JAX package's
  ``obs.schema.validate_record``, and its ``obs.report.read_records``
  reads each stream.
- For one classifier configuration (FedAvg, K=4, Net, partial
  participation, drops, x100 corruption and the guard) and one CPC
  configuration (krum over 2 shards, the same attack), the sequence of
  ``(event, round_index)`` of the run header, round, client, alert and
  summary records and the count fields of the round and client records
  equal the JAX stream's; the client record's losses agree at rtol 1e-4
  and its norms (of update differences, like the residuals) at rtol 1e-3.
- Obs on (the ``jsonl,memory`` sinks) against obs off: parameters and
  histories (``*_seconds`` stripped) bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch
from _torch_cpc_pair import FILES4, SAPS4, SILENT, port_trainer
from _torch_cpc_pair import run_both as run_cpc_both
from _torch_engine_pair import run_both, torch_threads
from _torch_tmp_cwd import tmp_cwd  # noqa: F401

from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.obs.report import read_records
from federated_pytorch_test_tpu.obs.schema import validate_record
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.drivers import (
    federated_vae,
    no_consensus_multi,
)
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg

KINDS = ("run_header", "round", "client", "alert", "summary")
ROUND_COUNTS = ("nloop", "block", "nadmm", "N", "bytes_on_wire",
                "bytes_dense", "images", "n_active", "guard_trips", "n_ok",
                "quarantined", "fault_dropped", "fault_straggled",
                "fault_corrupted", "model")
CLIENT_EXACT = ("clients", "active", "weight", "guard_ok", "quarantine",
                "dropped", "straggled", "corrupted", "staleness", "admitted",
                "members", "payload_bytes")
#: the client record's float fields and their rtol: the losses as the
#: round losses, the norms of differences as the residuals
CLIENT_CLOSE = {"update_norm": 1e-3, "dist_z": 1e-3, "loss_client": 1e-4}
ATTACK = dict(participation=0.5, update_guard=True,
              fault_spec="drop=0.2,corrupt=0.3,mode=scale,scale=100,seed=1")
CPC_ATTACK = dict(participation=0.75, update_guard=True, robust_agg="krum",
                  trim_frac=0.25, robust_chunked=True, num_devices=2,
                  fault_spec="corrupt=0.25,mode=scale,scale=100,seed=3")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _stream(d):
    files = [f for f in os.listdir(d) if f.endswith(".jsonl")]
    assert len(files) == 1
    return read_records(os.path.join(d, files[0]), validate=True)


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_classifier")
    out = run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(),
                   dict(Nadmm=2, check_results=False,
                        obs_dir=str(d / "jax"), obs_sinks="jsonl,memory",
                        **ATTACK),
                   port_cfg=dict(obs_dir=str(d / "port")))
    out.update(jrecs=_stream(d / "jax"), trecs=_stream(d / "port"))
    return out


@pytest.fixture(scope="module")
def cpc(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_cpc")
    out = run_cpc_both(FILES4, SAPS4, 2, **CPC_ATTACK,
                       jrun=dict(obs_dir=str(d / "jax"),
                                 obs_sinks="jsonl,memory"))
    return dict(out, jrecs=_stream(d / "jax"), trecs=_stream(d / "jax_port"))


def _seq(recs):
    return [(r["event"], r.get("round_index")) for r in recs
            if r["event"] in KINDS]


@pytest.mark.parametrize("run", ["classifier", "cpc"])
def test_stream_sequence_and_counts_equal_jax(run, request):
    out = request.getfixturevalue(run)
    j, t = out["jrecs"], out["trecs"]
    assert _seq(t) == _seq(j)
    jr = [r for r in j if r["event"] == "round"]
    tr = [r for r in t if r["event"] == "round"]
    assert len(tr) == len(out["thist"]) > 0
    for a, b in zip(tr, jr):
        assert {k: a.get(k) for k in ROUND_COUNTS} == \
            {k: b.get(k) for k in ROUND_COUNTS}
    jc = [r for r in j if r["event"] == "client"]
    tc = [r for r in t if r["event"] == "client"]
    assert len(tc) == len(tr)
    for a, b in zip(tc, jc):
        assert {k: a.get(k) for k in CLIENT_EXACT} == \
            {k: b.get(k) for k in CLIENT_EXACT}
        for k, rtol in CLIENT_CLOSE.items():
            assert (k in a) == (k in b), k
            if k not in b:
                continue
            np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                       np.asarray(b[k], np.float64),
                                       rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("run", ["classifier", "cpc"])
def test_every_port_record_passes_the_jax_schema(run, request):
    recs = request.getfixturevalue(run)["trecs"]
    for r in recs:
        validate_record(json.loads(json.dumps(r)))
    head = recs[0]
    assert head["event"] == "run_header" and head["platform"] == "cpu"
    assert head["devices"] == 1 and "torch_version" in head
    assert recs[-1]["event"] == "summary"
    assert recs[-1]["status"] == "completed"


@pytest.mark.parametrize("name", ["federated_vae", "no_consensus_multi"])
def test_driver_streams_read_back(name, tmp_cwd):
    argv = ["--device", "cpu", "--n-train", "40", "--n-test", "32",
            "--default-batch", "16", "--K", "2"]
    if name == "federated_vae":
        federated_vae.main([*argv, "--Nloop", "1", "--Nadmm", "1"],
                           log=SILENT)
        want_rounds = 12
    else:
        no_consensus_multi.main([*argv, "--model", "net", "--Nepoch", "2"],
                                log=SILENT)
        want_rounds = 2
    recs = read_records(str(tmp_cwd / "checkpoints" / "obs"
                            / f"{name}.jsonl"), validate=True)
    rounds = [r for r in recs if r["event"] == "round"]
    assert [r["round_index"] for r in rounds] == list(range(want_rounds))
    assert recs[0]["run_name"] == name
    assert recs[0]["engine"] == ("vae" if name == "federated_vae"
                                 else "classifier")


def _strip(h):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in r.items() if not k.endswith("_seconds")}
            for r in h]


def test_obs_on_and_off_are_bit_identical(tmp_path):
    from _torch_engine_pair import BASE, DATA
    from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
    from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
    from federated_pytorch_test_tpu_torch.train.engine import (
        BlockwiseFederatedTrainer,
    )

    outs = []
    for sinks in ("jsonl,memory", "none"):
        cfg = FederatedConfig(device="cpu", Nadmm=2, check_results=False,
                              obs_dir=str(tmp_path / sinks.replace(",", "")),
                              obs_sinks=sinks, **dict(BASE, **ATTACK))
        t = BlockwiseFederatedTrainer(TNet(), cfg, FederatedCifar10(**DATA),
                                      talg.FedAvg())
        t.L = 2
        s, h = t.run(log=SILENT)
        outs.append((s, h, t.obs_recorder))
    (sa, ha, ra), (sb, hb, rb) = outs
    assert ra.enabled and not rb.enabled
    assert _strip(ha) == _strip(hb)
    for a, b in zip(bridge.tree_to_jax(sa.params, stacked=True).values(),
                    bridge.tree_to_jax(sb.params, stacked=True).values()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the CPC trainer likewise
    cpc_out = []
    for sinks in ("jsonl,memory", "none"):
        t = port_trainer(FILES4, SAPS4, obs_sinks=sinks,
                         obs_dir=str(tmp_path / ("c" + sinks[:4])),
                         **CPC_ATTACK)
        s, h = t.run(Nloop=1, Nadmm=2, log=SILENT, prefetch=False)
        cpc_out.append((bridge.cpc_state_to_jax(s), h))
    assert _strip(cpc_out[0][1]) == _strip(cpc_out[1][1])
    for m in cpc_out[0][0]:
        for a, b in zip(_leaves(cpc_out[0][0][m]), _leaves(cpc_out[1][0][m])):
            np.testing.assert_array_equal(a, b)
    assert torch.get_num_threads() == 1


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_profile_dir_writes_a_trace_with_round_spans(tmp_path):
    """``--profile-dir``: a Chrome trace with one ``record_function`` span
    a round, named by the obs round index."""
    from federated_pytorch_test_tpu_torch.utils.profiling import TRACE_FILE

    t = port_trainer(FILES4[:2], SAPS4[:2], profile_dir=str(tmp_path),
                     obs_sinks="none")
    _, h = t.run(Nloop=1, Nadmm=1, log=SILENT, prefetch=False)
    with open(tmp_path / TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"comm_round#{i}" for i in range(len(h))} <= names
