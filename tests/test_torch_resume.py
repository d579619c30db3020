"""Preemption and resume of the port's engine, against its uninterrupted
run and the JAX engine's.

ADMM on Net (K=4, 2 blocks, Nadmm 3) with participation 0.7, the update
guard and ``drop=0.1`` faults, the mid-run checkpoint on.  The fault seed
is picked so that ``preempt=0.3`` (tag 71, a stream of its own) fires
inside a block:

- the preempted run raises ``CollectiveTimeoutError`` at the predicted
  round, with that round's checkpoint on disk;
- the resumed run (a new trainer, ``resume=True``) disarms the preemption
  and ends bit for bit where the uninterrupted run without ``preempt=``
  ends: every record (timings aside), params, batch statistics, Adam's
  moments and per-client counts;
- the same through ``consensus_multi.main`` (``--midrun-checkpoint``, then
  ``--load-model``), whose end-of-run checkpoints are equal file for file
  in their tensors;
- with q8 + error feedback, the async writer, and population + async
  rounds + churn (every ledger rides the meta), resume is bit for bit too;
- from the JAX run's initial weights, the resumed run against the JAX
  engine's uninterrupted run (``device_data=False``): counts equal, loss
  at rtol 1e-4, params at atol 5e-4.
"""

import numpy as np
import pytest
import torch

from _torch_engine_pair import max_param_diff, run_both, torch_threads
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.drivers import consensus_multi
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
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

BASE = dict(Nadmm=3, participation=0.7, update_guard=True)
TIMING = {"round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
          "ckpt_write_seconds"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the port's runs then repeat bit
    for bit, and a loaded machine is not oversubscribed
    (``torch_threads``)."""
    with torch_threads(1):
        yield


def preempting_seed(L=2, nadmm=3, p=0.3):
    """The first fault seed whose tag-71 draw fires first inside a block
    (nadmm > 0), and the global index of that round."""
    for seed in range(100):
        sp = FaultSpec.parse(f"preempt={p},seed={seed}")
        fires = [ci * nadmm + n for ci in range(L) for n in range(nadmm)
                 if sp.round_preempt(0, ci, n)]
        if fires and fires[0] % nadmm > 0:
            return seed, fires[0]
    raise AssertionError("no seed preempts inside a block")


SEED, AT = preempting_seed()


def same_history(a, b):
    strip = lambda h: [{k: v for k, v in r.items() if k not in TIMING}
                       for r in h]
    sa, sb = strip(a), strip(b)
    if len(sa) != len(sb):
        return False
    for x, y in zip(sa, sb):
        ax, ay = x.pop("accuracy", None), y.pop("accuracy", None)
        if x != y or not np.array_equal(ax, ay):
            return False
    return True


def same_state(a, b):
    pairs = [(leaves(a.params), leaves(b.params)),
             (leaves(a.batch_stats), leaves(b.batch_stats)),
             (leaves(a.opt_state), leaves(b.opt_state)),
             (leaves(a.comp), leaves(b.comp))]
    return all(len(x) == len(y) and all(
        torch.equal(torch.as_tensor(u), torch.as_tensor(v))
        for u, v in zip(x, y)) for x, y in pairs)


#: the engine pair's data; the other kill/resume runs take one minibatch
#: a client (the bits of a resume do not depend on the data's size)
DATA = dict(K=4, batch=16, limit_per_client=40, limit_test=32,
            biased_input=True)
SMALL = dict(DATA, limit_per_client=16, limit_test=16)


def trainer(spec, data, **cfg):
    t = TTrainer(TNet(), TConfig(K=4, Nloop=1, default_batch=16,
                                 biased_input=True, device="cpu",
                                 fault_spec=spec, **dict(BASE, **cfg)),
                 TData(**data), talg.AdmmConsensus())
    t.L = 2
    return t


def kill_and_resume(tmp_path, spec_extra="", start=None, data=SMALL,
                    **cfg):
    """(uninterrupted state and history, the preempted error, resumed
    state and history) of the spec ``drop=0.1`` (+ ``spec_extra``), every
    run from ``start`` (None: the port's common init)."""
    spec = f"drop=0.1{spec_extra},seed={SEED}"
    quiet = lambda m: None
    ref = trainer(spec, data, **cfg).run(start, log=quiet)
    path = str(tmp_path / "midrun")
    pre = f"drop=0.1{spec_extra},preempt=0.3,seed={SEED}"
    with pytest.raises(CollectiveTimeoutError) as err:
        trainer(pre, data, **cfg).run(start, log=quiet, checkpoint_path=path)
    got = trainer(pre, data, **cfg).run(start, log=quiet,
                                        checkpoint_path=path, resume=True)
    return ref, err.value, got


@pytest.fixture(scope="module")
def jax_pair():
    return run_both(JNet, TNet, jalg.AdmmConsensus(), talg.AdmmConsensus(),
                    dict(BASE, fault_spec=f"drop=0.1,seed={SEED}"))


@pytest.fixture(scope="module")
def adam_runs(tmp_path_factory, jax_pair):
    """Kill and resume from the JAX run's initial weights."""
    start = ClientState(*bridge.classifier_state_from_jax(jax_pair["p0"],
                                                          jax_pair["b0"]))
    return kill_and_resume(tmp_path_factory.mktemp("adam"), start=start,
                           data=DATA)


def test_preemption_fires_at_the_predicted_round(adam_runs):
    assert adam_runs[1].round_index == AT
    assert f"simulated preemption at round {AT}" in str(adam_runs[1])


def test_resumed_run_equals_the_uninterrupted_one(adam_runs):
    (s0, h0), _, (s1, h1) = adam_runs
    assert len(h1) == 6 and same_history(h0, h1)
    assert same_state(s0, s1)
    assert len(set(s1.opt_state.count.tolist())) > 1


def test_resume_with_error_feedback_and_the_async_writer(tmp_path):
    (s0, h0), _, (s1, h1) = kill_and_resume(
        tmp_path, compress="q8", error_feedback=True, async_checkpoint=True)
    assert same_history(h0, h1) and same_state(s0, s1)
    assert s1.comp is not None


def test_resume_with_population_async_rounds_and_churn(tmp_path):
    (s0, h0), _, (s1, h1) = kill_and_resume(
        tmp_path, ",delay=0.4,join=0.3,leave=0.3", population=7,
        async_rounds=True, max_staleness=1)
    assert same_history(h0, h1) and same_state(s0, s1)
    assert any(r["left"] for r in h1) and any(r["async_arrived"] for r in h1)


def test_driver_kill_and_load_model(tmp_path):
    argv = ["--device", "cpu", "--K", "4", "--model", "net", "--Nloop", "1",
            "--Nadmm", "2", "--n-train", "16", "--n-test", "16",
            "--default-batch", "16", "--participation", "0.7",
            "--update-guard", "--midrun-checkpoint"]
    quiet = dict(log=lambda m: None)
    ref_dir, run_dir = str(tmp_path / "ref"), str(tmp_path / "run")
    _, sr, hr = consensus_multi.main(
        [*argv, "--fault-spec", f"drop=0.1,seed={SEED}",
         "--checkpoint-dir", ref_dir], **quiet)
    pre = [*argv, "--fault-spec", f"drop=0.1,preempt=0.3,seed={SEED}",
           "--checkpoint-dir", run_dir]
    with pytest.raises(CollectiveTimeoutError):
        consensus_multi.main(pre, **quiet)
    lines = []
    _, s1, h1 = consensus_multi.main([*pre, "--load-model"],
                                     log=lines.append)
    assert any(m.startswith("resumed mid-run checkpoint") for m in lines)
    assert same_history(hr, h1)
    a, ma = ckpt.load_checkpoint(f"{ref_dir}/consensus_multi")
    b, mb = ckpt.load_checkpoint(f"{run_dir}/consensus_multi")
    assert ma == mb == {"rounds": 10}
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_resumed_run_tracks_jax(jax_pair, adam_runs):
    """The resumed run equals the uninterrupted one bit for bit (above),
    and that one is the pair's port run: so the resumed run's records and
    params stand to the JAX engine's uninterrupted run as the pair's do."""
    jh, th = jax_pair["jhist"], jax_pair["thist"]
    (s0, h0), _, (s1, h1) = adam_runs
    assert same_history(th, h0) and same_state(jax_pair["tstate"], s0)
    for j, t in zip(jh, h1):
        for k in ("n_active", "fault_dropped", "quarantined", "guard_trips",
                  "n_ok", "bytes_on_wire"):
            assert t.get(k, "absent") == j.get(k, "absent"), k
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    tparams, _ = bridge.classifier_state_to_jax(s1.params, s1.batch_stats)
    assert max_param_diff(tparams, jax_pair["jparams"]) <= 5e-4
