"""The local epoch's client-step graphs (``train/engine.py``
``_train_epoch``, ``train/step_graph.py``).

On the CPU the eager loop runs: for an L-BFGS block, a model with
reparametrisation noise, under ``--sanitize`` and for a plain Adam block,
and every round record counts its client-steps as eager.  The choice is
the code's own: only a card, an Adam block, no noise and no sanitizer
make the steps replay.  The replay's bookkeeping (the slots, the
statistics buffers, the bias-correction table, the clients that sit out,
the key that forces a new capture) runs here too, with a stand-in graph
that runs the captured step when it is replayed: a partial round with a
rho moved by the BB update and a block switch end bit for bit where the
eager loop does, with the counts the rounds should have.

On the card (``card``), the same rounds at cell ``resnet18.admm.stem``'s
shape replay from real graphs and end within the cell's limits of the
eager loop, and bit for bit with cuDNN's deterministic algorithms.  The
file imports no JAX, so it runs on a machine without it::

    python3 -m pytest tests/test_torch_step_graph.py --noconftest \
        -m card -q -p no:cacheprovider
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu_torch.models.resnet import ResNet9, ResNet18
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.models.vae import AutoEncoderCNN
from federated_pytorch_test_tpu_torch.train import algorithms as alg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
    adam_bias_corrections,
)
from federated_pytorch_test_tpu_torch.train.step_graph import (
    ClientStepGraphs,
)
from federated_pytorch_test_tpu_torch.train.vae_engine import VAETrainer
from federated_pytorch_test_tpu_torch.utils import codec
from federated_pytorch_test_tpu_torch.utils.tree import get_by_path, leaves
from portbench.check import gaps, leaf_norms
from test_torch_round_spans import card, images, one_thread  # noqa: F401

K = 2
#: 24 images a client in batches of 16: two steps, the last one masked
N_IMAGES, BATCH = 24, 16
STEPS = 2
BASE = dict(device="cpu", K=K, Nloop=1, Nepoch=1, Nadmm=2,
            default_batch=BATCH, check_results=False, admm_rho0=0.1,
            biased_input=True, obs_sinks="memory", device_data=True)


def trainer(model=Net, cls=BlockwiseFederatedTrainer, algo=None,
            n=N_IMAGES, test=32, **kw):
    cfg = FederatedConfig(**dict(BASE, **kw))
    t = cls(model(), cfg, images(cfg.K, n, cfg.default_batch, test),
            algo or alg.AdmmConsensus())
    t.L = 1
    return t


def rounds(t):
    return [r for r in t.obs_recorder.memory if r["event"] == "round"]


CASES = {"lbfgs": dict(optimizer="lbfgs"),
         "noise": dict(model=AutoEncoderCNN, cls=VAETrainer,
                       algo=alg.FedAvg()),
         "sanitize": dict(sanitize=True),
         "adam": dict(participation=0.5)}


@pytest.mark.parametrize("case", list(CASES))
def test_the_cpu_runs_the_eager_loop_and_counts_it(case):
    t = trainer(**CASES[case])
    with one_thread():
        t.run(log=lambda m: None)
    recs = rounds(t)
    assert len(recs) == 2
    for r in recs:
        n_active = r.get("n_active", K)
        assert r["eager_steps"] == n_active * STEPS
        assert r["graph_steps"] == r["graph_captures"] == 0
        assert r["step_replay_seconds"] == 0
    assert not t._step_graphs.graphs


@pytest.mark.parametrize("case", list(CASES))
def test_only_an_adam_block_without_noise_or_sanitizer_replays(case):
    t = trainer(**CASES[case])
    assert not t._graphs_sound(0)               # no card
    t.device = torch.device("cuda")             # the decision alone
    assert t._graphs_sound(0) is (case == "adam")


def test_bias_table_is_the_eager_formula():
    g = ClientStepGraphs("cpu", adam_bias_corrections)
    g.reserve(40)
    for c in (1, 2, 3, 17, 40):
        b1, b2 = g.bias(torch.tensor(c))
        e1, e2 = adam_bias_corrections(c, "cpu")
        assert torch.equal(b1, e1) and torch.equal(b2, e2)
    g.key, g.graphs = "held", [object()]
    g.reserve(40 + ClientStepGraphs.TABLE0)      # grows: the graphs go
    assert g.key is None and not g.graphs
    assert torch.equal(g.bias(torch.tensor(40))[1],
                       adam_bias_corrections(40, "cpu")[1])


def stand_in(self, key, rows, slots, stats, step):
    """``ClientStepGraphs.capture`` without a card: a graph whose replay
    runs the captured step on what the slots hold then."""
    self.release()
    self.graphs = [SimpleNamespace(replay=functools.partial(step, j))
                   for j in range(rows)]
    self.slots, self.stats, self.key = slots, stats, key
    return rows


def eight_rounds(path: str, model=ResNet9, **kw):
    """ADMM with the BB update every round (spectral steps up to rho 10
    taken) on the model's first two blocks, four rounds each, where
    client 1 sits round 2 out (the BB update needs every client in a round, so the
    test makes block 0's rounds partial itself).  ``path``: "eager" (the
    eager loop throughout), "graph" (the engine's own choice) or
    "stand-in" (replays on the CPU through :func:`stand_in`).  Returns
    the round records, the history, each epoch's outputs (the block
    stack, Adam's moments, the losses and the statistics, on the host),
    the final state and the trainer."""
    t = trainer(model=model, Nadmm=4, bb_update=True, bb_period_T=1,
                bb_alphacorrmin=-1.0, bb_epsilon=0.0, bb_rhomax=10.0,
                fused_rounds=True, **kw)
    t.L = 2
    t._flag_cache[0] = (True, None)
    activity = t._round_activity

    def one_out(nloop, ci, nadmm):
        train, comm, corrupt, host, counts = activity(nloop, ci, nadmm)
        if (ci, nadmm) == (0, 2):
            train = np.ones(t.cfg.K, np.float32)
            train[1] = 0.0
            comm = host = train
        return train, comm, corrupt, host, counts

    t._round_activity = one_out
    if path == "eager":
        t._graphs_sound = lambda ci: False
    elif path == "stand-in":
        t._graphs_sound = lambda ci: t.optimizer_for_block(ci) == "adam"
        t._step_graphs.capture = functools.partial(stand_in, t._step_graphs)
    epochs, train_epoch = [], t.train_epoch

    def kept(state, ci, *a, **kw):
        st, losses = train_epoch(state, ci, *a, **kw)
        x = codec.get_trainable_stack(st.params, t.order,
                                      t.mask_for_block(ci))
        epochs.append([x.cpu(), st.opt_state.mu.cpu(), st.opt_state.nu.cpu(),
                       losses.cpu(),
                       *(s.cpu() for s in leaves(st.batch_stats))])
        return st, losses

    t.train_epoch = kept
    with one_thread():
        state, hist = t.run(log=lambda m: None)
    return rounds(t), hist, epochs, state, t


def replays_a_moved_rho(hist, recs) -> bool:
    """Whether a round replays with a rho that a BB update of its block
    moved away from the block's first, under which its graphs were
    captured."""
    rho0 = float(np.float32(BASE["admm_rho0"]))
    return any(recs[i]["graph_steps"] > 0 and h["block"] == hist[i]["block"]
               and h["rho"] != rho0 for i, h in enumerate(hist[:-1], 1))


def counts_of(recs):
    return [(r["eager_steps"], r["graph_steps"], r["graph_captures"])
            for r in recs]


def expected_counts(k, steps):
    """(eager, replayed, captured) of the eight rounds: a capture after
    each block's first epoch, the replays of the rest."""
    block = [(k * steps, 0, k)] + [(0, k * steps, 0)] * 3
    return block[:2] + [(0, (k - 1) * steps, 0)] + block[3:] + block


def test_replayed_steps_end_where_the_eager_loop_does():
    eager, replayed = eight_rounds("eager"), eight_rounds("stand-in")
    recs = replayed[0]
    assert counts_of(recs) == expected_counts(K, STEPS)
    assert counts_of(eager[0]) == [(K * STEPS, 0, 0)] * 2 + [
        ((K - 1) * STEPS, 0, 0)] + [(K * STEPS, 0, 0)] * 5
    for r in recs[1:4] + recs[5:]:
        assert r["step_forward_seconds"] == r["step_backward_seconds"] == 0
        assert r["step_replay_seconds"] > 0
    assert replays_a_moved_rho(replayed[1], recs)
    for a, b in zip(eager[1], replayed[1]):
        for k in ("loss", "rho", "primal_residual", "dual_residual"):
            assert a[k] == b[k]
    assert len(eager[2]) == len(replayed[2]) == 8
    for ea, eb in zip(eager[2], replayed[2]):
        for x, y in zip(ea, eb):
            assert torch.equal(x, y)
    for x, y in zip(leaves((eager[3].params, eager[3].batch_stats)),
                    leaves((replayed[3].params, replayed[3].batch_stats))):
        assert torch.equal(x, y)


# -- on the card ------------------------------------------------------------
#: PERF.md's limits of cell resnet18.admm.stem
LIMITS = {"loss": 3.0e-6, "grad": 8.0e-6, "change": 1.6e-5, "stats": 3.6e-5}


def compared(a, b) -> dict:
    """The numbers of ``portbench/check.py`` of run ``a`` against run
    ``b`` (``eight_rounds`` results) over block 0's four rounds, as the
    check takes them over a cell's three: each client's loss's relative
    gap, the worst round; Adam's first moment after the first replayed
    round; the block's change and the statistics' change after the last
    round, each a client's worst leaf gap; the medians over the
    clients."""
    t = b[4]
    paths = codec.active_paths_in_order(t.order, t.mask_for_block(0))
    sizes = [get_by_path(t.params0, p)[0].numel() for p in paths]
    x0 = codec.get_trainable_stack(t.params0, t.order,
                                   t.mask_for_block(0)).cpu()
    stats0 = torch.cat([s.cpu() for s in leaves(t.batch_stats0)], dim=1)
    sizes_stats = [s.shape[1] for s in leaves(t.batch_stats0)]
    worst = lambda x, y, sz: gaps(leaf_norms(x, sz),
                                  leaf_norms(y, sz)).max(axis=1)
    (ea, eb), last = (a[2][1], b[2][1]), (a[2][3], b[2][3])
    nums = {"grad": worst(ea[1], eb[1], sizes),
            "change": worst(last[0][0] - x0, last[1][0] - x0, sizes),
            "stats": worst(torch.cat(last[0][4:], 1) - stats0,
                           torch.cat(last[1][4:], 1) - stats0, sizes_stats),
            "loss": np.max([np.abs(x[3].double().numpy()
                                   - y[3].double().numpy())
                            / np.maximum(np.abs(y[3].double().numpy()), 1e-30)
                            for x, y in zip(a[2][:4], b[2][:4])], axis=0)}
    return {n: float(np.median(v)) for n, v in nums.items()}


@pytest.mark.card
def test_graph_rounds_end_where_the_eager_loop_does_on_the_card(card):
    """Cell ``resnet18.admm.stem``'s shape (ResNet18, K=10, batch 128,
    1,280 images a client, ADMM, device data, fused rounds, evaluation on
    1,000 test images) over the eight rounds of :func:`eight_rounds`, the
    engine's graphs against the eager loop: within the cell's limits, and
    bit for bit with cuDNN's deterministic algorithms."""
    kw = dict(model=ResNet18, device=str(card), K=10, n=1280,
              default_batch=128, test=1000, lr=1e-3, admm_rho0=0.1,
              check_results=True)
    runs = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            runs[det] = {p: eight_rounds(p, **kw) for p in ("graph", "eager")}
        finally:
            torch.backends.cudnn.deterministic = False
    steps = 1280 // 128
    for det, r in runs.items():
        assert counts_of(r["graph"][0]) == expected_counts(10, steps)
        assert replays_a_moved_rho(r["graph"][1], r["graph"][0])
    graph, eager = runs[True]["graph"], runs[True]["eager"]
    for a, b in zip(graph[1], eager[1]):
        for k in ("loss", "rho", "primal_residual", "dual_residual"):
            assert a[k] == b[k], (k, a, b)
        assert np.array_equal(a["accuracy"], b["accuracy"])
    for ea, eb in zip(graph[2], eager[2]):
        for x, y in zip(ea, eb):
            assert torch.equal(x, y)
    for x, y in zip(leaves((graph[3].params, graph[3].batch_stats)),
                    leaves((eager[3].params, eager[3].batch_stats))):
        assert torch.equal(x, y)
    nums = compared(runs[False]["graph"], runs[False]["eager"])
    assert all(nums[n] <= lim for n, lim in LIMITS.items()), nums
