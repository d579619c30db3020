"""The CPC trainer's robust rounds and mid-run resume: the port's
``CPCTrainer`` against the JAX one on the same draws and weights, in three
configurations of the robustness knobs.

Tolerances (those of the classifier's fault tests): every count field of
every round exactly; the loss at rtol 1e-4 (float32 L-BFGS steps summed in
another order on each side); the dual residual at rtol 1e-3 (a difference
of two near-equal consensus vectors late in a block); the final
parameters at atol 5e-4 plus rtol 1e-4 (the L-BFGS steps of the krum
configuration grow some weights to magnitude 10-16, where float32 drift
between the two sides measured 5.3e-4 absolute, 4.6e-5 relative).  The preempted-and-resumed run, the fallback
past a damaged slot and the all-active robust round are held bit for bit
against port runs on one torch thread.
"""

import os

import jax
import numpy as np
import pytest
from _torch_cpc_pair import (
    FILES2,
    FILES4,
    SAPS2,
    SAPS4,
    SILENT,
    counts,
    jax_trainer,
    port_trainer,
    run_both,
)
from _torch_engine_pair import torch_threads

from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.parallel.mesh import CollectiveTimeoutError
from federated_pytorch_test_tpu_torch.train.cpc_engine import SUBMODELS
from federated_pytorch_test_tpu_torch.train.faults import FaultSpec
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt

CONFIGS = {
    # the JAX package's cpc_chaos fixture: client 1 ships NaN every round
    "chaos": (FILES2, SAPS2, 3, dict(
        fault_spec="corrupt=1,mode=nan,clients=1,seed=7", update_guard=True,
        quarantine_rounds=1)),
    # partial participation, x100 corruption, krum over a 2-shard mesh
    "krum": (FILES4, SAPS4, 2, dict(
        participation=0.75, fault_spec="corrupt=0.25,mode=scale,scale=100,"
        "seed=3", update_guard=True, quarantine_rounds=1, robust_agg="krum",
        trim_frac=0.25, robust_chunked=True, num_devices=2)),
    # buffered async rounds with transit delay and churn
    "async": (FILES4, SAPS4, 2, dict(
        async_rounds=True, max_staleness=2,
        fault_spec="delay=0.4,delay_max=2,join=0.2,leave=0.2,seed=5")),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    files, saps, nadmm, cfg = CONFIGS[request.param]
    with torch_threads(1):
        out = run_both(files, saps, nadmm, **cfg)
    out["name"] = request.param
    return out


def test_counts_equal_jax(pair):
    assert len(pair["thist"]) == len(pair["jhist"]) > 0
    assert counts(pair["thist"]) == counts(pair["jhist"])


def test_losses_and_residuals_match(pair):
    for key, rtol in (("loss", 1e-4), ("dual_residual", 1e-3)):
        want = np.array([r[key] for r in pair["jhist"]])
        got = np.array([r[key] for r in pair["thist"]])
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_final_params_match(pair):
    for m in SUBMODELS:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=5e-4), pair["tstate"][m],
            pair["jstate"][m])


def test_configuration_exercises_its_knobs(pair):
    h = pair["thist"]
    if pair["name"] == "chaos":
        # client 1 trips in round 0, sits out round 1, trips in round 2
        assert [r["guard_trips"] for r in h[:3]] == [1.0, 0.0, 1.0]
        assert [r["quarantined"] for r in h[:3]] == [0, 1, 0]
        assert [r["n_active"] for r in h[:3]] == [2, 1, 2]
    elif pair["name"] == "krum":
        assert sum(r["fault_corrupted"] for r in h) > 0
        assert min(r["n_active"] for r in h) < 4
    else:
        assert sum(r["async_arrived"] for r in h) > 0
        assert sum(r["joined"] + r["left"] for r in h) > 0


@pytest.mark.parametrize("cfg,attr", [
    (dict(compress="q8"), "compress"),
    (dict(compress="q8", fused_collective=True), "fused_collective"),
    (dict(bb_update=True), "bb_update"),
    (dict(participation=0.0), "participation"),
])
def test_constructor_refusals_keep_jax_messages(cfg, attr):
    with pytest.raises(ValueError) as jerr:
        jax_trainer(FILES2, SAPS2, **cfg)
    with pytest.raises(ValueError) as terr:
        port_trainer(FILES2, SAPS2, **cfg)
    assert str(terr.value) == str(jerr.value)


def _preempt_seed(spec: str, nadmm: int, n_blocks: int = 4):
    """(seed, round) of the first seed whose preemption draw fires first
    inside a block (nadmm > 0) past the first block."""
    for seed in range(500):
        sp = FaultSpec.parse(f"{spec},seed={seed}")
        fires = [b * nadmm + n for b in range(n_blocks) for n in range(nadmm)
                 if sp.round_preempt(0, b, n)]
        if fires and fires[0] % nadmm and fires[0] >= nadmm:
            return seed, fires[0]
    raise AssertionError("no seed preempts inside a block")


RESUME_CFG = dict(update_guard=True, quarantine_rounds=1,
                  async_rounds=True, max_staleness=3, robust_agg="median")


def _strip(h):
    return [{k: v for k, v in r.items() if not k.endswith("_seconds")}
            for r in h]


def _run(ck, spec, resume=False):
    t = port_trainer(FILES2, SAPS2, fault_spec=spec, **RESUME_CFG)
    s, h = t.run(Nloop=1, Nadmm=2, log=SILENT, checkpoint_path=ck,
                 resume=resume)
    return bridge.cpc_state_to_jax(s), h


def test_preempted_resume_is_bit_for_bit(tmp_path):
    base = "corrupt=0.5,clients=0,mode=scale,scale=9,delay=0.4,delay_max=2"
    seed, at = _preempt_seed("preempt=0.3", 2)
    spec = f"{base},seed={seed}"
    preempting = f"{base},preempt=0.3,seed={seed}"
    with torch_threads(1):
        want_s, want_h = _run(str(tmp_path / "ref"), spec)
        ck = str(tmp_path / "ck")
        with pytest.raises(CollectiveTimeoutError) as e:
            _run(ck, preempting)
        assert e.value.round_index == at
        got_s, got_h = _run(ck, preempting, resume=True)
        assert _strip(got_h) == _strip(want_h)
        jax.tree.map(np.testing.assert_array_equal, got_s, want_s)
        # a damaged newest slot: the resume falls back to the older one
        newest = ckpt.checkpoint_slots(ck)[0]
        with open(os.path.join(newest, ckpt.CHECKSUM_FILE), "w") as f:
            f.write("0" * 64 + "\n")
        fb_s, fb_h = _run(ck, spec, resume=True)
    assert _strip(fb_h) == _strip(want_h)
    jax.tree.map(np.testing.assert_array_equal, fb_s, want_s)


def test_all_active_robust_round_is_the_plain_round():
    """The robust round with every client in (the guard on with no bound
    tripping) ends bit for bit where the knobs-off round does: the
    weighted mean of weights 1 is the plain mean."""
    with torch_threads(1):
        a = port_trainer(FILES2, SAPS2)
        assert not a._robust_round
        sa, ha = a.run(Nloop=1, Nadmm=2, log=SILENT, prefetch=False)
        b = port_trainer(FILES2, SAPS2, update_guard=True,
                         guard_norm_mult=1e30)
        assert b._robust_round
        sb, hb = b.run(Nloop=1, Nadmm=2, log=SILENT, prefetch=False)
    assert [r["loss"] for r in ha] == [r["loss"] for r in hb]
    assert [r["dual_residual"] for r in ha] == [r["dual_residual"]
                                                for r in hb]
    for m in SUBMODELS:
        for x, y in zip(jax.tree.leaves(bridge.tree_to_jax(sa[m])),
                        jax.tree.leaves(bridge.tree_to_jax(sb[m]))):
            np.testing.assert_array_equal(x, y)


def test_knobs_off_round_is_slice_one_round():
    """The knobs-off round: every client trains, every client holds z_new
    in the block afterwards, and it launches no Gram."""
    with torch_threads(1):
        t = port_trainer(FILES2, SAPS2)
        s, h = t.run(Nloop=1, Nadmm=1, log=SILENT, prefetch=False)
    assert [r["kernel_launches"] for r in h] == [
        {"infonce_fwd": 0, "infonce_bwd": 0}] * 4
    for m in SUBMODELS:
        for leaf in jax.tree.leaves(bridge.tree_to_jax(s[m], stacked=True)):
            np.testing.assert_array_equal(leaf[0], leaf[1])
    assert all("n_active" not in r for r in h)
