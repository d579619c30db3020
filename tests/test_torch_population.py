"""Population cohorts (``population/``) against the JAX package.

- ``client_weights``, ``sample_cohort`` (uniform, weighted, stratified)
  and ``cohort_slot_mask`` over a grid of round coordinates: equal,
  exactly; ``population == K`` is the identity cohort.
- ``ClientRegistry``: the same sequence of draws, ledger gathers and
  scatters, comp-row stashes, churn drops and a block reset on both
  packages' registries; every ledger and the ``meta`` equal, and
  ``restore`` of the meta gives the same registry back.
- One engine pair (K=4 slots over population 10, ``cohort_frac`` 0.75,
  participation 0.9, drop faults; FedAvg on Net, 2 blocks, Nadmm 3, the
  JAX side with ``device_data=False``): every record's counts equal; loss
  at rtol 1e-4, params at atol 5e-4.
- Port only: a registry client sampled again resumes from its own stashed
  error-feedback row, bit for bit; ``population == K`` reads back the
  non-population run's records.
"""

import numpy as np
import pytest
import torch

from _torch_engine_pair import max_param_diff, run_both, torch_threads
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.population import ClientRegistry as JRegistry
from federated_pytorch_test_tpu.population import sampler as jsampler
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.population import ClientRegistry
from federated_pytorch_test_tpu_torch.population import sampler
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves

GRID = [(nloop, ci, nadmm) for nloop in (0, 1) for ci in (0, 4)
        for nadmm in (0, 2, 7)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the port's runs then repeat bit
    for bit, and a loaded machine is not oversubscribed
    (``torch_threads``)."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("population", [10, 37, 1000])
def test_client_weights_equal_jax(population):
    np.testing.assert_array_equal(sampler.client_weights(population, 5),
                                  jsampler.client_weights(population, 5))


@pytest.mark.parametrize("method", sampler.SAMPLER_CHOICES)
@pytest.mark.parametrize("population,cohort", [(10, 4), (40, 10), (9, 9),
                                               (1000, 16)])
def test_sample_cohort_equals_jax(method, population, cohort):
    for nloop, ci, nadmm in GRID:
        kw = dict(seed=3, nloop=nloop, ci=ci, nadmm=nadmm, method=method)
        got = sampler.sample_cohort(population, cohort, **kw)
        np.testing.assert_array_equal(
            got, jsampler.sample_cohort(population, cohort, **kw))
        assert got.dtype == np.int64 and len(set(got.tolist())) == cohort
        if population == cohort:
            np.testing.assert_array_equal(got, np.arange(cohort))


@pytest.mark.parametrize("frac", [1.0, 0.75, 0.5, 0.01])
def test_cohort_slot_mask_equals_jax(frac):
    for nloop, ci, nadmm in GRID:
        kw = dict(seed=8, nloop=nloop, ci=ci, nadmm=nadmm)
        a = sampler.cohort_slot_mask(10, frac, **kw)
        b = jsampler.cohort_slot_mask(10, frac, **kw)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_sampler_errors_match_jax():
    for call in (lambda m: m.sample_cohort(5, 6, seed=0, nloop=0, ci=0,
                                           nadmm=0),
                 lambda m: m.sample_cohort(9, 3, seed=0, nloop=0, ci=0,
                                           nadmm=0, method="roundrobin")):
        with pytest.raises(ValueError) as terr:
            call(sampler)
        with pytest.raises(ValueError) as jerr:
            call(jsampler)
        assert str(terr.value) == str(jerr.value)


def _drive(reg):
    """One scripted life of a registry: draws, ledger round trips, comp-row
    stashes, a churn drop and a block reset; returns its meta."""
    rng = np.random.default_rng(0)
    prev = None
    for r in range(6):
        ids, mask = reg.draw(0, r // 3, r % 3, frac=0.75)
        led = reg.gather_ledgers(ids, round_clock=r % 3)
        led["quarantine"] = np.maximum(led["quarantine"] - 1, 0)
        led["quarantine"][r % 4] = 2
        led["arrival"][(r + 1) % 4] = r % 3 + 1
        led["birth"][(r + 1) % 4] = r % 3
        led["members"][r % 2] = bool(r % 3)
        reg.scatter_ledgers(ids, **led)
        reg.note_round(ids, np.ones(4, np.float32),
                       tripped=np.arange(4) == r % 4)
        leaves = [rng.standard_normal((4, 5)).astype(np.float32),
                  np.arange(4, dtype=np.int64) + r, np.float32(r)]
        if prev is not None:
            reg.stash_comp_rows(prev, leaves, [True, True, False])
        fresh = [np.zeros((4, 5), np.float32), np.zeros(4, np.int64),
                 np.float32(0)]
        loaded = reg.load_comp_rows(ids, fresh, [True, True, False])
        prev = ids
        if r == 3:
            reg.drop_comp_rows(np.arange(reg.population) % 3 == 0)
        if r == 4:
            reg.reset_block()
    return reg.meta(prev), loaded


def test_registry_equals_jax_through_a_scripted_life():
    t = ClientRegistry(10, 4, seed=2, sampling="weighted")
    j = JRegistry(10, 4, seed=2, sampling="weighted")
    tm, tl = _drive(t)
    jm, jl = _drive(j)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k])
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    assert t.comp_rows == j.comp_rows > 0
    # restore: a fresh registry from the meta is the same registry
    t2 = ClientRegistry(10, 4, seed=2, sampling="weighted")
    np.testing.assert_array_equal(t2.restore(tm), jm["pop_cohort"])
    for k, v in t2.meta(tm["pop_cohort"]).items():
        np.testing.assert_array_equal(v, tm[k])
    with pytest.raises(ValueError) as terr:
        ClientRegistry(11, 4, seed=2).restore(tm)
    with pytest.raises(ValueError) as jerr:
        JRegistry(11, 4, seed=2).restore(jm)
    assert str(terr.value) == str(jerr.value)


def test_registry_errors_match_jax():
    for args, kw in (((3, 4, 0), {}), ((10, 4, 0), {"sampling": "x"})):
        with pytest.raises(ValueError) as terr:
            ClientRegistry(*args, **kw)
        with pytest.raises(ValueError) as jerr:
            JRegistry(*args, **kw)
        assert str(terr.value) == str(jerr.value)


POP = dict(Nadmm=3, population=10, cohort_frac=0.75, participation=0.9,
           fault_spec="drop=0.2,seed=2")
COUNTS = ("nloop", "block", "nadmm", "N", "host_dispatches", "n_active",
          "bytes_on_wire",
          "fault_dropped", "fault_straggled", "fault_corrupted")
JAX_ONLY = {"sync_seconds", "compile_seconds", "cache_hit",
            "flops_round", "hlo_bytes_accessed"}


@pytest.fixture(scope="module")
def pop_pair():
    return run_both(JNet, TNet, jalg.FedAvg(), talg.FedAvg(), POP)


def test_population_counts_equal_jax(pop_pair):
    jh, th = pop_pair["jhist"], pop_pair["thist"]
    assert len(jh) == len(th) == 6
    for j, t in zip(jh, th):
        assert set(t) - {"kernel_launches"} == set(j) - JAX_ONLY
        for k in COUNTS:
            assert t.get(k, "absent") == j.get(k, "absent"), k
    jt, tt = pop_pair["jt"], pop_pair["tt"]
    np.testing.assert_array_equal(tt._cohort, jt._cohort)
    for k, v in tt._registry.meta(tt._cohort).items():
        np.testing.assert_array_equal(v, jt._registry.meta(jt._cohort)[k])


def test_population_numbers_track_jax(pop_pair):
    for j, t in zip(pop_pair["jhist"], pop_pair["thist"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["dual_residual"], j["dual_residual"],
                                   rtol=1e-3, atol=1e-7)
    assert max_param_diff(pop_pair["tparams"], pop_pair["jparams"]) <= 5e-4


DATA = dict(K=4, batch=16, limit_per_client=20, limit_test=16)


def _trainer(**cfg):
    t = TTrainer(TNet(), TConfig(K=4, Nloop=1, Nadmm=3, default_batch=16,
                                 device="cpu", **cfg),
                 TData(**DATA), talg.FedAvg())
    t.L = 1
    return t


def test_error_feedback_row_follows_the_registry_client():
    """Rotate the cohort by hand over a q8 + EF state whose rows name
    their owner: a client sampled again gets its own stashed row back, bit
    for bit, and a client new to the block the fresh row of its slot."""
    tt = _trainer(population=10, compress="q8", error_feedback=True)
    comp = tt._init_comp_state(0)
    fresh = tt._init_comp_state(0, "cpu")
    tt._reset_block_ledgers()
    rows = {}
    for r, cohort in enumerate(([0, 3, 5, 9], [1, 3, 6, 9], [0, 1, 3, 9])):
        tt._cohort = np.asarray(cohort, np.int64)
        comp = tt._population_swap_comp(comp, 0)
        for k, rid in enumerate(cohort):
            if rid in rows:
                assert torch.equal(comp["resid"][k], rows[rid])
            elif r:
                assert torch.equal(comp["resid"][k], fresh["resid"][k])
        # the round's work: each slot's row becomes its owner's own
        resid = comp["resid"].clone()
        for k, rid in enumerate(cohort):
            resid[k] = float(rid) + r / 10.0
            rows[rid] = resid[k].clone()
        comp = {**comp, "resid": resid}
    assert tt._registry.comp_rows == 6


def test_population_equal_to_k_is_the_plain_engine():
    a = _trainer(participation=0.6, fault_spec="drop=0.3,seed=4")
    b = _trainer(participation=0.6, fault_spec="drop=0.3,seed=4",
                 population=4)
    sa, ha = a.run(log=lambda m: None)
    sb, hb = b.run(log=lambda m: None)
    timing = {"round_seconds", "stage_seconds", "train_seconds",
              "comm_seconds", "accuracy"}
    strip = lambda h: [{k: v for k, v in r.items() if k not in timing}
                       for r in h]
    assert strip(ha) == strip(hb)
    assert all(torch.equal(x, y) for x, y in
               zip(leaves(sa.params), leaves(sb.params)))
