"""The port's runtime sanitizer (``--sanitize``) against the JAX package's
checkify wiring.

- the checks on single steps: a NaN an op makes (named as the aten op),
  a zero divisor, an out-of-range index with its (index, axis, size)
  payload (the op still runs, on index 0), the backward inside the step,
  a hand-written kernel's report, nesting, and no mode outside a step;
- the classifier engine with ``sanitize`` on ends bit for bit where it
  ends off, on FedAvg and ADMM (``tests/test_analysis_runtime.py``), the
  chunked krum and the q8 fused collective in fused rounds at D=2;
- a NaN corruption of the wire (``corrupt=1,mode=nan``) and NaN initial
  parameters raise in the same round and the same step kind (comm,
  train) in JAX (checkify's ``JaxRuntimeError``) and in the port
  (``SanitizerError``), while the unsanitized port run goes on; the
  supervisor does not retry it (JAX's ``RETRYABLE`` has no
  ``JaxRuntimeError``);
- the CPC round under ``sanitize``: bit for bit the port's unsanitized
  round, and within the CPC pair's tolerances of JAX's unsanitized run.
"""

import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from _torch_cpc_pair import (
    FILES2,
    SAPS2,
    SILENT,
    jax_trainer as jax_cpc,
    port_trainer as port_cpc,
)
from _torch_engine_pair import torch_threads
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.analysis import sanitize
from federated_pytorch_test_tpu_torch.analysis.sanitize import (
    Sanitizer,
    SanitizerError,
)
from federated_pytorch_test_tpu_torch.control.supervisor import (
    RETRYABLE,
    supervise_classifier,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.cpc_engine import SUBMODELS
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
    ClientState,
)
from federated_pytorch_test_tpu_torch.utils.tree import leaves, tree_map

DATA = dict(K=4, batch=16, limit_per_client=32, limit_test=32)
BASE = dict(K=4, Nloop=1, Nepoch=1, Nadmm=2, default_batch=16,
            check_results=False, admm_rho0=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def raises_in_step(fn):
    san = Sanitizer("cpu")
    with pytest.raises(SanitizerError) as e:
        with san.step("unit step"):
            fn()
    assert str(e.value).startswith("unit step: ")
    return e.value


# -- single steps --------------------------------------------------------


def test_clean_step_passes_and_leaves_no_mode():
    san = Sanitizer("cpu")
    x = torch.linspace(0.5, 2.0, 6)
    with san.step("clean"):
        assert _get_current_dispatch_mode() is not None
        y = torch.log(x).sum() / 3.0 + torch.ones(2, 3)[torch.tensor([1])]
    assert _get_current_dispatch_mode() is None
    assert sanitize._ACTIVE is None
    assert torch.equal(y, torch.log(x).sum() / 3.0 + torch.ones(1, 3))


@pytest.mark.parametrize("fn,op", [
    (lambda: torch.log(-torch.ones(3)), "aten.log.default"),
    (lambda: torch.sqrt(torch.tensor([1.0, -4.0])) + 1, "aten.sqrt.default"),
    (lambda: torch.ones(2, 2) @ torch.full((2, 2), float("nan")),
     "aten.mm.default"),
    (lambda: torch.full((3,), float("inf")) - float("inf"),
     "aten.sub.Tensor"),
], ids=["log", "sqrt", "matmul", "inf-inf"])
def test_a_nan_names_the_first_op(fn, op):
    err = raises_in_step(fn)
    assert err.kind == "nan" and err.op == op
    assert f"nan generated by op: {op}" in str(err)


@pytest.mark.parametrize("fn,op", [
    (lambda: torch.ones(3) / torch.tensor([1.0, 0.0, 2.0]),
     "aten.div.Tensor"),
    (lambda: torch.ones(3) / 0.0, "aten.div.Tensor"),
    (lambda: 1.0 / torch.zeros(2), "aten.reciprocal.default"),
    (lambda: torch.arange(4) // torch.tensor([1, 0, 1, 1]),
     "aten.floor_divide.default"),
], ids=["tensor", "python-zero", "reciprocal", "floor-int"])
def test_a_zero_divisor_raises(fn, op):
    err = raises_in_step(fn)
    assert err.kind == "division by zero" and err.op == op


def test_a_guarded_division_still_raises():
    """checkify's div check reads the divisor, not the select after it:
    a ``where`` that guards the quotient does not silence it."""
    n = torch.tensor([2.0, 0.0])
    err = raises_in_step(lambda: torch.where(n > 0, torch.ones(2) / n,
                                             torch.zeros(2)))
    assert err.kind == "division by zero"


@pytest.mark.parametrize("fn,op,payload", [
    (lambda: torch.gather(torch.ones(3, 4), 1, torch.tensor([[0], [7], [1]])),
     "aten.gather.default", (7, 1, 4)),
    (lambda: torch.ones(5, 2).index_select(0, torch.tensor([1, -1])),
     "aten.index_select.default", (-1, 0, 5)),
    (lambda: torch.arange(4.0)[torch.tensor([0, 9, 2])],
     "aten.index.Tensor", (9, 0, 4)),
    (lambda: torch.nn.functional.nll_loss(
        torch.zeros(2, 3).log_softmax(1), torch.tensor([1, 5])),
     "aten.nll_loss_forward.default", (5, 1, 3)),
    (lambda: torch.zeros(3).scatter_add(0, torch.tensor([3]),
                                        torch.ones(1)),
     "aten.scatter_add.default", (3, 0, 3)),
], ids=["gather", "index_select", "index", "nll_loss", "scatter_add"])
def test_an_out_of_range_index_raises_with_its_payload(fn, op, payload):
    err = raises_in_step(fn)
    assert err.kind == "out-of-bounds index" and err.op == op
    assert err.payload == payload
    i, a, s = payload
    assert (f"index {i} is out of bounds for axis {a} with size {s}"
            in str(err))


def test_an_out_of_range_index_runs_the_op_on_index_zero():
    san = Sanitizer("cpu")
    src = torch.arange(12.0).reshape(3, 4)
    out = {}
    with pytest.raises(SanitizerError):
        with san.step("s"):
            out["g"] = torch.gather(src, 1, torch.tensor([[2], [9], [3]]))
    assert out["g"].flatten().tolist() == [2.0, 4.0, 11.0]


def test_ignored_targets_and_in_range_indices_pass():
    san = Sanitizer("cpu")
    logp = torch.randn(3, 4).log_softmax(1)
    t = torch.tensor([1, -100, 3])
    with san.step("s"):
        got = torch.nn.functional.nll_loss(logp, t)
        idx = torch.arange(4.0)[torch.tensor([-4, 3])]
    assert torch.equal(got, torch.nn.functional.nll_loss(logp, t))
    assert idx.tolist() == [0.0, 3.0]


def test_the_backward_is_checked():
    w = torch.ones(3, requires_grad=True)

    def step():
        (g,) = torch.autograd.grad((w * torch.tensor([1.0, 0.0, 2.0]))
                                   .sqrt().sum(), w)
    err = raises_in_step(step)
    assert err.kind in ("nan", "division by zero")


def test_only_the_first_error_is_reported():
    def step():
        torch.ones(2) / torch.zeros(2)
        torch.log(-torch.ones(2))
    assert raises_in_step(step).kind == "division by zero"


def test_a_step_inside_a_step_is_part_of_it():
    san = Sanitizer("cpu")
    with pytest.raises(SanitizerError, match="^outer: nan"):
        with san.step("outer"):
            with san.step("inner"):
                torch.log(-torch.ones(1))
            torch.ones(1) + 1


def test_kernel_report_names_the_kernel():
    sanitize.report("gram", torch.full((2,), float("nan")))  # no step: no-op
    err = raises_in_step(lambda: sanitize.report(
        "infonce_bwd", torch.ones(2), torch.tensor([0.0, float("nan")])))
    assert err.op == "kernel infonce_bwd"
    assert str(err) == "unit step: nan generated by op: kernel infonce_bwd"


def test_sanitize_off_builds_no_sanitizer():
    t = TTrainer(TNet(), TConfig(device="cpu", **BASE), TData(**DATA),
                 talg.FedAvg())
    assert t._sanitizer is None


# -- the engine ------------------------------------------------------------

ENGINE_CASES = {
    "fedavg": (talg.FedAvg, {}),
    "admm": (talg.AdmmConsensus, {}),
    "krum-chunked": (talg.AdmmConsensus,
                     dict(robust_agg="krum", robust_chunked=True,
                          num_devices=2)),
    "q8-fused-rounds": (talg.FedAvg,
                        dict(compress="q8", fused_collective=True,
                             num_devices=2, device_data=True,
                             fused_rounds=True, Nepoch=2)),
}


def port_run(algo, start=None, **kw):
    t = TTrainer(TNet(), TConfig(device="cpu", **dict(BASE, **kw)),
                 TData(**DATA), algo)
    t.L = 2
    return t.run(start, log=SILENT)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_sanitized_run_is_bit_for_bit_the_run_without(case):
    algo, kw = ENGINE_CASES[case]
    s0, h0 = port_run(algo(), **kw)
    s1, h1 = port_run(algo(), sanitize=True, **kw)
    strip = lambda h: [{k: v for k, v in r.items()
                        if not k.endswith("_seconds")} for r in h]
    assert strip(h0) == strip(h1) and len(h1) == 4
    for u, v in zip(leaves(s0.params) + leaves(s0.batch_stats),
                    leaves(s1.params) + leaves(s1.batch_stats)):
        assert torch.equal(u, v)


def _jax_failure(cfg, start=None):
    """(step kind, rounds completed) of a sanitized JAX run that raises:
    the kind from the engine frame that called the throwing step."""
    t = JTrainer(JNet(), JConfig(device_data=False, **cfg), JData(**DATA),
                 jalg.AdmmConsensus())
    t.L = 2
    rounds = []
    with pytest.raises(Exception) as e:
        t.run(state=start(t) if start else None, log=SILENT,
              on_round=lambda s, r: rounds.append(r))
    assert type(e.value).__name__ == "JaxRuntimeError"
    assert "nan generated by primitive" in str(e.value)
    lines = [f.line for f in traceback.extract_tb(e.value.__traceback__)
             if f.filename.endswith("train/engine.py")]
    kind = ("comm" if "comm_fns" in lines[-1]
            else "train" if "train_epoch" in lines[-1] else lines[-1])
    return kind, len(rounds), t


def _nan_params(t):
    st = t.init_state()
    return st._replace(params=jax.tree.map(
        lambda x: jax.numpy.full_like(x, jax.numpy.nan), st.params))


@pytest.mark.parametrize("case", ["comm", "train"])
def test_nan_raises_where_jax_raises(case):
    cfg = dict(BASE, sanitize=True)
    if case == "comm":
        cfg["fault_spec"] = "corrupt=1.0,mode=nan,seed=1"
        kind, done, _ = _jax_failure(cfg)
        start = None
    else:
        kind, done, jt = _jax_failure(cfg, _nan_params)
        p0 = jax.tree.map(np.asarray, jt.params0)
        b0 = jax.tree.map(np.asarray, jt.batch_stats0)
        p, b = bridge.classifier_state_from_jax(p0, b0)
        start = ClientState(tree_map(lambda x: torch.full_like(
            x, float("nan")), p), b)
    assert (kind, done) == (case, 0)
    with pytest.raises(SanitizerError) as e:
        port_run(talg.AdmmConsensus(), start, **cfg)
    assert str(e.value).startswith(f"{case} step (block 0, round {done}): "
                                   "nan generated by op: aten.")
    assert e.value.kind == "nan"
    if case == "comm":
        # without --sanitize the run goes on (the consensus is NaN)
        _, h = port_run(talg.AdmmConsensus(),
                        fault_spec=cfg["fault_spec"])
        assert len(h) == 4


def test_the_supervisor_does_not_retry_a_sanitizer_error(tmp_path):
    assert not issubclass(SanitizerError, RETRYABLE)
    cfg = TConfig(device="cpu", sanitize=True, max_restarts=2,
                  restart_backoff=0.0, obs_sinks="none",
                  fault_spec="corrupt=1.0,mode=nan,seed=1", **BASE)
    built = []

    def build(c, attempt):
        built.append(attempt)
        t = TTrainer(TNet(), c, TData(**DATA), talg.AdmmConsensus())
        t.L = 2
        return t

    with pytest.raises(SanitizerError):
        supervise_classifier(build, cfg, str(tmp_path / "ck"),
                             run_kwargs={"log": SILENT}, log=SILENT,
                             sleep=lambda s: None)
    assert built == [1]


# -- the CPC round -------------------------------------------------------


@pytest.fixture(scope="module")
def cpc_runs():
    """JAX's unsanitized CPC rotation (Nadmm 1), and the port's from its
    initial state with ``sanitize`` off and on."""
    jt = jax_cpc(FILES2, SAPS2)
    js, jhist = jt.run(Nloop=1, Nadmm=1, log=SILENT, prefetch=False)
    state0 = bridge.cpc_state_from_jax(jax.tree.map(np.asarray, jt.state0))
    out = {"jhist": jhist,
           "jstate": jax.tree.map(np.asarray, js._asdict())}
    for on in (False, True):
        tt = port_cpc(FILES2, SAPS2, sanitize=on)
        s, h = tt.run(Nloop=1, Nadmm=1, state=state0, log=SILENT,
                      prefetch=False)
        out[on] = (bridge.cpc_state_to_jax(s), h)
    return out


def test_sanitized_cpc_round_is_bit_for_bit(cpc_runs):
    (s0, h0), (s1, h1) = cpc_runs[False], cpc_runs[True]
    strip = lambda h: [{k: v for k, v in r.items()
                        if not k.endswith("_seconds")} for r in h]
    assert strip(h0) == strip(h1) and len(h1) > 0
    jax.tree.map(np.testing.assert_array_equal, s1, s0)


def test_sanitized_cpc_round_matches_jax(cpc_runs):
    jh, (ts, th) = cpc_runs["jhist"], cpc_runs[True]
    assert len(th) == len(jh)
    for key, rtol in (("loss", 1e-4), ("dual_residual", 1e-3)):
        np.testing.assert_allclose([r[key] for r in th],
                                   [r[key] for r in jh], rtol=rtol,
                                   atol=1e-7)
    for m in SUBMODELS:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=5e-4), ts[m], cpc_runs["jstate"][m])
