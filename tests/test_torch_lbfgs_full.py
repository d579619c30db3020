"""The port's full-batch L-BFGS (``optim/lbfgs.py`` with
``batch_mode=False``) against the JAX package's ``LBFGSNew`` on the
full-batch cases of ``tests/test_lbfgs.py``: the cubic strong-Wolfe search
(``line_search_fn=True``) and the fixed step (``line_search_fn=False``).

Every case runs both optimizers from the same x0 for the same steps, the
JAX step jitted, and after each step compares x, the loss the step
returns and the integer state (``func_evals``, iteration and history
counters), then runs the case's own check on the port's result.

Tolerance: both sides run in float64 (the JAX side under
``jax.enable_x64``), so that the step lengths the searches pick are the
same.  The searches branch on comparisons of losses and directional
derivatives; the two sides take the same branches, so the integer state,
``func_evals`` included, must agree exactly.  The values differ only by
the order of the reductions (XLA's dot against torch's), which the
stiff cases amplify through the curvature pairs: x, the step and the
state vectors at rtol 1e-9 and atol 1e-9 of their own largest element,
the loss at rtol 1e-9 and atol 1e-12 of the entry loss's scale.  On
Rosenbrock the steps end at the minimum, where the gradient (and so d and
the stored gradient) is cancellation noise of about 1e-7 in size: there
those two are held at 1e-7 of their own largest element, x still at 1e-9.
(In float32 the same branches are taken, but the stiff quadratic's x
drifts 3e-4 apart within one step.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_engine_pair import torch_threads

from federated_pytorch_test_tpu.optim.lbfgs import LBFGSNew as JLBFGS
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew as TLBFGS

INT_FIELDS = ("n_iter_total", "func_evals", "hist_len", "hist_head")
VEC_FIELDS = ("d", "hist_y", "hist_s", "prev_grad")
CUBIC = dict(history_size=7, max_iter=4, line_search_fn=True,
             batch_mode=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


RTOL = 1e-9


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def run_pair(kw: dict, jf, tf, x0: np.ndarray, steps: int,
             grad_rtol: float = RTOL):
    """Both optimizers on ``kw`` for ``steps`` steps; returns the port's
    final (x, state, per-step losses).  ``grad_rtol`` holds d and the
    stored gradient."""
    x0 = np.asarray(x0, np.float64)
    jopt, topt = JLBFGS(**kw), TLBFGS(**kw)
    tx = torch.from_numpy(x0.copy())
    tst = topt.init(tx)
    losses = []
    with jax.enable_x64(True):
        jstep = jax.jit(lambda x, st: jopt.step(jf, x, st))
        jx = jnp.asarray(x0)
        jst = jopt.init(jx)
        for i in range(steps):
            jx, jst, jloss = jstep(jx, jst)
            tx, tst, tloss = topt.step(tf, tx, tst)
            losses.append(float(tloss))
            for f in INT_FIELDS:
                assert getattr(tst, f) == int(getattr(jst, f)), (f, i)
            np.testing.assert_allclose(
                float(tloss), float(jloss), rtol=RTOL,
                atol=1e-12 * max(1.0, abs(losses[0])),
                err_msg=f"loss, step {i}")
            _close(tx, jx, f"x at step {i}")
            _close(tst.t, jst.t, f"t at step {i}")
            for f in VEC_FIELDS:
                _close(getattr(tst, f), getattr(jst, f), f"{f} at step {i}",
                       grad_rtol if f in ("d", "prev_grad") else RTOL)
    return tx, tst, losses


def _quad(A: np.ndarray, b: np.ndarray):
    jA, jb = np.asarray(A, np.float64), np.asarray(b, np.float64)
    tA, tb = torch.from_numpy(jA), torch.from_numpy(jb)
    return (lambda x: 0.5 * x @ jA @ x - jb @ x,
            lambda x: 0.5 * x @ tA @ x - tb @ x)


def test_fields_and_defaults_equal_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JLBFGS)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TLBFGS)]
    assert tf == jf
    assert TLBFGS().line_search_fn is False and TLBFGS().batch_mode is False
    TLBFGS(**CUBIC)


def test_quadratic_converges():
    rng = np.random.default_rng(4)
    Q = rng.normal(size=(10, 10))
    A = Q @ Q.T + 10 * np.eye(10)
    b = rng.normal(size=10)
    jf, tf = _quad(A, b)
    x, _, _ = run_pair(CUBIC, jf, tf, np.zeros(10), 15)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), atol=1e-2)


def test_rosenbrock_descends():
    def jrosen(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2

    def trosen(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2

    x0 = np.asarray([-1.2, 1.0])
    x, _, _ = run_pair(dict(CUBIC, max_iter=10), jrosen, trosen, x0, 30,
                       grad_rtol=1e-7)
    assert float(trosen(x)) < float(trosen(torch.from_numpy(x0))) * 0.05
    assert torch.isfinite(x).all()


@pytest.mark.parametrize("search", ["cubic", "fixed"])
def test_stiff_quadratic(search):
    """The cubic search and the lr=1 fixed step on the stiff quadratic
    the JAX test pits them against each other on; then that test's
    comparison, on the port's results."""
    dj = np.asarray([100.0, 1.0, 0.01])
    dt = torch.from_numpy(dj)
    jf = lambda x: 0.5 * jnp.sum(dj * x * x)
    tf = lambda x: 0.5 * torch.sum(dt * x * x)
    x0 = np.ones(3)
    kw = {"cubic": CUBIC,
          "fixed": dict(lr=1.0, max_iter=4, line_search_fn=False)}[search]
    x, _, _ = run_pair(kw, jf, tf, x0, 6)
    assert torch.isfinite(x).all()
    if search == "cubic":
        with_ls = float(tf(x))
        other = TLBFGS(lr=1.0, max_iter=4, line_search_fn=False)
        xo, st = torch.from_numpy(x0), other.init(torch.from_numpy(x0))
        for _ in range(6):
            xo, st, _ = other.step(tf, xo, st)
        assert with_ls <= float(tf(xo)) or with_ls < 1e-6


def test_isotropic_quadratic_reaches_the_minimum():
    jf, tf = _quad(2 * np.eye(3), np.ones(3))
    x, _, _ = run_pair(dict(CUBIC, max_iter=3), jf, tf, np.zeros(3), 6)
    np.testing.assert_allclose(x.numpy(), 0.5 * np.ones(3), atol=1e-3)


def test_degenerate_gradient_returns_finite():
    """|g.d| < 1e-12 at entry: the search returns step 1.0 (no trial)."""
    kw = dict(CUBIC, tolerance_grad=0.0, tolerance_change=0.0)
    x, _, _ = run_pair(kw, lambda x: jnp.sum(x ** 2),
                       lambda x: torch.sum(x ** 2),
                       np.full((3,), 1e-7), 1)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), np.zeros(3), atol=1e-5)


def test_fixed_step_func_evals():
    """line_search_fn=False, max_iter 3: the entry evaluation and the
    re-evaluations after iterations 1 and 2, none after the last."""
    kw = dict(lr=0.05, max_iter=3, line_search_fn=False)
    _, st, _ = run_pair(kw, lambda x: jnp.sum((x - 0.5) ** 2),
                        lambda x: torch.sum((x - 0.5) ** 2),
                        np.ones(4), 1)
    assert st.func_evals == 3
