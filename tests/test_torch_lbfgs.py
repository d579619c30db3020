"""The port's L-BFGS (``optim/lbfgs.py``) against the JAX package's
``LBFGSNew(batch_mode=True, line_search_fn=True)`` over several steps with
a batch that changes every step: a quadratic, Rosenbrock and a tiny CPC
(InfoNCE) loss.  x, the loss and every state field are compared after each
step.

Tolerance: float32 on both sides, with reductions in different orders.
The line search makes discrete choices from those values; the two sides
make the same ones here, so the integer counters must agree exactly.  The
curvature pairs are differences of gradients, which amplify the float32
rounding: on Rosenbrock with 4 inner iterations the drift reaches 3.3e-5
of x's scale after 6 steps, against about 1e-7 for the other cases.  So
vectors are compared at rtol 1e-4 / atol 1e-4 of their own largest
element, losses at rtol 5e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.infonce_core import info_nce as jinfo_nce
from federated_pytorch_test_tpu.optim.lbfgs import LBFGSNew as JLBFGS
from federated_pytorch_test_tpu_torch.ops.infonce import info_nce_fused
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew as TLBFGS

VEC_FIELDS = ("d", "hist_y", "hist_s", "prev_grad", "running_avg",
              "running_avg_sq")
SCALAR_FIELDS = ("t", "H_diag", "prev_loss", "alphabar")
INT_FIELDS = ("n_iter_total", "func_evals", "hist_len", "hist_head")


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


# ---- losses: (jax_fn(x, batch), torch_fn(x, batch), n, batches) ----------

def _quadratic(seed=0, n=6, steps=6):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = (M @ M.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    batches = [rng.standard_normal(n).astype(np.float32) for _ in range(steps)]
    jA, tA = jnp.asarray(A), torch.from_numpy(A)

    def jf(x, b):
        return 0.5 * x @ (jA @ x) - jnp.asarray(b) @ x

    def tf(x, b):
        return 0.5 * x @ (tA @ x) - torch.from_numpy(b) @ x

    return jf, tf, rng.standard_normal(n).astype(np.float32), batches


def _rosenbrock(seed=1, n=4, steps=6):
    rng = np.random.default_rng(seed)
    batches = [np.float32(rng.uniform(0.5, 1.5)) for _ in range(steps)]

    def jf(x, b):
        return b * jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                           + (1.0 - x[:-1]) ** 2)

    def tf(x, b):
        return float(b) * torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                    + (1.0 - x[:-1]) ** 2)

    x0 = np.array([-1.2, 1.0, -0.5, 0.8], np.float32)
    return jf, tf, x0, batches


def _cpc(seed=2, B=3, L=6, R=4, px=3, py=3, steps=5):
    """InfoNCE of two 1x1 projections (the predictor block's loss) on a
    fresh latent/context batch per step; x = [W1 | W2], each [L, R]."""
    rng = np.random.default_rng(seed)
    batches = [(rng.standard_normal((B, px, py, L)).astype(np.float32),
                rng.standard_normal((B, px, py, L)).astype(np.float32))
               for _ in range(steps)]
    n = L * R

    def jf(x, b):
        lat, ctx = (jnp.asarray(a) for a in b)
        W1, W2 = x[:n].reshape(L, R), x[n:].reshape(L, R)
        return jinfo_nce(lat @ W1, ctx @ W2)

    def tf(x, b):
        lat, ctx = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in b)
        W1, W2 = x[:n].reshape(L, R), x[n:].reshape(L, R)
        red = torch.einsum("blxy,lr->brxy", lat, W1)
        pred = torch.einsum("blxy,lr->brxy", ctx, W2)
        return info_nce_fused(red, pred)

    return jf, tf, (rng.standard_normal(2 * n) * 0.3).astype(np.float32), batches


CASES = {"quadratic": _quadratic, "rosenbrock": _rosenbrock, "cpc": _cpc}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("history,max_iter", [(7, 2), (3, 4)])
def test_steps_match_jax(case, history, max_iter):
    jf, tf, x0, batches = CASES[case]()
    jopt = JLBFGS(history_size=history, max_iter=max_iter, batch_mode=True,
                  line_search_fn=True)
    topt = TLBFGS(history_size=history, max_iter=max_iter, batch_mode=True,
                  line_search_fn=True)

    @jax.jit
    def jstep(x, st, b):
        return jopt.step(functools.partial(jf, b=b), x, st)

    jx, jst = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
    tx, tst = torch.from_numpy(x0.copy()), topt.init(torch.from_numpy(x0))
    for i, b in enumerate(batches):
        jx, jst, jloss = jstep(jx, jst, b)
        tx, tst, tloss = topt.step(functools.partial(tf, b=b), tx, tst)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-5,
                                   err_msg=f"loss at step {i}")
        _close(tx, jx, f"x at step {i}")
        for f in INT_FIELDS:
            assert getattr(tst, f) == int(getattr(jst, f)), (f, i)
        for f in VEC_FIELDS + SCALAR_FIELDS:
            _close(getattr(tst, f), getattr(jst, f), f"{f} at step {i}")


def test_zero_gradient_stops_at_entry():
    """|g| below tolerance_grad at entry: no inner iteration, x unchanged."""
    opt = TLBFGS(history_size=3, max_iter=2)
    x = torch.zeros(4)
    st = opt.init(x)
    x1, st1, loss = opt.step(lambda v: torch.sum(v * v), x, st)
    assert torch.equal(x1, x) and st1.n_iter_total == 0 and st1.func_evals == 1
    assert float(loss) == 0.0
