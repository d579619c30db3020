"""Stochastic L-BFGS on a flat parameter vector: batch mode with the
backtracking line search, full batch with the cubic strong-Wolfe search,
or a fixed step.

Port of ``federated_pytorch_test_tpu/optim/lbfgs.py`` (``LBFGSNew``, with
its fields and defaults).  The JAX ``lax.while_loop`` / ``lax.cond`` become
Python control flow that reads scalars with ``.item()``; the scalars stay
0-d tensors of the parameters' dtype, so every comparison the searches
make is on the values the JAX package compares.  The constants and quirks
are the JAX package's (reference lbfgsnew.py):

  * batch mode: trust region ``y += 1e-6 * s``; batch change detected at
    the first inner iteration of every step after the first, feeding the
    online inter-batch gradient mean/variance and the max step
    ``alphabar = 1/(1 + Var/((n-1)*|g|))``, with ``|g|`` the gradient norm
    at step entry;
  * curvature pairs stored only when ``ys > 1e-10*|s|^2`` and the batch did
    not change, in a circular buffer of ``history_size`` slots;
  * ``batch_mode=True, line_search_fn=True``: backtracking with Armijo
    c1=1e-4 and at most 35 halvings shared by the positive phase and the
    negative-step probe;
  * ``batch_mode=False, line_search_fn=True``: the cubic strong-Wolfe
    search (Fletcher): bracketing with sigma=0.1, rho=0.01, t1=9, t2=0.1,
    t3=0.5, ``alpha1 = 10*lr``, ``tol = min(0.01*phi_0, 1e-6)``, at most 3
    bracketing rounds whose Armijo test omits rho and which do not advance
    ``alphai1`` when they interpolate, step 1.0 on a degenerate phi'(0)
    (``|phi'(0)| < 1e-12``) or a non-finite mu; a zoom of at most 4
    rounds; the exact ``g.d`` in place of the reference's central
    differences; a NaN step falls back to ``lr``;
  * ``line_search_fn=False``: the fixed step ``min(1, 1/sum|g|)*lr`` on the
    first iteration ever, else ``lr``;
  * ``step`` returns the loss of its first closure call; ``func_evals``
    counts that call, the re-evaluations and the line-search trials.

The trainers pass ``batch_mode=True, line_search_fn=True`` (the JAX
trainers' configuration); the defaults are the JAX optimizer's.  The
closure is ``loss_fn(x) -> scalar tensor``, differentiable in ``x``.
Loss-only trials evaluate it under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

LossFn = Callable[[torch.Tensor], torch.Tensor]


class LBFGSState(NamedTuple):
    """Persistent optimizer state (the JAX ``LBFGSState``, field for field).
    Counters and buffer indices are Python ints; the rest are float32
    tensors on the parameters' device."""

    n_iter_total: int
    func_evals: int
    d: torch.Tensor                # [N] last direction
    t: torch.Tensor                # last accepted step size
    hist_y: torch.Tensor           # [M, N] circular curvature buffers
    hist_s: torch.Tensor           # [M, N]
    hist_len: int
    hist_head: int                 # slot of the OLDEST valid entry
    H_diag: torch.Tensor
    prev_grad: torch.Tensor        # [N]
    prev_loss: torch.Tensor
    running_avg: torch.Tensor      # [N] inter-batch grad mean
    running_avg_sq: torch.Tensor   # [N] accumulated second moment
    alphabar: torch.Tensor         # adaptive max step


def value_and_grad(loss_fn: LossFn, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d x) at ``x``; both detached."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        loss = loss_fn(xv)
        (g,) = torch.autograd.grad(loss, xv)
    return loss.detach(), g


def _value(loss_fn: LossFn, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return loss_fn(x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


@dataclasses.dataclass(frozen=True)
class LBFGSNew:
    """Stochastic L-BFGS on a flat parameter vector.

    Usage::

        opt = LBFGSNew(history_size=7, max_iter=2, batch_mode=True,
                       line_search_fn=True)
        state = opt.init(x0)
        x, state, loss = opt.step(loss_fn, x, state)
    """

    lr: float = 1.0
    max_iter: int = 10
    max_eval: Optional[int] = None
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    history_size: int = 7
    line_search_fn: bool = False
    batch_mode: bool = False

    def _max_eval(self) -> int:
        return self.max_eval if self.max_eval is not None else self.max_iter * 5 // 4

    def init(self, x: torch.Tensor) -> LBFGSState:
        n, m = x.shape[-1], self.history_size
        z = lambda *s: torch.zeros(s, dtype=x.dtype, device=x.device)
        c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
        return LBFGSState(
            n_iter_total=0, func_evals=0, d=z(n), t=c(self.lr),
            hist_y=z(m, n), hist_s=z(m, n), hist_len=0, hist_head=0,
            H_diag=c(1.0), prev_grad=z(n), prev_loss=c(0.0),
            running_avg=z(n), running_avg_sq=z(n), alphabar=c(self.lr))

    # ------------------------------------------------------------------
    def _two_loop(self, g, hist_y, hist_s, hist_len: int, head: int, H_diag):
        """d = -H*g over the valid slots of the circular buffer."""
        M = self.history_size

        def ro(pi):
            ys = _dot(hist_y[pi], hist_s[pi])
            return 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys)

        q = -g
        al = {}
        for li in range(hist_len - 1, -1, -1):       # newest first
            pi = (head + li) % M
            a = ro(pi) * _dot(hist_s[pi], q)
            al[pi] = a
            q = q - a * hist_y[pi]
        r = H_diag * q
        for li in range(hist_len):                   # oldest first
            pi = (head + li) % M
            be = ro(pi) * _dot(hist_y[pi], r)
            r = r + (al[pi] - be) * hist_s[pi]
        return r

    def _push(self, hist_y, hist_s, hist_len: int, head: int, y, s):
        """Append (y, s); evict the oldest when full."""
        M = self.history_size
        full = hist_len == M
        idx = head if full else (head + hist_len) % M
        hist_y = hist_y.clone()
        hist_s = hist_s.clone()
        hist_y[idx] = y
        hist_s[idx] = s
        return (hist_y, hist_s, hist_len if full else hist_len + 1,
                (head + 1) % M if full else head)

    def _backtrack(self, loss_fn: LossFn, x, d, g, alphabar, f_old
                   ) -> Tuple[torch.Tensor, int]:
        """Backtracking line search with the negative-step probe; returns
        (step, halvings used)."""
        c1 = 1e-4
        citer = 35
        prodterm = c1 * _dot(g, d)

        def phase(alpha, ci):
            f_new = _value(loss_fn, x + alpha * d)
            while ci < citer and bool(torch.isnan(f_new)
                                      | (f_new > f_old + alpha * prodterm)):
                alpha = 0.5 * alpha
                f_new = _value(loss_fn, x + alpha * d)
                ci += 1
            return alpha, f_new, ci

        alphak, f_new, ci = phase(alphabar, 0)
        if bool(f_old - f_new < torch.abs(prodterm)):
            alphak1, f_new1, ci = phase(-alphabar, ci)
            if bool(f_new1 < f_new):
                alphak = alphak1
        return alphak, ci

    # ------------------------------------------------------------------
    # full-batch cubic strong-Wolfe line search.  phi(a) = loss(x + a*d),
    # phi'(a) = grad(x + a*d) . d, exact from one value-and-grad call.
    # ------------------------------------------------------------------
    def _cubic_interpolate(self, vg_phi, phi, a, b) -> Tuple[torch.Tensor, int]:
        """Cubic minimizer in [a,b] (or [b,a]); returns (alpha, n_evals).

        The reference's quirks: a predicted minimizer ``z0`` inside the
        interval is scored at ``a + z0*(b-a)`` (z0 re-read as a fraction);
        one outside scores ``f0+f1`` so the better endpoint wins; a zero
        denominator gives ``(a+b)/2``."""
        f0, f0d = vg_phi(a)
        f1, f1d = vg_phi(b)
        ab = b - a
        aa = 3.0 * (f0 - f1) / torch.where(ab == 0, torch.ones_like(ab),
                                           ab) + f1d - f0d
        disc = aa * aa - f0d * f1d
        if not bool(disc > 0.0):
            return (a if bool(f0 < f1) else b), 2
        cc = torch.sqrt(disc)
        denom = f1d - f0d + 2.0 * cc
        z0 = b - (f1d + cc - aa) * ab / torch.where(
            denom == 0.0, torch.ones_like(denom), denom)
        hi, lo = torch.maximum(a, b), torch.minimum(a, b)
        if bool((z0 > hi) | (z0 < lo)):
            fz0, ne = f0 + f1, 0
        else:
            fz0, ne = phi(a + z0 * ab), 1
        if bool(denom == 0.0):
            res = 0.5 * (a + b)
        elif bool((f0 < f1) & (f0 < fz0)):
            res = a
        elif bool(f1 < fz0):
            res = b
        else:
            res = z0
        return res, 2 + ne

    def _zoom(self, vg_phi, phi, a, b, phi_0, gphi_0, step
              ) -> Tuple[torch.Tensor, int]:
        """Fletcher zoom on the bracket [a,b]; returns (alphak, n_evals).

        At most 4 rounds; each interpolates in
        [aj+t2*(bj-aj), bj-t3*(bj-aj)], shrinks the bracket on an
        Armijo/monotonicity failure, and otherwise tests the roundoff guard
        ``(aj-alphaj)*phi'_j <= step`` and the strong-Wolfe curvature bound.
        If no step was accepted the last alphaj is returned."""
        sigma, rho = 0.1, 0.01
        t2, t3 = 0.1, 0.5
        aj, bj, alphak, found, ne = a, b, a, False, 0
        for _ in range(4):
            if found:
                break
            p01 = aj + t2 * (bj - aj)
            p02 = bj - t3 * (bj - aj)
            alphaj, ne_i = self._cubic_interpolate(vg_phi, phi, p01, p02)
            phi_j = phi(alphaj)
            phi_aj = phi(aj)
            if bool((phi_j > phi_0 + rho * alphaj * gphi_0)
                    | (phi_j >= phi_aj)):
                bj, ne_g = alphaj, 0
            else:
                _, gphi_j = vg_phi(alphaj)
                found = bool(((aj - alphaj) * gphi_j <= step)
                             | (torch.abs(gphi_j) <= -sigma * gphi_0))
                if bool(gphi_j * (bj - aj) >= 0.0):
                    bj = aj
                aj, ne_g = alphaj, 1
            alphak = alphaj
            ne += ne_i + 2 + ne_g
        return alphak, ne

    def _cubic_search(self, loss_fn: LossFn, x, d, phi_0, gphi_0
                      ) -> Tuple[torch.Tensor, int]:
        """Strong-Wolfe bracketing phase; returns (alphak, n_evals)."""
        c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
        lr = c(self.lr)
        alpha1 = 10.0 * lr
        sigma, rho, t1 = 0.1, 0.01, 9.0
        step = c(1e-6)                  # the zoom's roundoff tolerance

        def vg_phi(alpha):
            v, gg = value_and_grad(loss_fn, x + alpha * d)
            return v, _dot(gg, d)

        def phi(alpha):
            return _value(loss_fn, x + alpha * d)

        tol = torch.minimum(phi_0 * 0.01, c(1e-6))
        mu = (tol - phi_0) / (rho * gphi_0)
        if bool((torch.abs(gphi_0) < 1e-12) | ~torch.isfinite(mu)):
            return c(1.0), 0

        alphai, alphai1, phi_ai1, alphak = alpha1, c(0.0), phi_0, lr
        ne = 0
        for ci in range(1, 4):
            phi_ai = phi(alphai)
            if bool(phi_ai < tol):
                alphak, ne_i, done = alphai, 0, True
            elif bool((phi_ai > phi_0 + alphai * gphi_0)
                      | ((ci > 1) & (phi_ai >= phi_ai1))):  # rho-less
                alphak, ne_i = self._zoom(vg_phi, phi, alphai1, alphai,
                                          phi_0, gphi_0, step)
                done = True
            else:
                _, gphi_i = vg_phi(alphai)
                if bool(torch.abs(gphi_i) <= -sigma * gphi_0):
                    alphak, ne_i, done = alphai, 1, True
                elif bool(gphi_i >= 0.0):
                    alphak, nz = self._zoom(vg_phi, phi, alphai, alphai1,
                                            phi_0, gphi_0, step)
                    ne_i, done = nz + 1, True
                else:
                    if bool(mu <= 2.0 * alphai - alphai1):
                        alphai, alphai1, nei = mu, alphai, 0
                    else:
                        p01 = 2.0 * alphai - alphai1
                        p02 = torch.minimum(
                            mu, alphai + t1 * (alphai - alphai1))
                        # alphai1 intentionally NOT advanced
                        alphai, nei = self._cubic_interpolate(
                            vg_phi, phi, p01, p02)
                    phi_ai1, ne_i, done = phi_ai, nei + 1, False
            ne += 1 + ne_i
            if done:
                break
        return alphak, ne

    # ------------------------------------------------------------------
    def step(self, loss_fn: LossFn, x: torch.Tensor, state: LBFGSState
             ) -> Tuple[torch.Tensor, LBFGSState, torch.Tensor]:
        """One optimization step; returns (x, state, loss of the first
        closure call)."""
        lm0 = 1e-6
        lr = torch.tensor(self.lr, dtype=x.dtype, device=x.device)

        loss0, g0 = value_and_grad(loss_fn, x)
        abs_sum0 = torch.sum(torch.abs(g0))
        grad_nrm = torch.linalg.vector_norm(g0)     # step-entry norm
        # alphabar resets to lr at every step entry; the running mean and
        # variance persist across steps
        st = state._replace(func_evals=state.func_evals + 1, alphabar=lr)

        g, loss, abs_sum = g0, loss0, abs_sum0
        n_iter, evals = 0, 1
        done = bool(abs_sum0 <= self.tolerance_grad)
        nan_nrm = bool(torch.isnan(grad_nrm))
        while n_iter < self.max_iter and not done and not nan_nrm:
            n_iter += 1
            total = st.n_iter_total + 1
            first = total == 1

            if first:
                d = -g
                hy, hs = torch.zeros_like(st.hist_y), torch.zeros_like(st.hist_s)
                hl, hh = 0, 0
                H_diag = torch.ones_like(st.H_diag)
                avg = torch.zeros_like(st.running_avg)
                avg_sq = torch.zeros_like(st.running_avg_sq)
                alphabar = st.alphabar
            else:
                s = st.d * st.t
                y = g - st.prev_grad
                if self.batch_mode:
                    y = y + lm0 * s                     # trust region
                ys = _dot(y, s)
                sn2 = _dot(s, s)
                batch_changed = self.batch_mode and n_iter == 1
                if batch_changed:
                    g_old = g - st.running_avg
                    avg = st.running_avg + g_old / total
                    g_new = g - avg
                    avg_sq = st.running_avg_sq + g_new * g_old
                    alphabar = 1.0 / (1.0 + torch.sum(avg_sq)
                                      / ((total - 1) * grad_nrm))
                else:
                    avg, avg_sq = st.running_avg, st.running_avg_sq
                    alphabar = st.alphabar
                hy, hs, hl, hh, H_diag = (st.hist_y, st.hist_s, st.hist_len,
                                          st.hist_head, st.H_diag)
                if not batch_changed and bool(ys > 1e-10 * sn2):
                    hy, hs, hl, hh = self._push(hy, hs, hl, hh, y, s)
                    H_diag = ys / _dot(y, y)
                d = self._two_loop(g, hy, hs, hl, hh, H_diag)

            prev_grad, prev_loss = g, loss
            if first:
                t = torch.minimum(torch.ones_like(abs_sum), 1.0 / abs_sum) * lr
            else:
                t = lr
            gtd = _dot(g, d)
            n_ls = 0
            if self.line_search_fn:
                # the line search sets the step; a NaN step falls back to lr
                if self.batch_mode:
                    t, n_ls = self._backtrack(loss_fn, x, d, g, alphabar,
                                              loss)
                else:
                    t, n_ls = self._cubic_search(loss_fn, x, d, loss, gtd)
                if bool(torch.isnan(t)):
                    t = lr
            x = x + t * d

            re = 0
            if n_iter != self.max_iter:                 # re-evaluate
                loss, g = value_and_grad(loss_fn, x)
                abs_sum = torch.sum(torch.abs(g))
                re = 1
            evals += re

            done = bool(torch.isnan(abs_sum)
                        | (abs_sum <= self.tolerance_grad)
                        | (gtd > -self.tolerance_change)
                        | (torch.sum(torch.abs(t * d)) <= self.tolerance_change)
                        | (torch.abs(loss - prev_loss) < self.tolerance_change)
                        ) or evals >= self._max_eval()

            st = LBFGSState(
                n_iter_total=total, func_evals=st.func_evals + re + n_ls,
                d=d, t=t, hist_y=hy, hist_s=hs, hist_len=hl, hist_head=hh,
                H_diag=H_diag, prev_grad=prev_grad, prev_loss=prev_loss,
                running_avg=avg, running_avg_sq=avg_sq, alphabar=alphabar)
        return x, st, loss0
