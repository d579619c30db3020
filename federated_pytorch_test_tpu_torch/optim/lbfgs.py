"""Stochastic L-BFGS on a flat parameter vector, batch mode with the
backtracking line search.

Port of ``federated_pytorch_test_tpu/optim/lbfgs.py`` (``LBFGSNew`` with
``batch_mode=True, line_search_fn=True`` — the configuration the CPC
trainer uses; the full-batch cubic strong-Wolfe search is not ported yet).
The JAX ``lax.while_loop`` / ``lax.cond`` become Python control flow that
reads scalars with ``.item()``; the constants and quirks are the JAX
package's (reference lbfgsnew.py):

  * trust region ``y += 1e-6 * s``;
  * batch change detected at the first inner iteration of every step after
    the first, feeding the online inter-batch gradient mean/variance and
    the max step ``alphabar = 1/(1 + Var/((n-1)*|g|))``, with ``|g|`` the
    gradient norm at step entry;
  * curvature pairs stored only when ``ys > 1e-10*|s|^2`` and the batch did
    not change, in a circular buffer of ``history_size`` slots;
  * backtracking with Armijo c1=1e-4 and at most 35 halvings shared by the
    positive phase and the negative-step probe;
  * ``step`` returns the loss of its first closure call.

The closure is ``loss_fn(x) -> scalar tensor``, differentiable in ``x``.
Line-search trials evaluate it under ``torch.no_grad()`` (loss only).
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
    """Stochastic L-BFGS, batch mode, backtracking line search.

    Usage::

        opt = LBFGSNew(history_size=7, max_iter=2)
        state = opt.init(x0)
        x, state, loss = opt.step(loss_fn, x, state)
    """

    lr: float = 1.0
    max_iter: int = 10
    max_eval: Optional[int] = None
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    history_size: int = 7

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
                y = g - st.prev_grad + lm0 * s          # trust region
                ys = _dot(y, s)
                sn2 = _dot(s, s)
                batch_changed = n_iter == 1             # and total > 1
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
            gtd = _dot(g, d)
            # the line search sets the step; a NaN step falls back to lr
            t, n_ls = self._backtrack(loss_fn, x, d, g, alphabar, loss)
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
