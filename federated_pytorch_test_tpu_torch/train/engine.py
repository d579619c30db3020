"""Blockwise-federated classifier engine: the consensus round.

Port of ``BlockwiseFederatedTrainer`` of
``federated_pytorch_test_tpu/train/engine.py`` with every knob off apart
from the robust aggregation (``robust_agg``, ``robust_chunked``).  The loop
nest of the reference is kept::

    Nloop (sweeps over the net) -> L blocks -> Nadmm (comm rounds)
      -> Nepoch (local epochs) -> K clients -> minibatches

Per block: a fresh consensus ``z`` of zeros, fresh duals ``y`` and a fresh
Adam state per client.  A local epoch trains only the active block, as a
flat vector in the JAX element order: Adam (optax's update, written out) on
the gradient of the classifier loss plus the algorithm's penalty.  The
comm step gathers the ``[K, N]`` stack, runs the algorithm's global update
through the (robust) mean over the client mesh, and writes ``z`` back for
FedAvg.  The K clients are a loop on one device (the JAX ``vmap``); each
keeps its own parameters, BatchNorm statistics, data and normalisation.

Epoch data is built on the host from the counter-keyed seed of the JAX
engine (``_epoch_seed``) and staged per epoch, the next epoch prepared on a
one-worker pool meanwhile.  The JAX engine's device-resident permutation
gather draws ``jax.random`` and has no counterpart here: parity runs pin
``device_data=False`` on the JAX side.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.base import BlockModule
from federated_pytorch_test_tpu_torch.ops import gram
from federated_pytorch_test_tpu_torch.parallel.comm import make_robust_mean
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    ClientMesh,
    usable_device_count,
)
from federated_pytorch_test_tpu_torch.train.algorithms import (
    Algorithm,
    BBConfig,
    bb_rho_update,
)
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.losses import (
    accuracy_count,
    cross_entropy,
    l1_l2,
)
from federated_pytorch_test_tpu_torch.utils import blocks as blocklib
from federated_pytorch_test_tpu_torch.utils import codec
from federated_pytorch_test_tpu_torch.utils.device import resolve_device
from federated_pytorch_test_tpu_torch.utils.tree import tree_map, tree_stack

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class ClientState(NamedTuple):
    """Per-client training state, stacked on the leading K dimension:
    parameters and BatchNorm statistics (nested dicts of [K, ...] tensors,
    PyTorch layout) and the active block's Adam state."""

    params: Any
    batch_stats: Any
    opt_state: Any = None


class AdamState(NamedTuple):
    """optax.adam's state over the active block's flat vectors."""

    mu: torch.Tensor       # [K, N]
    nu: torch.Tensor       # [K, N]
    count: int


def adam_step(x, g, mu, nu, count: int, lr: float):
    """One optax.adam update of the flat vector ``x``: the same formula in
    the same order (moments, bias corrections in float32, ``mu_hat /
    (sqrt(nu_hat) + eps)``, times ``-lr``).  Returns (x, mu, nu)."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    one = torch.ones((), dtype=torch.float32, device=x.device)
    bc1 = one - (one * ADAM_B1) ** count
    bc2 = one - (one * ADAM_B2) ** count
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    return x + u * (-lr), mu, nu


def _normalize_u8(x_u8: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Device-side ToTensor + Normalize of NHWC uint8 images with the
    client's [2, 3] (mean, std), returned NCHW."""
    x = x_u8.to(torch.float32) / 255.0
    return ((x - norm[0]) / norm[1]).permute(0, 3, 1, 2)


class BlockwiseFederatedTrainer:
    """The classifier engine of the consensus, FedAvg and FedProx drivers,
    on its default path (knobs off) with optional robust aggregation."""

    def __init__(self, model: BlockModule, cfg: FederatedConfig,
                 data: FederatedCifar10, algorithm: Algorithm):
        if cfg.optimizer != "adam":
            raise NotImplementedError(
                f"optimizer={cfg.optimizer!r} is not ported yet (the "
                "classifier's L-BFGS is queued in ROADMAP.md); use 'adam'")
        self.model = model
        self.cfg = cfg
        self.data = data
        self.algo = algorithm
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            # float32 means float32: cuDNN runs float32 convolutions in
            # TF32 by default; matmuls are pinned to full float32 as well
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.order = model.param_order()
        self.block_ids = model.train_order_block_ids()
        self.linear_ids = model.linear_layer_ids()
        self.L = len(self.block_ids)

        K = cfg.K
        self.mesh = ClientMesh(usable_device_count(K) if cfg.num_devices is None
                               else cfg.num_devices)
        self.D = self.mesh.size
        if K % self.D:
            raise ValueError(f"K={K} not divisible by device count {self.D}")
        self.K_local = K // self.D
        self.mean_fn = make_robust_mean(
            cfg.robust_agg, trim_frac=cfg.trim_frac, clip_mult=cfg.clip_mult,
            chunked=cfg.robust_chunked, mesh=self.mesh)

        # common init: every client starts from the same weights (drawn on
        # a CPU generator, so they do not depend on the device)
        gen = torch.Generator().manual_seed(cfg.init_seed)
        params, batch_stats = model.init_variables(gen, cfg.init_model)
        self.has_bn = bool(batch_stats)
        stack = lambda t: (t.unsqueeze(0).expand(K, *t.shape).contiguous()
                           .to(self.device))
        self.params0 = tree_map(stack, params)
        self.batch_stats0 = tree_map(stack, batch_stats)

        xt, yt, wt = data.test_batches_raw()
        self.test_x = torch.from_numpy(np.ascontiguousarray(xt)).to(self.device)
        self.test_y = torch.from_numpy(yt).to(self.device)
        self.test_w = torch.from_numpy(wt).to(self.device)
        self.test_n = int(wt.sum())
        self.client_norm = torch.from_numpy(
            np.asarray(data.norm_stats, np.float32)).to(self.device)

        self._epochs_staged = 0
        self._pending: Optional[tuple] = None
        self._stage_pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="epoch-stage")
            if cfg.prefetch else None)

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def mask_for_block(self, ci: int):
        return blocklib.build_mask(
            self.params0, blocklib.block_paths(self.order, self.block_ids[ci]))

    def block_size(self, ci: int) -> int:
        one = tree_map(lambda t: t[0], self.params0)
        return codec.masked_size(one, self.order, self.mask_for_block(ci))

    def reg_for_block(self, ci: int):
        """(lambda1, lambda2) on the flat vector — the reference quirk: the
        *block* index is tested against the fc parameter ids
        (federated_multi.py:183)."""
        if ci in self.linear_ids:
            return (self.cfg.lambda1, self.cfg.lambda2)
        return (0.0, 0.0)

    def init_state(self) -> ClientState:
        """A fresh training state: a copy of the common init."""
        return ClientState(tree_map(torch.clone, self.params0),
                           tree_map(torch.clone, self.batch_stats0))

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _epoch_seed(self, counter: int, stream: int) -> int:
        """Seed of epoch ``counter`` (the JAX engine's: numpy
        ``default_rng([seed, counter, stream])``)."""
        return int(np.random.default_rng(
            [self.cfg.seed, counter, stream]).integers(2**31))

    def _host_epoch(self, counter: int):
        """Host-side shuffle + gather of epoch ``counter``."""
        return self.data.epoch_batches_raw(self._epoch_seed(counter, 0))

    def _stage_epoch(self, last: bool = False):
        """Device arrays (xb, yb, wb) of the next epoch; submits the one
        after it to the stage pool unless this is the run's last."""
        c = self._epochs_staged
        self._epochs_staged += 1
        if self._pending is not None and self._pending[0] == c:
            xb, yb, wb = self._pending[1].result()
        else:
            xb, yb, wb = self._host_epoch(c)
        self._pending = None
        if self._stage_pool is not None and not last:
            self._pending = (c + 1,
                             self._stage_pool.submit(self._host_epoch, c + 1))
        dev = self.device
        return (torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev),
                torch.from_numpy(wb).to(dev))

    def close(self) -> None:
        """Release the stage pool (a pending prefetch is dropped)."""
        self._pending = None
        if self._stage_pool is not None:
            self._stage_pool.shutdown(wait=True)
            self._stage_pool = None

    # ------------------------------------------------------------------
    # the local epoch and the comm step
    # ------------------------------------------------------------------
    def model_loss(self, p, bs, xb, yb, wb):
        """Per-batch classifier loss -> (scalar, new batch_stats).  The pad
        rows of the last partial minibatch (weight 0) are out of the loss
        and, unless the data has no partial batch, out of the BN stats."""
        bn_w = None if getattr(self.data, "remainder", 1) == 0 else wb
        logits, new_bs = self.model.apply(p, bs, xb, train=True,
                                          sample_weight=bn_w)
        return cross_entropy(logits, yb, wb), new_bs

    def train_epoch(self, state: ClientState, ci: int, y, z, rho, xb, yb, wb):
        """One local epoch of every client on block ``ci``; returns the new
        state and the [K] per-client sums of the step losses."""
        cfg, algo = self.cfg, self.algo
        order, mask = self.order, self.mask_for_block(ci)
        lam1, lam2 = self.reg_for_block(ci)
        reg_on = lam1 != 0.0 or lam2 != 0.0
        opt: AdamState = state.opt_state
        X = codec.get_trainable_stack(state.params, order, mask)
        xs, mus, nus, bss, losses = [], [], [], [], []
        for k in range(cfg.K):
            pk = tree_map(lambda t: t[k], state.params)
            bsk = tree_map(lambda t: t[k], state.batch_stats)
            xk, mu, nu = X[k], opt.mu[k], opt.nu[k]
            step_losses = []
            for step in range(xb.shape[1]):
                v = xk.detach().requires_grad_(True)
                p = codec.put_trainable_values(pk, order, mask, v)
                loss, new_bs = self.model_loss(
                    p, bsk, _normalize_u8(xb[k, step], self.client_norm[k]),
                    yb[k, step], wb[k, step])
                loss = loss + algo.penalty(v, z, y[k], rho)
                if reg_on:
                    loss = loss + l1_l2(v, lam1, lam2)
                (g,) = torch.autograd.grad(loss, v)
                with torch.no_grad():
                    xk, mu, nu = adam_step(xk, g, mu, nu, opt.count + step + 1,
                                           cfg.lr)
                bsk = new_bs
                step_losses.append(loss.detach())
            xs.append(xk)
            mus.append(mu)
            nus.append(nu)
            bss.append(bsk)
            losses.append(torch.stack(step_losses).sum())
        params = codec.put_trainable_stack(state.params, order, mask,
                                           torch.stack(xs))
        batch_stats = tree_stack(bss) if self.has_bn else state.batch_stats
        opt = AdamState(torch.stack(mus), torch.stack(nus),
                        opt.count + xb.shape[1])
        return ClientState(params, batch_stats, opt), torch.stack(losses)

    def _comm_mode(self, nadmm: int) -> str:
        """plain | bb_store (round 0 of a block) | bb (every bb_period_T
        rounds) — consensus_multi.py:242-278."""
        cfg = self.cfg
        if cfg.bb_update and nadmm == 0:
            return "bb_store"
        if cfg.bb_update and nadmm > 0 and nadmm % cfg.bb_period_T == 0:
            return "bb"
        return "plain"

    def comm_round(self, state: ClientState, ci: int, z, y, rho, x0, yhat0,
                   mode: str = "plain"):
        """The full-participation communication round of block ``ci``."""
        cfg = self.cfg
        order, mask = self.order, self.mask_for_block(ci)
        x = codec.get_trainable_stack(state.params, order, mask)
        if mode == "bb_store":
            x0 = x
        elif mode == "bb":
            rho, x0, yhat0 = bb_rho_update(
                x, z, y, rho, x0, yhat0,
                BBConfig(cfg.bb_period_T, cfg.bb_alphacorrmin,
                         cfg.bb_epsilon, cfg.bb_rhomax))
        znew, ynew, diag = self.algo.global_update(
            x, z, y, rho, cfg.K, self.mesh, w=None, mean_fn=self.mean_fn)
        params = state.params
        if self.algo.writeback:
            params = codec.put_trainable_stack(
                params, order, mask, znew.unsqueeze(0).expand(cfg.K, -1))
        return (ClientState(params, state.batch_stats, state.opt_state),
                znew, ynew, rho, x0, yhat0, diag)

    @torch.no_grad()
    def evaluate(self, state: ClientState) -> np.ndarray:
        """Per-client top-1 accuracy (%) over the whole test set (the
        wrap-pad rows weighted out)."""
        totals = []
        for k in range(self.cfg.K):
            pk = tree_map(lambda t: t[k], state.params)
            bsk = tree_map(lambda t: t[k], state.batch_stats)
            acc = torch.zeros((), dtype=torch.float32, device=self.device)
            for b in range(self.test_x.shape[0]):
                logits, _ = self.model.apply(
                    pk, bsk, _normalize_u8(self.test_x[b], self.client_norm[k]),
                    train=False)
                acc = acc + accuracy_count(logits, self.test_y[b],
                                           self.test_w[b])
            totals.append(acc)
        return 100.0 * torch.stack(totals).cpu().numpy() / self.test_n

    def round_bytes_on_wire(self, N: int, n_active: int) -> int:
        """Uplink bytes of a round: every participant ships its float32
        block."""
        return int(n_active) * 4 * int(N)

    # ------------------------------------------------------------------
    # the loop nest
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, state: Optional[ClientState] = None,
            log: Callable[[str], None] = print):
        """Nloop x blocks x Nadmm rounds; returns (state, history), one
        record per communication round."""
        try:
            return self._run(state, log)
        finally:
            self.close()

    def _run(self, state, log):
        cfg, algo = self.cfg, self.algo
        K, dev = cfg.K, self.device
        state = state or self.init_state()
        history: List[Dict[str, Any]] = []
        f32 = dict(dtype=torch.float32, device=dev)
        for nloop in range(cfg.Nloop):
            for ci in range(self.L):
                N = self.block_size(ci)
                z = torch.zeros(N, **f32)
                y = torch.zeros(K, N if algo.needs_dual else 1, **f32)
                rho = torch.tensor(cfg.admm_rho0, **f32)
                x0 = torch.zeros(K, N if cfg.bb_update else 1, **f32)
                yhat0 = (codec.get_trainable_stack(
                    state.params, self.order, self.mask_for_block(ci))
                    if cfg.bb_update else torch.zeros(K, 1, **f32))
                state = ClientState(state.params, state.batch_stats,
                                    AdamState(torch.zeros(K, N, **f32),
                                              torch.zeros(K, N, **f32), 0))
                for nadmm in range(cfg.Nadmm):
                    t_round = time.perf_counter()
                    launches0 = dict(gram.LAUNCHES)
                    loss_acc = None
                    stage_s = 0.0
                    for nepoch in range(cfg.Nepoch):
                        t_stage = time.perf_counter()
                        xb, yb, wb = self._stage_epoch(
                            last=(nloop == cfg.Nloop - 1 and ci == self.L - 1
                                  and nadmm == cfg.Nadmm - 1
                                  and nepoch == cfg.Nepoch - 1))
                        stage_s += time.perf_counter() - t_stage
                        state, losses = self.train_epoch(
                            state, ci, y, z, rho, xb, yb, wb)
                        loss_acc = (losses if loss_acc is None
                                    else loss_acc + losses)
                    self._sync()
                    t_comm = time.perf_counter()
                    train_s = t_comm - t_round - stage_s
                    diag: Dict[str, Any] = {}
                    if algo.communicates:
                        state, z, y, rho, x0, yhat0, diag = self.comm_round(
                            state, ci, z, y, rho, x0, yhat0,
                            self._comm_mode(nadmm))
                        diag = {k: float(v) for k, v in diag.items()}
                    self._sync()
                    comm_s = time.perf_counter() - t_comm
                    loss_host = loss_acc.cpu().numpy()
                    rec = dict(nloop=nloop, block=ci, nadmm=nadmm, N=N,
                               loss=float(np.sum(loss_host)), rho=float(rho),
                               round_seconds=time.perf_counter() - t_round,
                               stage_seconds=stage_s, train_seconds=train_s,
                               comm_seconds=comm_s, **diag)
                    rec["kernel_launches"] = {
                        k: v - launches0[k] for k, v in gram.LAUNCHES.items()}
                    if algo.communicates:
                        rec["bytes_on_wire"] = self.round_bytes_on_wire(N, K)
                    if cfg.check_results:
                        rec["accuracy"] = self.evaluate(state)
                    history.append(rec)
                    blk = self.block_ids[ci]
                    msg = (f"block=[{blk[0]},{blk[1]}]({N},{float(rho):f}) "
                           f"round={nadmm}/{nloop} "
                           + " ".join(f"{k}={v:e}" for k, v in diag.items()))
                    if cfg.check_results:
                        msg += " acc=" + np.array2string(rec["accuracy"],
                                                         precision=2)
                    log(msg)
        return state, history
