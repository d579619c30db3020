"""Federated CPC trainer (reference federated_cpc.py).

Port of ``federated_pytorch_test_tpu/train/cpc_engine.py``.  Three
sub-models (encoder / contextgen / predictor) train in rotation: for each
block of each sub-model, a fresh consensus ``z`` of zeros and a fresh
L-BFGS state per client; each communication round runs ``Niter``
minibatches per client through L-BFGS, then FedAvg of the block,
``dual = |z - z_new| / N`` and the write-back of ``z_new`` into every
client.  The L-BFGS state persists across the ``Nadmm`` rounds of a block.

On one card the K clients are the leading dimension of every parameter
tensor, and local training is a loop over clients (the JAX ``vmap``; a
batched ``while_loop`` keeps each finished client's carry, so the values
are the same).  Each closure evaluates its sub-model at a flat block vector
with ``torch.func.functional_call``; the frozen prefix of the pipeline is
computed once per minibatch, outside the closure.  The InfoNCE tail runs
the CUDA kernels of ``ops/infonce.py``.

The trainer composes the round kernel of ``train/rounds.py``, as the
classifier engine does.  With every robustness knob off the round is the
one above.  Partial participation, injected faults, a soak campaign, the
update guard, async rounds or a robust estimator build the robust round
instead (the JAX trainer builds it for a campaign only with one of the
other knobs, and otherwise counts the campaign's draws without applying
them):
stragglers and async non-dispatchers keep their round-start block and
their L-BFGS state bit for bit (they do not train: their draws are keyed
on (seed, round, client), so nothing shifts), corruption hits the wire at
``z + corrupt(x - z)``, the guard rejects by where-selects, aggregation
goes through the algorithm's ``_agg`` chokepoint (weighted, or the robust
estimator over the client mesh of ``cfg.num_devices`` shards), an
all-rejected round keeps z, and only the accepted participants receive
z_new (async dispatchers keep their freshly trained block).  The draws key
on the block's flat index across the rotation, as in JAX.

``run(checkpoint_path=...)`` saves a mid-run checkpoint after every round
(the three sub-models, and mid-block z and every client's L-BFGS state,
with the loop counters, the consumed round count and the kernel's
ledgers); ``resume=True`` continues from the newest usable slot, bit for
bit the uninterrupted run.  Every run opens the obs recorder of
``cfg.obs_dir`` (a ``round`` and a ``client`` record a round, the stage
and compute spans), with the health watchdog and the control plane on the
same records; ``cfg.profile_dir`` traces the run with ``torch.profiler``.
The trainer has no serving adapter: a run with ``serve_spec`` raises "no
serving adapter" at its first serving tick, as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from federated_pytorch_test_tpu_torch.analysis import sanitize
from federated_pytorch_test_tpu_torch.data.lofar import (
    CPCDataSource,
    RoundPrefetcher,
)
from federated_pytorch_test_tpu_torch.models.base import module_state
from federated_pytorch_test_tpu_torch.models.cpc import (
    ContextgenCNN,
    EncoderCNN,
    PredictorCNN,
)
from federated_pytorch_test_tpu_torch.ops import gram, infonce
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew
from federated_pytorch_test_tpu_torch.parallel.comm import (
    federated_mean,
    make_robust_mean,
)
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    ClientMesh,
    usable_device_count,
)
from federated_pytorch_test_tpu_torch.train.algorithms import FedAvg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.faults import apply_corruption
from federated_pytorch_test_tpu_torch.train.rounds import RoundKernel
from federated_pytorch_test_tpu_torch.utils import blocks as blocklib
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils import codec
from federated_pytorch_test_tpu_torch.utils.device import resolve_device
from federated_pytorch_test_tpu_torch.utils.initializers import init_weights
from federated_pytorch_test_tpu_torch.utils.profiling import (
    profile_ctx,
    round_trace,
)
from federated_pytorch_test_tpu_torch.utils.tree import (
    get_by_path,
    leaves,
    map_leaves,
    set_by_path,
    tree_map,
    unflatten_like,
)

SUBMODELS = ("encoder", "contextgen", "predictor")

#: stacked client state: {sub-model: {module: {"kernel"|"bias": [K, ...]}}}
CPCState = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def client_params(state: CPCState, k: int) -> CPCState:
    """Client ``k``'s parameters (views into the stacked state)."""
    return {m: tree_map(lambda t: t[k], state[m]) for m in SUBMODELS}


def _sel(w: torch.Tensor, new, old):
    """Per-leaf ``where(w_k > 0, new, old)`` over the client axis."""
    def pick(a, b):
        m = w.reshape((-1,) + (1,) * (a.dim() - 1)) > 0
        return torch.where(m, a, b)
    return map_leaves(pick, new, old)


class CPCTrainer(RoundKernel):
    """Rotating 3-sub-model federated CPC."""

    #: engine tag of the obs records
    obs_engine: str = "cpc"
    #: the obs stream's run name (the JAX trainer's default; the driver
    #: sets its program's name)
    obs_run_name: Optional[str] = "cpc_admm"

    def __init__(self, data: CPCDataSource, latent_dim: int = 256,
                 reduced_dim: int = 32, lbfgs_history: int = 7,
                 lbfgs_max_iter: int = 2, Niter: int = 10,
                 cfg: Optional[FederatedConfig] = None):
        self.data = data
        # the data source defines the federation: one client per (file, SAP)
        self.cfg = cfg = dataclasses.replace(cfg or FederatedConfig(),
                                             K=data.K)
        self.K = data.K
        self.Niter = Niter
        # CPC is FedAvg with write-back by construction; the robust round
        # aggregates through its _agg chokepoint
        self.algo = FedAvg()
        if cfg.compress != "none":
            raise ValueError(
                "the CPC engine has no compression path (--compress none "
                "only); its wire format is the dense f32 block vector")
        if cfg.fused_collective or cfg.sharded_update:
            raise ValueError(
                "fused_collective/sharded_update are classifier-engine "
                "comm paths; the CPC round has no fused reduction")
        if cfg.bb_update:
            raise ValueError(
                "bb_update is ADMM-specific (consensus rho adaptation); "
                "the CPC round is plain FedAvg")
        if not 0.0 < cfg.participation <= 1.0:
            raise ValueError(
                f"participation={cfg.participation} must be in (0, 1]")
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            # float32 means float32: cuDNN runs float32 convolutions in TF32
            # by default (about three decimal digits); matmuls are full
            # float32 by default, pinned here all the same
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._ckpt_writer = None
        # --sanitize: the checked rounds' carried error (None: no mode)
        self._sanitizer = (sanitize.Sanitizer(self.device) if cfg.sanitize
                           else None)
        self._sanitize_label = ""
        self._init_round_kernel()
        self._validate_round_cfg()
        # the robust round is built only when a knob needs it; otherwise
        # the round is slice 1's.  A campaign needs it: its windows mask
        # and poison clients per round
        self._robust_round = (self.faults.enabled
                              or self.campaign is not None
                              or cfg.participation < 1.0
                              or cfg.async_rounds or cfg.update_guard
                              or cfg.robust_agg != "none")
        self.mesh = ClientMesh(usable_device_count(self.K)
                               if cfg.num_devices is None
                               else cfg.num_devices)
        self.D = self.mesh.size
        if self.K % self.D:
            raise ValueError(f"K={self.K} not divisible by {self.D} devices")
        self.mean_fn = make_robust_mean(
            cfg.robust_agg, trim_frac=cfg.trim_frac, clip_mult=cfg.clip_mult,
            chunked=cfg.robust_chunked, mesh=self.mesh)
        self.models = {
            "encoder": EncoderCNN(latent_dim),
            "contextgen": ContextgenCNN(latent_dim),
            "predictor": PredictorCNN(latent_dim, reduced_dim),
        }
        for m in self.models.values():
            m.to(self.device).requires_grad_(False)
        self.lbfgs = LBFGSNew(history_size=lbfgs_history,
                              max_iter=lbfgs_max_iter, batch_mode=True,
                              line_search_fn=True)
        # common init (the reference seeds all K clients identically); a
        # CPU generator, so the weights do not depend on the device
        gen = torch.Generator().manual_seed(cfg.init_seed)
        self.state0: CPCState = {}
        for name in SUBMODELS:
            tree = init_weights(self.models[name].param_tree(), gen)
            self.state0[name] = tree_map(
                lambda t: t.unsqueeze(0).expand(self.K, *t.shape).contiguous(),
                tree)
        # (px, py) of the round in flight, for the mid-run checkpoint
        self._cur_pxpy = (0, 0)
        # the corruption each (model, block, px, py) round applies
        # (_round_corruption)
        self._corruption_cache: Dict[tuple, Any] = {}

    # ------------------------------------------------------------------
    def block(self, mdl: str, ci: int):
        """(order, mask, N) of block ``ci`` of sub-model ``mdl``."""
        model = self.models[mdl]
        order = model.param_order()
        one = tree_map(lambda t: t[0], self.state0[mdl])
        mask = blocklib.build_mask(
            one, blocklib.block_paths(order, model.train_order_block_ids()[ci]))
        return order, mask, codec.masked_size(one, order, mask)

    def _apply(self, mdl: str, tree, *args):
        return functional_call(self.models[mdl], module_state(tree), args)

    def _encode_grid(self, enc_p, y, px: int, py: int) -> torch.Tensor:
        """Encoder -> [B, latent, px, py] NCHW grid (patch rows are
        baseline-major: row = b*px*py + x*py + y)."""
        latents = self._apply("encoder", enc_p, y)
        B = y.shape[0] // (px * py)
        return latents.reshape(B, px, py, -1).permute(0, 3, 1, 2).contiguous()

    def _predict_loss(self, pred_p, grid, context, impl) -> torch.Tensor:
        reduced, pred = self._apply("predictor", pred_p, grid, context)
        return infonce.info_nce_fused(reduced, pred, impl)

    def block_loss(self, mdl: str, order, mask, params: CPCState,
                   y: torch.Tensor, px: int, py: int,
                   impl: infonce.InfoNCEImpl = infonce.KERNELS
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
        """``flat_loss(v)``: the CPC loss of one client's minibatch ``y``
        ([B*px*py, 8, patch, patch] NCHW) with block ``mask`` of sub-model
        ``mdl`` set to the flat vector ``v``.  The frozen prefix of the
        pipeline is computed here, once, not in every closure call."""
        enc_p, ctx_p, pred_p = (params[m] for m in SUBMODELS)
        sub = params[mdl]

        def put(v):
            return codec.put_trainable_values(sub, order, mask, v)

        if mdl == "encoder":
            def flat_loss(v):
                grid = self._encode_grid(put(v), y, px, py)
                return self._predict_loss(
                    pred_p, grid, self._apply("contextgen", ctx_p, grid), impl)
            return flat_loss
        with torch.no_grad():
            grid = self._encode_grid(enc_p, y, px, py)
            if mdl == "contextgen":
                def flat_loss(v):
                    return self._predict_loss(
                        pred_p, grid, self._apply("contextgen", put(v), grid),
                        impl)
                return flat_loss
            context = self._apply("contextgen", ctx_p, grid)

        def flat_loss(v):
            return self._predict_loss(put(v), grid, context, impl)
        return flat_loss

    def stage(self, batch) -> torch.Tensor:
        """Host round batch [K, Niter, nb, patch, patch, 8] NHWC -> device
        [K, Niter, nb, 8, patch, patch] NCHW (converted on the device)."""
        return (torch.from_numpy(batch).to(self.device)
                .permute(0, 1, 2, 5, 3, 4).contiguous())

    def round_bytes_on_wire(self, N: int, n_active) -> int:
        """The dense float32 block from each of ``n_active`` clients."""
        return 4 * N * int(n_active)

    def init_opt(self, state: CPCState, mdl: str, order, mask) -> list:
        """A fresh L-BFGS state per client at its block vector."""
        return [self.lbfgs.init(codec.get_trainable_values(
            client_params(state, k)[mdl], order, mask))
            for k in range(self.K)]

    # ------------------------------------------------------------------
    def run(self, Nloop: int = 1, Nadmm: int = 1,
            state: Optional[CPCState] = None,
            log: Callable[[str], None] = print, prefetch: bool = True,
            checkpoint_path: Optional[str] = None, resume: bool = False):
        """The rotation loop (federated_cpc.py:194-304); returns
        (final stacked state, one history record per round).

        ``prefetch`` builds round n+1's host batch on a background thread
        while round n trains; the draws are keyed on (seed, round, client),
        so the data is the same either way.  ``checkpoint_path``: save a
        mid-run checkpoint after every round (on a writer thread under
        ``cfg.async_checkpoint``); ``resume``: continue from its newest
        usable slot, if one exists.
        """
        self.cfg = dataclasses.replace(self.cfg, Nloop=Nloop, Nadmm=Nadmm,
                                       prefetch=bool(prefetch))
        try:
            with profile_ctx(self.cfg.profile_dir, self.device):
                return self._run(Nloop, Nadmm, state, log, prefetch,
                                 checkpoint_path, resume)
        except BaseException:
            try:                 # the error that ended the run wins
                self._flush_ckpt_writer()
            except Exception:
                pass
            if self.obs_recorder is not None:
                self.obs_recorder.close(status="aborted")
            raise

    def _flush_ckpt_writer(self) -> None:
        """Write barrier: wait for queued async saves, retire the writer
        (re-raises a background failure)."""
        writer, self._ckpt_writer = self._ckpt_writer, None
        if writer is not None:
            writer.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launch_counts(self) -> Dict[str, int]:
        """The launch counters of the kernels this trainer's round runs:
        InfoNCE, and the Gram under a robust estimator."""
        counts = dict(infonce.LAUNCHES)
        if self.mean_fn is not None:
            counts.update(gram.LAUNCHES)
        return counts

    def _run(self, Nloop, Nadmm, state, log, prefetch, checkpoint_path,
             resume):
        cfg = self.cfg
        state = self.state0 if state is None else state
        history: List[Dict[str, Any]] = []
        resume_at = r_z = r_opt = None
        if resume and checkpoint_path is not None:
            restored = self._resume(checkpoint_path, log)
            if restored is not None:
                state, r_z, r_opt, resume_at, history = restored
        restored = resume_at is not None
        # one-shot preemption: a resumed segment replaying the drawn round
        # must not fire again
        self._preempt_armed = not restored
        self._campaign_resume_floor(restored, len(history))
        # size the producer by the rounds that remain
        n_rounds = 0
        for nl in range(Nloop):
            for mi, m in enumerate(SUBMODELS):
                for c in range(len(self.models[m].train_order_block_ids())):
                    if restored and (nl, mi, c) < resume_at[:3]:
                        continue
                    start = (resume_at[3] if restored and resume_at[4]
                             and (nl, mi, c) == resume_at[:3] else 0)
                    n_rounds += max(0, Nadmm - start)
        if restored and n_rounds == 0:
            log("resumed a COMPLETED run: no rounds remain at "
                f"Nloop={Nloop} Nadmm={Nadmm}; returning the saved history")
        if cfg.async_checkpoint and checkpoint_path is not None:
            self._ckpt_writer = ckpt.AsyncCheckpointWriter()
        obs = self._open_obs(resumed=restored, rounds_prior=len(history))
        if obs.control is not None:
            obs.control.can_restart = checkpoint_path is not None
        # the seeded draws key on the block's flat index across the
        # rotation: two blocks of different sub-models never share one
        blocks_per = [len(self.models[m].train_order_block_ids())
                      for m in SUBMODELS]
        profile_on = cfg.profile_dir is not None
        src = (RoundPrefetcher(self.data, self.Niter, n_rounds)
               if prefetch and n_rounds > 0 else None)
        try:
            for nloop in range(Nloop):
                for mdl_i, mdl in enumerate(SUBMODELS):
                    for ci in range(blocks_per[mdl_i]):
                        pos = (nloop, mdl_i, ci)
                        if resume_at is not None and pos < resume_at[:3]:
                            continue
                        order, mask, N = self.block(mdl, ci)
                        nadmm_start = 0
                        if (resume_at is not None and pos == resume_at[:3]
                                and resume_at[4]):
                            z, opt = r_z, r_opt
                            nadmm_start = resume_at[3]
                        else:
                            z = torch.zeros(N, dtype=torch.float32,
                                            device=self.device)
                            opt = self.init_opt(state, mdl, order, mask)
                            # a fresh block: fresh guard scale, async
                            # updates void
                            self._reset_block_ledgers()
                        resume_at = None
                        flat_bi = sum(blocks_per[:mdl_i]) + ci
                        for nadmm in range(nadmm_start, Nadmm):
                            box = [state, z, opt]
                            with round_trace(len(history),
                                             enabled=profile_on):
                                self._step_round(
                                    obs, src, box, nloop, mdl_i, mdl, ci,
                                    flat_bi, nadmm, Nadmm, blocks_per[mdl_i],
                                    history, checkpoint_path, log)
                            state, z, opt = box
        finally:
            if src is not None:
                src.close()
        obs.close()
        # write barrier: every queued save is durable before the caller
        # sees the run finished
        self._flush_ckpt_writer()
        return state, history

    def _train_clients(self, staged, state, opt, mdl, order, mask, px, py,
                       active=None):
        """``Niter`` L-BFGS steps of every client on block ``mdl``/``mask``:
        ([K, N] block vectors, the new optimizer states, [K] summed step
        losses).  A client with ``active[k] == 0`` does not train: it keeps
        its round-start vector and its state, and its loss reads 0."""
        xflats, opts, losses = [], [], []
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        # --sanitize: the local training is the instrumented step, as the
        # JAX round checkifies its per-client training
        with sanitize.scope(self._sanitizer, self._sanitize_label):
            for k in range(self.K):
                params = client_params(state, k)
                x = codec.get_trainable_values(params[mdl], order, mask)
                ok = opt[k]
                if active is not None and not active[k] > 0:
                    xflats.append(x)
                    opts.append(ok)
                    losses.append(zero)
                    continue
                step_losses = []
                for it in range(self.Niter):
                    flat_loss = self.block_loss(mdl, order, mask, params,
                                                staged[k, it], px, py)
                    x, ok, loss = self.lbfgs.step(flat_loss, x, ok)
                    step_losses.append(loss)
                xflats.append(x)
                opts.append(ok)
                losses.append(torch.stack(step_losses).sum())
        return torch.stack(xflats), opts, torch.stack(losses)

    def _round_plain(self, staged, state, z, opt, mdl, order, mask, N,
                     px, py):
        """Slice 1's round: every client trains, FedAvg, every client's
        block becomes z_new.  Returns (state, z_new, opt, dual, losses,
        norms): ``norms`` the client record's [K] ``||x_k - z||`` and
        ``||x_k - z_new||`` (None with the record off)."""
        xflat, opt, losses = self._train_clients(staged, state, opt, mdl,
                                                 order, mask, px, py)
        znew = federated_mean(xflat, self.K, self.mesh)   # FedAvg
        dual = torch.linalg.vector_norm(z - znew) / N
        # write-back: every client's block becomes z_new
        one = codec.put_trainable_values(
            tree_map(lambda t: t[0], state[mdl]), order, mask, znew)
        sub = state[mdl]
        for p in codec.active_paths_in_order(order, mask):
            leaf = get_by_path(one, p)
            sub = set_by_path(sub, p, leaf.unsqueeze(0).expand(
                self.K, *leaf.shape).contiguous())
        norms = (None, None)
        if self._client_probe:
            norms = (torch.linalg.vector_norm(xflat - z[None, :], dim=1),
                     torch.linalg.vector_norm(xflat - znew[None, :], dim=1))
        return {**state, mdl: sub}, znew, opt, dual, losses, norms

    def _round_corruption(self, key: tuple):
        """The ``(mode, scale)`` that rounds of ``key`` = (model, block,
        px, py) poison corrupted deltas with (None: no corruption): read
        from the fault spec in force at the first such round, after its
        campaign tick, and kept for the trainer's life, as the JAX trainer
        bakes it into the round it compiles and caches a key."""
        if key not in self._corruption_cache:
            f = self.faults
            self._corruption_cache[key] = (
                (f.mode, f.scale) if f.enabled and f.corrupt > 0 else None)
        return self._corruption_cache[key]

    def _round_robust(self, staged, state, z, opt, mdl, order, mask, px, py,
                      tmask, wmask, corrupt, gbound, corruption):
        """The robust round: the clients of ``tmask`` train; corruption
        (``(mode, scale)`` or None), the guard and the (robust or
        weighted) aggregation over the exchange weights ``wmask``; the
        write-back to the accepted participants.  Returns (state, z_new,
        opt, dual, losses, diag, okf, norms); ``okf`` the [K] guard
        verdicts (None with the guard off)."""
        cfg, K, mesh, dev = self.cfg, self.K, self.mesh, self.device
        xflat, opt, losses = self._train_clients(
            staged, state, opt, mdl, order, mask, px, py, active=tmask)
        w_in = torch.as_tensor(np.asarray(wmask, np.float32), device=dev)
        x = xflat
        if corruption is not None:
            # the wire delta is poisoned at the encode boundary
            c = torch.as_tensor(np.asarray(corrupt, np.float32), device=dev)
            x = z[None, :] + apply_corruption(
                x - z[None, :], c, *corruption,
                w=w_in, mesh=mesh)
        probe = self._client_probe
        cl_nrm = (torch.linalg.vector_norm(x - z[None, :], dim=1)
                  if probe else None)
        psum = lambda v: mesh.psum([s.sum() for s in mesh.shards(v)])
        w = w_in
        okf = None
        if cfg.update_guard:
            # finite and within the bound, or out like a non-participant;
            # selects only, so no NaN reaches the aggregation
            d = x - z[None, :]
            finite = torch.isfinite(d).all(dim=1)
            nrm = torch.linalg.vector_norm(
                torch.where(finite[:, None], d, torch.zeros_like(d)), dim=1)
            bound = torch.as_tensor(np.float32(gbound), device=dev)
            okf = (finite & (nrm <= bound)).to(torch.float32)
            w = w_in * okf
            n_ok = psum(w)
            n_trip = psum(w_in * (1.0 - okf))
            norm_mean = psum(w * nrm) / torch.clamp(n_ok, min=1.0)
            x = torch.where(okf[:, None] > 0, x, z[None, :])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        znew, _, diag = self.algo.global_update(x, z, z, zero, K, mesh, w=w,
                                                mean_fn=self.mean_fn)
        dual = diag.pop("dual_residual")
        if cfg.update_guard:
            # an all-rejected round keeps z
            znew = torch.where(n_ok > 0, znew, z)
            diag["guard_trips"] = n_trip
            diag["guard_norm_mean"] = norm_mean
            diag["n_ok"] = n_ok
        cl_dist = (torch.linalg.vector_norm(x - znew[None, :], dim=1)
                   if probe else None)
        # the accepted participants receive z_new; the others keep their
        # own block (an async dispatcher its freshly trained one: it is
        # the update in flight)
        own = codec.put_trainable_stack(state[mdl], order, mask, xflat)
        wrote = codec.put_trainable_stack(own, order, mask,
                                          znew.unsqueeze(0).expand(K, -1))
        diag["n_active"] = psum(w_in)
        return ({**state, mdl: _sel(w, wrote, own)}, znew, opt, dual,
                losses, diag, okf, (cl_nrm, cl_dist))

    def _step_round(self, obs, src, box, nloop, mdl_i, mdl, ci, flat_bi,
                    nadmm, Nadmm, n_blocks, history, checkpoint_path, log):
        """One communication round of block (mdl, ci); ``box`` is the
        in/out [state, z, opt] cell."""
        state, z, opt = box
        cfg = self.cfg
        t_round = time.perf_counter()
        launches0 = self._launch_counts()
        # the campaign tick, then the simulated preemption, before any
        # work of the round
        self._campaign_tick(len(history), nloop, flat_bi, nadmm,
                            checkpoint_path)
        self._maybe_preempt(nloop, flat_bi, nadmm, len(history),
                            checkpoint_path)
        px, py, batch = (src.get() if src is not None
                         else self.data.round_batches(self.Niter))
        self._cur_pxpy = (px, py)
        corruption = self._round_corruption((mdl, ci, px, py))
        order, mask, N = self.block(mdl, ci)
        self._sanitize_label = (f"CPC round (model {mdl}, block {ci}, "
                                f"round {len(history)})")
        # the quarantine census at round start, then the round's masks
        q_start = int(np.sum(self._quarantine > 0))
        tmask, wmask, corrupt, comm_host, fcounts = \
            self._round_activity(nloop, flat_bi, nadmm)
        n_comm = fcounts.pop("n_comm", 1)
        staged = self.stage(batch)
        self._sync()
        t_staged = time.perf_counter()
        norms = (None, None)
        diag: Dict[str, Any] = {}
        loss_host = None
        if self._robust_round and n_comm == 0:
            # every client out of the exchange: nothing trains, z and the
            # sub-model carry over, quarantine still ticks
            dual = 0.0
            diag = {"n_active": 0.0}
            if cfg.update_guard:
                diag.update(guard_trips=0.0, n_ok=0.0)
                self._quarantine = np.maximum(self._quarantine - 1, 0)
        elif self._robust_round:
            state, z, opt, dual, losses, diag, okf, norms = \
                self._round_robust(staged, state, z, opt, mdl, order, mask,
                                   px, py, tmask, wmask, corrupt,
                                   self._round_gbound(), corruption)
            diag = {k: float(v) for k, v in diag.items()}
            if cfg.update_guard:
                self._apply_guard_verdicts(diag, okf.cpu().numpy(),
                                           comm_host)
            loss_host = losses.cpu().numpy()
        else:
            state, z, opt, dual, losses, norms = self._round_plain(
                staged, state, z, opt, mdl, order, mask, N, px, py)
            loss_host = losses.cpu().numpy()
        n_active = diag.get("n_active", self.K) if self._robust_round \
            else self.K
        rec = dict(nloop=nloop, model=mdl, block=ci, nadmm=nadmm, N=N,
                   # the round's local-training calls: 1, 0 when every
                   # client is out of the exchange
                   host_dispatches=int(loss_host is not None),
                   dual_residual=float(dual),
                   loss=(float(losses.sum()) if loss_host is not None
                         else 0.0),
                   bytes_on_wire=self.round_bytes_on_wire(N, n_active))
        rec.update(fcounts)
        rec.update(diag)
        if self._robust_round and cfg.update_guard:
            rec["quarantined"] = q_start
        self._sync()
        t_done = time.perf_counter()
        rec["stage_seconds"] = t_staged - t_round
        rec["compute_seconds"] = t_done - t_staged
        rec["round_seconds"] = t_done - t_round
        rec["kernel_launches"] = {k: v - launches0[k]
                                  for k, v in self._launch_counts().items()}
        history.append(rec)
        if nadmm + 1 < Nadmm:
            nxt = (nloop, mdl_i, ci, nadmm + 1)
        elif ci + 1 < n_blocks:
            nxt = (nloop, mdl_i, ci + 1, 0)
        elif mdl_i + 1 < len(SUBMODELS):
            nxt = (nloop, mdl_i + 1, 0, 0)
        else:
            nxt = (nloop + 1, 0, 0, 0)
        t_ckpt = None
        if checkpoint_path is not None:
            t_ckpt = time.perf_counter()
            self._save_midrun(checkpoint_path, state, (z, opt), nxt, history)
            rec["ckpt_write_seconds"] = time.perf_counter() - t_ckpt
        extra_fields = {"bytes_dense": 4 * N * int(n_active)}
        if cfg.async_rounds:
            extra_fields["async_mode"] = True
            # the cutoff in force: the control plane may have moved it
            extra_fields["max_staleness"] = self.cfg.max_staleness
        cl_nrm, cl_dist = (None if t is None else t.cpu().numpy()
                           for t in norms)
        self._emit_round_obs(
            obs, rec, round_index=len(history) - 1, t_round=t_round,
            extra_fields=extra_fields, N=N, loss_host=loss_host,
            cl_nrm=cl_nrm, cl_dist=cl_dist,
            phase_marks=[("stage", "phase", t_round, t_staged),
                         ("compute", "phase", t_staged, t_done)],
            t_ckpt=t_ckpt, checkpoint_path=checkpoint_path, state=state,
            blockvars=(z, opt), nxt=nxt, history=history, log=log)
        log(f"dual (N={N},loop={nloop},model={mdl},"
            f"block={ci},avg={nadmm})="
            f"{rec['dual_residual']:e} "
            f"loss={rec['loss']:e}")
        box[:] = [state, z, opt]

    # ------------------------------------------------------------------
    # mid-run checkpoint / resume: the three sub-models, mid-block z and
    # the clients' L-BFGS states, the loop counters, the consumed round
    # count (the whole data-order state) and the kernel's ledgers
    # ------------------------------------------------------------------
    def _save_midrun(self, path: str, state: CPCState, blockvars, nxt,
                     history) -> None:
        z, opt = blockvars
        px, py = self._cur_pxpy
        nloop, mdl_i, ci, nadmm = nxt
        mid_block = nadmm > 0       # z and the L-BFGS states carry over
        tree = {}
        for m in SUBMODELS:
            tree.update(ckpt.flatten_dict(state[m], m + "/"))
        if mid_block:
            tree["z"] = z
            for i, leaf in enumerate(leaves(opt)):
                tree[f"opt/{i}"] = torch.as_tensor(leaf)
        meta = {
            "nloop": nloop, "mdl_i": mdl_i, "ci": ci, "nadmm": nadmm,
            "mid_block": int(mid_block), "px": px, "py": py,
            # the draws are keyed on the round: the consumed round count
            # (not the prefetcher's counter, which runs ahead)
            "data_round": len(history),
            "history": ckpt.pack_history(history),
        }
        meta.update(self._ledger_meta())
        if self._ckpt_writer is not None:
            # a host copy now; the writer thread serialises and rotates
            self._ckpt_writer.submit(path, ckpt.snapshot_to_host(tree), meta)
        else:
            ckpt.save_checkpoint_swapped(path, tree, meta)

    def _restore_midrun(self, path: str):
        tree, meta = ckpt.load_checkpoint(path)
        # geometry first: a wrong-K slot dies with its own error, and so
        # does a wrong-D one unless elastic_resume lays it out onto this
        # mesh (every saved tensor is [K, ...] or replicated: nothing of
        # it depends on D)
        ckpt.validate_geometry(meta, devices=self.D, processes=1, K=self.K,
                               elastic=self.cfg.elastic_resume)
        dev = self.device
        state = {m: tree_map(lambda v: v.to(dev),
                             ckpt.unflatten_dict(tree, m + "/"))
                 for m in SUBMODELS}
        self.data._round = int(meta["data_round"])
        mid = bool(meta["mid_block"])
        z = opt = None
        if mid:
            mdl = SUBMODELS[int(meta["mdl_i"])]
            order, mask, _ = self.block(mdl, int(meta["ci"]))
            n_opt = sum(1 for k in tree if k.startswith("opt/"))
            opt = unflatten_like(self.init_opt(state, mdl, order, mask),
                                 [tree[f"opt/{i}"] for i in range(n_opt)])
            z = tree["z"].to(dev)
        self._restore_ledger_meta(meta)
        history = ckpt.unpack_history(meta["history"])
        nxt = (int(meta["nloop"]), int(meta["mdl_i"]), int(meta["ci"]),
               int(meta["nadmm"]), mid)
        return state, z, opt, nxt, history

    def _resume(self, checkpoint_path: str, log):
        """Walk the slots newest first; returns the first usable one's
        restore, or None when there is no slot.  A slot that fails its
        checksum or its load is skipped; a geometry error is not (every
        slot has the same geometry)."""
        failures = []
        for slot in ckpt.checkpoint_slots(checkpoint_path):
            try:
                ckpt.verify_checkpoint(slot)
                restored = self._restore_midrun(slot)
            except ckpt.CheckpointGeometryError:
                raise
            except Exception as e:
                failures.append(f"{slot}: {e}")
                log(f"WARNING: checkpoint slot {slot} is unusable ({e}); "
                    "falling back to the previous slot")
                continue
            log(f"resumed mid-run checkpoint {slot} at "
                f"(nloop, model, block, nadmm)={restored[3][:4]}")
            return restored
        if failures:
            raise ckpt.CheckpointCorruptError(
                "no valid mid-run checkpoint slot survives: "
                + "; ".join(failures))
        return None
