"""Federated CPC trainer (reference federated_cpc.py).

Port of ``federated_pytorch_test_tpu/train/cpc_engine.py`` on its default
path (no fault injection, guards, robust aggregation, checkpoints or
telemetry).  Three sub-models (encoder / contextgen / predictor) train in
rotation: for each block of each sub-model, a fresh consensus ``z`` of
zeros and a fresh L-BFGS state per client; each communication round runs
``Niter`` minibatches per client through L-BFGS, then FedAvg of the block,
``dual = |z - z_new| / N`` and the write-back of ``z_new`` into every
client.  The L-BFGS state persists across the ``Nadmm`` rounds of a block.

On one card the K clients are the leading dimension of every parameter
tensor, and local training is a loop over clients (the JAX ``vmap``; a
batched ``while_loop`` keeps each finished client's carry, so the values
are the same).  Each closure evaluates its sub-model at a flat block vector
with ``torch.func.functional_call``; the frozen prefix of the pipeline is
computed once per minibatch, outside the closure.  The InfoNCE tail runs
the CUDA kernels of ``ops/infonce.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.func import functional_call

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
from federated_pytorch_test_tpu_torch.ops import infonce
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew
from federated_pytorch_test_tpu_torch.parallel.comm import federated_mean
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.utils import blocks as blocklib
from federated_pytorch_test_tpu_torch.utils import codec
from federated_pytorch_test_tpu_torch.utils.device import resolve_device
from federated_pytorch_test_tpu_torch.utils.initializers import init_weights
from federated_pytorch_test_tpu_torch.utils.tree import (
    get_by_path,
    set_by_path,
    tree_map,
)

SUBMODELS = ("encoder", "contextgen", "predictor")

#: stacked client state: {sub-model: {module: {"kernel"|"bias": [K, ...]}}}
CPCState = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def client_params(state: CPCState, k: int) -> CPCState:
    """Client ``k``'s parameters (views into the stacked state)."""
    return {m: tree_map(lambda t: t[k], state[m]) for m in SUBMODELS}


class CPCTrainer:
    """Rotating 3-sub-model federated CPC."""

    def __init__(self, data: CPCDataSource, latent_dim: int = 256,
                 reduced_dim: int = 32, lbfgs_history: int = 7,
                 lbfgs_max_iter: int = 2, Niter: int = 10,
                 cfg: Optional[FederatedConfig] = None):
        self.data = data
        # the data source defines the federation: one client per (file, SAP)
        self.cfg = dataclasses.replace(cfg or FederatedConfig(), K=data.K)
        self.K = data.K
        self.Niter = Niter
        self.device = resolve_device(self.cfg.device)
        if self.device.type == "cuda":
            # float32 means float32: cuDNN runs float32 convolutions in TF32
            # by default (about three decimal digits); matmuls are full
            # float32 by default, pinned here all the same
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.models = {
            "encoder": EncoderCNN(latent_dim),
            "contextgen": ContextgenCNN(latent_dim),
            "predictor": PredictorCNN(latent_dim, reduced_dim),
        }
        for m in self.models.values():
            m.to(self.device).requires_grad_(False)
        self.lbfgs = LBFGSNew(history_size=lbfgs_history,
                              max_iter=lbfgs_max_iter)
        # common init (the reference seeds all K clients identically); a
        # CPU generator, so the weights do not depend on the device
        gen = torch.Generator().manual_seed(self.cfg.init_seed)
        self.state0: CPCState = {}
        for name in SUBMODELS:
            tree = init_weights(self.models[name].param_tree(), gen)
            self.state0[name] = tree_map(
                lambda t: t.unsqueeze(0).expand(self.K, *t.shape).contiguous(),
                tree)

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

    # ------------------------------------------------------------------
    def run(self, Nloop: int = 1, Nadmm: int = 1,
            state: Optional[CPCState] = None,
            log: Callable[[str], None] = print, prefetch: bool = True):
        """The rotation loop (federated_cpc.py:194-304); returns
        (final stacked state, one history record per round).

        ``prefetch`` builds round n+1's host batch on a background thread
        while round n trains; the draws are keyed on (seed, round, client),
        so the data is the same either way.
        """
        state = self.state0 if state is None else state
        n_blocks = sum(len(self.models[m].train_order_block_ids())
                       for m in SUBMODELS)
        n_rounds = Nloop * n_blocks * Nadmm
        src = (RoundPrefetcher(self.data, self.Niter, n_rounds)
               if prefetch and n_rounds > 0 else None)
        history: List[Dict[str, Any]] = []
        try:
            for nloop in range(Nloop):
                for mdl in SUBMODELS:
                    for ci in range(len(self.models[mdl]
                                        .train_order_block_ids())):
                        order, mask, N = self.block(mdl, ci)
                        z = torch.zeros(N, dtype=torch.float32,
                                        device=self.device)
                        opt = [self.lbfgs.init(codec.get_trainable_values(
                            client_params(state, k)[mdl], order, mask))
                            for k in range(self.K)]
                        for nadmm in range(Nadmm):
                            state, z, opt, rec = self._round(
                                src, state, z, opt, mdl, ci, order, mask, N)
                            rec.update(nloop=nloop, nadmm=nadmm)
                            history.append(rec)
                            log(f"dual (N={N},loop={nloop},model={mdl},"
                                f"block={ci},avg={nadmm})="
                                f"{rec['dual_residual']:e} "
                                f"loss={rec['loss']:e}")
        finally:
            if src is not None:
                src.close()
        return state, history

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _round(self, src, state, z, opt, mdl, ci, order, mask, N):
        """One communication round of block (mdl, ci)."""
        t_round = time.perf_counter()
        launches0 = dict(infonce.LAUNCHES)
        px, py, batch = (src.get() if src is not None
                         else self.data.round_batches(self.Niter))
        staged = self.stage(batch)
        self._sync()
        t_staged = time.perf_counter()

        xflats, losses = [], []
        for k in range(self.K):
            params = client_params(state, k)
            x = codec.get_trainable_values(params[mdl], order, mask)
            step_losses = []
            for it in range(self.Niter):
                flat_loss = self.block_loss(mdl, order, mask, params,
                                            staged[k, it], px, py)
                x, opt[k], loss = self.lbfgs.step(flat_loss, x, opt[k])
                step_losses.append(loss)
            xflats.append(x)
            losses.append(torch.stack(step_losses).sum())
        znew = federated_mean(torch.stack(xflats), self.K)    # FedAvg
        dual = torch.linalg.vector_norm(z - znew) / N
        # write-back: every client's block becomes z_new
        one = codec.put_trainable_values(
            tree_map(lambda t: t[0], state[mdl]), order, mask, znew)
        sub = state[mdl]
        for p in codec.active_paths_in_order(order, mask):
            leaf = get_by_path(one, p)
            sub = set_by_path(sub, p, leaf.unsqueeze(0).expand(
                self.K, *leaf.shape).contiguous())
        state = {**state, mdl: sub}
        rec = dict(model=mdl, block=ci, N=N,
                   dual_residual=float(dual),
                   loss=float(torch.stack(losses).sum()),
                   bytes_on_wire=4 * N * self.K)
        self._sync()
        t_done = time.perf_counter()
        rec["stage_seconds"] = t_staged - t_round
        rec["compute_seconds"] = t_done - t_staged
        rec["round_seconds"] = t_done - t_round
        rec["kernel_launches"] = {k: v - launches0[k]
                                  for k, v in infonce.LAUNCHES.items()}
        return state, znew, opt, rec
