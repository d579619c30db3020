"""Blockwise-federated engine: the FedAvg, FedProx and consensus rounds of
the classifiers and (through ``train/vae_engine.py``) the VAEs, and the
no-consensus baseline.

Port of ``BlockwiseFederatedTrainer`` of
``federated_pytorch_test_tpu/train/engine.py`` with the robust
aggregation (``robust_agg``, ``robust_chunked``), the compressed exchange
(``compress`` q8/q4/topk, ``error_feedback``, ``fused_collective``), the
local optimizer (``optimizer`` adam or lbfgs), the robustness shell of a
round, the mid-run checkpoint and the throughput knobs (device-resident
data, fused rounds, staging and round overlap, sharded update).  The loop
nest of the reference is kept::

    Nloop (sweeps over the net) -> L blocks -> Nadmm (comm rounds)
      -> Nepoch (local epochs) -> K clients -> minibatches

Per block: a fresh consensus ``z`` of zeros, fresh duals ``y`` and a fresh
optimizer state per client.  A local epoch trains only the active block, as
a flat vector in the JAX element order: Adam (optax's update, written out)
on the gradient of the classifier loss plus the algorithm's penalty, or one
``LBFGSNew`` step (batch mode, backtracking) a minibatch on that loss.  The
comm step gathers the ``[K, N]`` stack, runs the algorithm's global update
through the (robust) mean over the client mesh, and writes ``z`` back for
FedAvg.  Under ``compress`` the server sees only the reconstructions
``z + decode(encode(x - z))``; with ``fused_collective`` their mean runs as
the packed quantized collective of ``ops/packed_reduce.py`` (kernels B1
and B2), or for top-k as the all-gather and scatter-add of the sparse
payloads themselves.  :meth:`BlockwiseFederatedTrainer.run_independent` is
the baseline: the whole net trains, Adam afresh every epoch, no comm.  The
K clients are a loop on one device (the JAX ``vmap``); each keeps its own
parameters, BatchNorm statistics, data and normalisation.

Epoch data comes from the counter-keyed seed of the JAX engine
(``_epoch_seed``): its ``[K, steps*B]`` row indices are drawn on the host
(``data.epoch_indices``), the next epoch's on a one-worker pool meanwhile.
The host path gathers the batches there and copies them over each epoch;
with ``device_data`` the shards live on the device and only the indices
cross, the same rows either way, so ``device_data`` does not change the
numbers.  The JAX engine's device path draws its shuffle with
``jax.random`` instead, which torch cannot replay: the port's device path
matches the JAX host path, and parity runs pin ``device_data=False`` on
the JAX side.

The throughput knobs change when the host launches work, never what is
computed: ``fused_rounds`` stages a round's epoch indices up front and
runs its epochs and update with no host read or sync in between;
``overlap_staging`` stages the next epoch while the comm step runs, and
``overlap_round`` launches the next round's first epoch before the host
reads the round's results (:meth:`_read_async`); the epoch counter
advances only when an epoch is consumed, so checkpoints and resume are
exact under each of them.  ``sharded_update`` is accepted with the JAX
engine's refusals; on the one-card client mesh a reduce-scatter of the
shard sums would compute the replicated mean's numbers, so the
replicated mean serves it.  Each round record carries
``host_dispatches``, the JAX engine's count of local-training calls of
the round (Nepoch, 1 when fused).  In the port it counts calls of a
Python method, not launches on the device: every kernel is launched
eagerly either way, and launch overhead is read from a profiled round's
kernel count instead.

The workload hooks are the JAX engine's: ``sweep`` ("blocks", or "layers":
sweep unit ``ci`` is the (weight, bias) pair ``ci``), ``optimizer_for_block``
and ``lr_for_block`` (the Adam/L-BFGS switch per block), ``reg_for_block``,
``model_loss`` and ``eval_batch_metric``/``eval_finalize``.  A model with
reparametrisation noise (``model.noise_shape``) gets one draw per client
and minibatch step, a pure function of ``(cfg.seed, epoch counter, client,
step)`` through :attr:`BlockwiseFederatedTrainer.normal`; every closure
evaluation of that step's L-BFGS line search sees the same draw, as the
JAX engine fixes ``fold_in(key, step)`` for the whole step.

The robustness shell of a round is the JAX engine's (``RoundKernel``,
``train/rounds.py``): partial participation, injected faults (drop,
straggle, corrupt at the encode boundary, transit delay, churn,
preemption), the update guard with quarantine, buffered async rounds and
population cohorts, or a soak campaign (``campaign/``) whose per-round
window sets the fault spec.  Any of them makes the round *partial*: the local
epoch skips the clients out of training (the JAX engine computes them and
discards the result, so the numbers are the same), the exchange weights
clients by the round's activity vector, and only its participants receive
z.  Adam's step count is kept per client, as optax's under the JAX
engine's ``vmap``.  ``run(checkpoint_path=...)`` saves a mid-run checkpoint
after every round and ``resume=True`` continues from the newest usable
slot (``utils/checkpoint.py``), bit for bit the uninterrupted run.  A
block's round shape (masked or not, corrupted or not) is read from the
fault spec when the block is built, as the JAX engine compiles it
(``_block_flags``).  With ``serve_spec`` set the consensus is served at
every round boundary (``serve/``): hot-swapped into a bucketed predictor
that answers the round's seeded traffic, one ``serve`` record a round.

Every run opens a recorder (``obs/``): a run header, a ``round`` and a
``client`` record a round with the stage, train and comm spans, and a
summary, written to ``cfg.obs_dir`` (drivers default it to
``<checkpoint_dir>/obs``); the health watchdog and the control plane read
the same records.  With a recorder writing, each phase ends in a device
sync so that its span measures execution; with obs off the round keeps
its one sync.  ``cfg.profile_dir`` wraps the run in ``torch.profiler``
(``utils/profiling.py``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.analysis import sanitize
from federated_pytorch_test_tpu_torch.compress.base import (
    make_compressor,
    stacked_init,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.base import BlockModule
from federated_pytorch_test_tpu_torch.ops import gram, quant
from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
    fused_bytes_on_wire,
    make_fused_mean,
    make_sparse_fused_mean,
)
from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew
from federated_pytorch_test_tpu_torch.parallel.comm import (
    decode_stack,
    make_robust_mean,
)
from federated_pytorch_test_tpu_torch.parallel.mesh import (
    ClientMesh,
    usable_device_count,
)
from federated_pytorch_test_tpu_torch.serve.batcher import MicroBatcher
from federated_pytorch_test_tpu_torch.serve.evalstream import EvalStream
from federated_pytorch_test_tpu_torch.serve.infer import (
    HEADS,
    BatchedPredictor,
    consensus_weights,
)
from federated_pytorch_test_tpu_torch.serve.swap import DoubleBuffer
from federated_pytorch_test_tpu_torch.train.algorithms import (
    Algorithm,
    BBConfig,
    bb_rho_update,
)
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.faults import apply_corruption
from federated_pytorch_test_tpu_torch.train.losses import (
    accuracy_count,
    cross_entropy,
    l1_l2,
)
from federated_pytorch_test_tpu_torch.obs import device_memory_stats
from federated_pytorch_test_tpu_torch.obs.health import RunHealthAbort
from federated_pytorch_test_tpu_torch.train.rounds import RoundKernel
from federated_pytorch_test_tpu_torch.utils import blocks as blocklib
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils import codec
from federated_pytorch_test_tpu_torch.utils.device import resolve_device
from federated_pytorch_test_tpu_torch.utils.profiling import (
    profile_ctx,
    round_trace,
)
from federated_pytorch_test_tpu_torch.utils.tree import (
    leaves,
    map_leaves,
    tree_map,
    tree_stack,
    unflatten_like,
)

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

#: seed words of the evaluation's fixed noise draw (the JAX engine
#: evaluates with ``PRNGKey(0)`` whatever the run's seed)
EVAL_NOISE_WORDS = (0,)


def torch_normal(words: Sequence[int], shape: Sequence[int],
                 device) -> torch.Tensor:
    """Standard normal float32 draw of ``shape`` from a generator on
    ``device`` seeded from the words ``words``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(words))
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.randn(tuple(shape), generator=g, device=device)


class ClientState(NamedTuple):
    """Per-client training state, stacked on the leading K dimension:
    parameters and BatchNorm statistics (nested dicts of [K, ...] tensors,
    PyTorch layout), the active block's optimizer state (an
    :class:`AdamState`, or a list of K ``LBFGSState``) and compressor
    state."""

    params: Any
    batch_stats: Any
    opt_state: Any = None
    comp: Any = None


class AdamState(NamedTuple):
    """optax.adam's state over the active block's flat vectors, one step
    count per client (optax's under the JAX engine's ``vmap``): a client
    that sits a round out keeps its moments and its count."""

    mu: torch.Tensor       # [K, N]
    nu: torch.Tensor       # [K, N]
    count: torch.Tensor    # [K] int64, on the host (read a step, no sync)


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


def _launch_counts() -> Dict[str, int]:
    """The kernels' launch counters of this process, by kernel name."""
    return {**gram.LAUNCHES, **quant.LAUNCHES}


def _normalize_u8(x_u8: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Device-side ToTensor + Normalize of NHWC uint8 images with the
    client's [2, 3] (mean, std), returned NCHW."""
    x = x_u8.to(torch.float32) / 255.0
    return ((x - norm[0]) / norm[1]).permute(0, 3, 1, 2)


def _sel(active: torch.Tensor, new, old):
    """Per-leaf ``where(active_k > 0, new, old)`` over the client axis: the
    rows of inactive clients stay bit-untouched."""
    def pick(a, b):
        if a is b:
            return a
        m = active.to(a.device).reshape((-1,) + (1,) * (a.dim() - 1)) > 0
        return torch.where(m, a, b)
    return map_leaves(pick, new, old)


class BlockwiseFederatedTrainer(RoundKernel):
    """The engine of the consensus, FedAvg, FedProx and no-consensus
    drivers, with optional robust aggregation, compressed exchange,
    L-BFGS and the robustness shell of ``train/rounds.py``.  The VAE
    trainers subclass it and override the workload hooks."""

    #: "blocks" sweeps train_order_block_ids() (federated_multi.py:145-147);
    #: "layers" sweeps (weight, bias) pairs, the VAE driver's
    #: unfreeze_one_layer path (federated_vae.py:129)
    sweep: str = "blocks"
    #: engine tag of the obs records ("vae" and "vae_cl" in the subclasses)
    obs_engine: str = "classifier"
    #: the obs stream's run name (the drivers set their program's name)
    obs_run_name: Optional[str] = None

    def __init__(self, model: BlockModule, cfg: FederatedConfig,
                 data: FederatedCifar10, algorithm: Algorithm):
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
        # in both sweeps ci ranges over len(train_order_block_ids()): the
        # reference VAE driver iterates that count but trains LAYER ci
        # (federated_vae.py:126-129); for its models the counts agree
        self.L = len(self.block_ids)
        if self.sweep == "layers":
            n_layers = (len(self.order) + 1) // 2
            if self.L != n_layers:
                raise ValueError(
                    f"layer sweep needs len(train_order_block_ids())=="
                    f"{n_layers} (layers), got {self.L}")
        self.noise_shape = getattr(model, "noise_shape", None)
        #: the noise draw ``(words, shape, device) -> eps``; a test seam
        self.normal: Callable[..., torch.Tensor] = torch_normal

        K = cfg.K
        self.mesh = ClientMesh(usable_device_count(K) if cfg.num_devices is None
                               else cfg.num_devices)
        self.D = self.mesh.size
        if K % self.D:
            raise ValueError(f"K={K} not divisible by device count {self.D}")
        self.K_local = K // self.D
        # --sanitize: the checked steps' carried error (None: no mode)
        self._sanitizer = (sanitize.Sanitizer(self.device) if cfg.sanitize
                           else None)
        self._sanitize_round = 0
        # update compression: validated here, so a bad flag combination
        # fails at construction
        self.compressor = make_compressor(
            cfg.compress, topk_frac=cfg.topk_frac,
            quant_chunk=cfg.quant_chunk, error_feedback=cfg.error_feedback)
        # the round kernel: fault spec, ledgers (train/rounds.py)
        self._init_round_kernel()
        self._ckpt_writer = None
        if cfg.fused_collective and self.compressor.name == "none":
            raise ValueError(
                "fused_collective requires a compressed wire format "
                "(--compress q8/q4/topk): the fused reduction transports "
                "the packed payloads, and the dense path has nothing to "
                "keep packed")
        if (cfg.fused_collective or cfg.sharded_update) \
                and cfg.robust_agg != "none":
            raise ValueError(
                "fused_collective/sharded_update are incompatible with "
                "--robust-agg: both replace the aggregation chokepoint, "
                "and the robust estimators need the full [K, N] stack "
                "replicated on every device")
        self._fused_coll = bool(cfg.fused_collective)
        if self._fused_coll and self.compressor.sparse and algorithm.needs_dual:
            warnings.warn(
                "fused_collective with a sparse compressor is unavailable "
                "for dual-state algorithms: the aggregated stack y + rho*x "
                "is dense, not the sparse wire payload; falling back to "
                "the unfused reduction", stacklevel=2)
            self._fused_coll = False
        if self._fused_coll and self.compressor.sparse:
            self.mean_fn = None         # built each round from its payload
        elif self._fused_coll:
            self.mean_fn = make_fused_mean(self.compressor, self.mesh, K)
        else:
            self.mean_fn = make_robust_mean(
                cfg.robust_agg, trim_frac=cfg.trim_frac,
                clip_mult=cfg.clip_mult, chunked=cfg.robust_chunked,
                mesh=self.mesh)
            # sharded_update: on the one-card mesh the reduce-scatter of
            # the shard sums, the divide on the owned segment and the
            # all-gather give the replicated mean's numbers, so the plain
            # mean serves it (the fused collective, which already divides
            # on the owned segment, wins when both are on)
        self._validate_round_cfg()

        # common init: every client starts from the same weights (drawn on
        # a CPU generator, so they do not depend on the device)
        gen = torch.Generator().manual_seed(cfg.init_seed)
        params, batch_stats = model.init_variables(gen, cfg.init_model)
        self.has_bn = bool(batch_stats)
        for ci in [None, *range(self.L)]:
            opt_name = self.optimizer_for_block(ci)
            if opt_name not in ("adam", "lbfgs"):
                raise ValueError(f"unknown optimizer {opt_name!r}; "
                                 "expected 'adam' or 'lbfgs'")
            if opt_name == "lbfgs" and self.has_bn:
                raise ValueError(
                    "lbfgs local optimizer requires a BatchNorm-free model "
                    "(closure re-evaluation with mutable stats is "
                    "ill-defined; the reference only pairs LBFGSNew with "
                    "BN-free models)")
        # batch mode with the backtracking line search, lr 1.0
        # (federated_multi.py:158); lr_for_block feeds Adam only
        self.lbfgs = LBFGSNew(history_size=cfg.lbfgs_history_size,
                              max_iter=cfg.lbfgs_max_iter, batch_mode=True,
                              line_search_fn=True)
        stack = lambda t: (t.unsqueeze(0).expand(K, *t.shape).contiguous()
                           .to(self.device))
        self.params0 = tree_map(stack, params)
        self.batch_stats0 = tree_map(stack, batch_stats)

        xt, yt, wt = data.test_batches_raw()
        self.test_x = torch.from_numpy(np.ascontiguousarray(xt)).to(self.device)
        self.test_y = torch.from_numpy(yt).to(self.device)
        self.test_w = torch.from_numpy(wt).to(self.device)
        self.test_n = int(wt.sum())
        # the host copy serves population mode: slot k's normalisation
        # follows the cohort's data shard (rid % K)
        self._client_norm_host = np.asarray(data.norm_stats, np.float32)
        self.client_norm = torch.from_numpy(self._client_norm_host).to(
            self.device)

        # each block's frozen round shape (_block_flags)
        self._flag_cache: Dict[int, tuple] = {}
        # epochs are keyed on this counter (_epoch_seed); it advances when
        # an epoch is consumed
        self._epochs_staged = 0
        self._pending: Optional[tuple] = None
        self._stage_pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="epoch-stage")
            if cfg.prefetch else None)
        # local-training calls of the run (the round record's
        # host_dispatches: Nepoch a round, 1 when fused; the JAX engine's
        # count of dispatches, here of method calls, not of kernels)
        self._host_dispatches = 0
        # the staging look-ahead (cfg.overlap_staging): (counter, payload,
        # needs_finish), and the pre-launched epoch (cfg.overlap_round):
        # (coords, counter, (state, losses))
        self._overlap = bool(cfg.overlap_staging)
        self._staged_ahead: Optional[tuple] = None
        self._round_ahead: Optional[tuple] = None
        self._side_stream = None

        # device-resident data (cfg.device_data; None = auto by size)
        self._dev_x = None
        if self._want_device_data():
            self._setup_device_data()
        # fused rounds need the epochs on the device; be_verbose reads the
        # host every epoch
        self._use_fused = bool(cfg.fused_rounds)
        if self._use_fused and (self._dev_x is None or cfg.be_verbose):
            why = ("be_verbose syncs the host every epoch"
                   if cfg.be_verbose else
                   "population sampling re-indexes epoch data on the host"
                   if self._pop_active else
                   "epoch data is not device-resident (device_data)")
            warnings.warn(
                f"fused_rounds requested but unusable: {why}; "
                "falling back to the per-epoch round loop", stacklevel=2)
            self._use_fused = False
        # whole-round overlap: each excluded knob makes round N+1's inputs
        # depend on round N's host-visible outcome
        self._overlap_round = bool(cfg.overlap_round)
        if self._overlap_round:
            why = None
            if self._use_fused or cfg.fused_rounds:
                why = ("fused_rounds already runs the whole round as one "
                       "dispatch — there is no host gap to hide")
            elif cfg.update_guard:
                why = ("guard verdicts decide the next round's "
                       "quarantine set after the comm fetch")
            elif cfg.async_rounds:
                why = ("the async scheduler admits updates on the host "
                       "between rounds")
            elif self.faults.enabled:
                why = ("fault/churn families tick host ledgers at every "
                       "round boundary")
            elif self.campaign is not None:
                why = "campaign schedules re-derive the fault spec per round"
            elif self._pop_active:
                why = "population sampling rotates the cohort per round"
            if why is not None:
                warnings.warn(
                    f"overlap_round requested but unsafe: {why}; "
                    "falling back to the sequential round loop",
                    stacklevel=2)
                self._overlap_round = False

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def sweep_paths(self, ci: int):
        """Active leaf paths of sweep unit ``ci``."""
        if self.sweep == "layers":
            return blocklib.layer_paths(self.order, ci)
        return blocklib.block_paths(self.order, self.block_ids[ci])

    def mask_for_block(self, ci: Optional[int]):
        """Leaf mask of sweep unit ``ci``; ``None`` -> the whole net."""
        paths = tuple(self.order) if ci is None else self.sweep_paths(ci)
        return blocklib.build_mask(self.params0, paths)

    def block_size(self, ci: Optional[int]) -> int:
        one = tree_map(lambda t: t[0], self.params0)
        return codec.masked_size(one, self.order, self.mask_for_block(ci))

    def optimizer_for_block(self, ci: Optional[int]) -> str:
        """'adam' | 'lbfgs': the VAE-CL driver switches per block
        (federated_vae_cl.py:200-205)."""
        return self.cfg.optimizer

    def lr_for_block(self, ci: Optional[int]) -> float:
        """Adam's learning rate on block ``ci``."""
        return self.cfg.lr

    def reg_for_block(self, ci: Optional[int]):
        """(lambda1, lambda2) on the flat vector — the reference quirk: the
        *block* index is tested against the fc parameter ids
        (federated_multi.py:183).  The whole net (``None``) has none."""
        if ci is not None and ci in self.linear_ids:
            return (self.cfg.lambda1, self.cfg.lambda2)
        return (0.0, 0.0)

    def init_opt(self, params, ci: Optional[int]):
        """Fresh optimizer state of every client on block ``ci``: Adam's
        zero moments, or each client's ``LBFGSState`` at its block vector."""
        N = self.block_size(ci)
        if self.optimizer_for_block(ci) == "adam":
            f32 = dict(dtype=torch.float32, device=self.device)
            return AdamState(torch.zeros(self.cfg.K, N, **f32),
                             torch.zeros(self.cfg.K, N, **f32),
                             torch.zeros(self.cfg.K, dtype=torch.int64))
        X = codec.get_trainable_stack(params, self.order,
                                      self.mask_for_block(ci))
        return [self.lbfgs.init(x) for x in X]

    def _init_comp_state(self, ci: int, device=None):
        """Fresh [K]-stacked compressor state for block ``ci`` (or None),
        seeded per (cfg.seed, block) as in the JAX engine, on ``device``
        (default the trainer's)."""
        if self.compressor.name == "none":
            return None
        seed = int(np.random.default_rng(
            [self.cfg.seed, 23, ci]).integers(2**31))
        return stacked_init(self.compressor, self.cfg.K, self.block_size(ci),
                            seed, device or self.device)

    def _population_swap_comp(self, comp, ci: int):
        """Move the [K]-stacked compressor/EF rows to this round's cohort:
        stash the previous cohort's rows in the registry, then give each
        slot its new member's stored row (if sampled before in this block)
        or the block's fresh row for that slot.  So an EF residual follows
        the registry client, not the slot."""
        reg, cohort = self._registry, self._cohort
        if (self._pop_comp_prev is not None
                and np.array_equal(self._pop_comp_prev, cohort)):
            return comp
        if self._pop_comp_prev is None and reg.comp_rows == 0:
            # first round of the block: the live state is the fresh init
            self._pop_comp_prev = cohort.copy()
            return comp
        cur = [t.detach().cpu().numpy() for t in leaves(comp)]
        stacked = [a.ndim >= 1 and a.shape[0] == self.cfg.K for a in cur]
        if self._pop_comp_prev is not None:
            reg.stash_comp_rows(self._pop_comp_prev, cur, stacked)
        fresh = [t.numpy()
                 for t in leaves(self._init_comp_state(ci, "cpu"))]
        out = reg.load_comp_rows(cohort, fresh, stacked)
        out = [o if is_k else c for o, c, is_k in zip(out, cur, stacked)]
        self._pop_comp_prev = cohort.copy()
        return unflatten_like(comp, [torch.from_numpy(np.array(o))
                                     for o in out])

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
        """Host half of epoch ``counter`` (safe on the stage pool's
        thread): the [K, steps*B] row indices with device-resident data,
        else the shuffled and gathered batches."""
        seed = self._epoch_seed(counter, 0)
        if self._dev_x is not None:
            return self.data.epoch_indices(seed)
        return self.data.epoch_batches_raw(seed)

    # ------------------------------------------------------------------
    # device-resident data (cfg.device_data)
    # ------------------------------------------------------------------
    def _want_device_data(self) -> bool:
        """Resolve ``cfg.device_data`` (the JAX engine's gating): False
        off; population sampling re-indexes epochs by the cohort on the
        host, so auto resolves off there and an explicit True raises; a
        pipeline without ``train_shards_raw`` raises on True; auto is on
        when the shards fit ``FEDTPU_DEVICE_DATA_MB`` (default 2048)."""
        want = self.cfg.device_data
        if want is False:
            return False
        if self._pop_active:
            if want:
                raise ValueError(
                    "device_data=True is incompatible with population "
                    "sampling: epoch batches are re-indexed by the "
                    "round's cohort on the host (only auto/False are "
                    "valid here)")
            return False
        if not hasattr(self.data, "train_shards_raw"):
            if want:
                raise ValueError(
                    "device_data=True but the data pipeline "
                    f"({type(self.data).__name__}) exposes no "
                    "train_shards_raw(); only auto/False are valid here")
            return False
        xt, yt = self.data.train_shards_raw()
        if want is None:
            budget = float(os.environ.get("FEDTPU_DEVICE_DATA_MB",
                                          2048)) * 2**20
            return xt.nbytes + yt.nbytes <= budget
        return True

    def _setup_device_data(self) -> None:
        """Put the uint8 shards, their int32 labels and the pad weights on
        the device once; every epoch is then a gather there
        (:meth:`_gather_epoch`).  Ends in a sync, so that the side stream
        of the staging look-ahead may read the shards without waiting on
        the main stream."""
        xt, yt = self.data.train_shards_raw()
        dev = self.device
        self._dev_x = torch.from_numpy(np.array(xt)).to(dev)
        self._dev_y = torch.from_numpy(np.array(yt, np.int32)).to(dev)
        self._dev_w = torch.from_numpy(self.data.pad_weights()).to(dev)
        self._dev_rows = torch.arange(self.cfg.K, device=dev)[:, None]
        self._sync()

    def _gather_epoch(self, idx: torch.Tensor):
        """(xb, yb, wb) of one epoch from its [K, steps*B] row indices on
        the device: the rows ``epoch_batches_raw`` gathers on the host."""
        K, S, B = self.cfg.K, self.data.steps, self.data.batch
        xb = self._dev_x[self._dev_rows, idx]
        return (xb.view(K, S, B, *xb.shape[2:]),
                self._dev_y[self._dev_rows, idx].view(K, S, B), self._dev_w)

    # ------------------------------------------------------------------
    # staging: every epoch is a pure function of its counter, which
    # advances only when an epoch is consumed (checkpoints and resume)
    # ------------------------------------------------------------------
    def _total_epochs(self) -> int:
        cfg = self.cfg
        return cfg.Nloop * self.L * cfg.Nadmm * cfg.Nepoch

    def _epoch_raw(self, c: int, last: bool = False):
        """The host half of epoch ``c`` (from the prefetch when it holds
        ``c``); submits epoch c+1 to the stage pool unless ``last``."""
        if self._pending is not None and self._pending[0] == c:
            raw = self._pending[1].result()
        else:
            raw = self._host_epoch(c)
        self._pending = None
        if self._stage_pool is not None and not last:
            self._pending = (c + 1,
                             self._stage_pool.submit(self._host_epoch, c + 1))
        return raw

    def _finish_epoch(self, raw, ahead: bool = False):
        """Device arrays ``((xb, yb, wb), event)`` of a host half: the
        population re-index (slot k trains on registry client cohort[k]'s
        shard, rid % K), then the copy to the device and, with device
        data, the gather.  ``ahead`` (the staging look-ahead, on the
        card): the copy goes from pinned memory, non-blocking, on a side
        stream, and ``event`` marks its end; no synchronisation here."""
        dev = self.device
        if self._dev_x is None and self._pop_active and self._cohort is not None:
            rows = (self._cohort % self.cfg.K).astype(np.int64)
            raw = tuple(a[rows] for a in raw)
        host = [raw] if self._dev_x is not None else list(raw)
        if not (ahead and dev.type == "cuda"):
            out = [torch.from_numpy(a).to(dev) for a in host]
            return (self._gather_epoch(out[0]) if self._dev_x is not None
                    else tuple(out)), None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._side_stream):
            out = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                   for a in host]
            arrays = (self._gather_epoch(out[0]) if self._dev_x is not None
                      else tuple(out))
            event = torch.cuda.Event()
            event.record(self._side_stream)
        return arrays, event

    @staticmethod
    def _take_staged(staged):
        """The arrays of a ``_finish_epoch`` result, ordered on the current
        stream after their side-stream copy (a CUDA event wait, no host
        sync) and handed over to its allocator."""
        arrays, event = staged
        if event is not None:
            cur = torch.cuda.current_stream(arrays[0].device)
            cur.wait_event(event)
            for t in arrays:
                t.record_stream(cur)
        return arrays

    def _stage_epoch(self, last: bool = False):
        """Device arrays (xb, yb, wb) of the next epoch: the look-ahead's
        when it staged this counter, else built now."""
        c = self._epochs_staged
        self._epochs_staged += 1
        ahead, self._staged_ahead = self._staged_ahead, None
        if ahead is not None and ahead[0] == c:
            _, payload, needs_finish = ahead
            return self._take_staged(self._finish_epoch(payload)
                                     if needs_finish else payload)
        return self._take_staged(self._finish_epoch(self._epoch_raw(c, last)))

    def _fused_epoch_rows(self):
        """A fused round's [Nepoch, K, steps*B] row indices on the device
        and the epochs' counters; advances the counter by Nepoch, the
        bookkeeping of the unfused loop, so a checkpoint taken after a
        fused round resumes identically on either path."""
        c0, n = self._epochs_staged, self.cfg.Nepoch
        total = self._total_epochs()
        idx = np.stack([self._epoch_raw(c0 + e, last=c0 + e == total - 1)
                        for e in range(n)])
        self._epochs_staged += n
        return torch.from_numpy(idx).to(self.device), list(range(c0, c0 + n))

    def _prestage_round(self) -> float:
        """Staging/comm overlap (cfg.overlap_staging): stage the next epoch
        now, between the comm step's launch and the host's first read of
        its results.  A pure look-ahead on the counter: only consumption
        (:meth:`_stage_epoch`) advances it, so checkpoints and a kill and
        resume are exact.  Times the host work of the look-ahead, not its
        copy (no sync); 0.0 when there is nothing left to stage.  Under
        population the cohort is not drawn yet: the host half is staged
        and finished at consumption."""
        total = self._total_epochs()
        c = self._epochs_staged
        if c >= total or self._staged_ahead is not None:
            return 0.0
        t0 = time.perf_counter()
        raw = self._epoch_raw(c, last=c == total - 1)
        if self._pop_active:
            self._staged_ahead = (c, raw, True)
        else:
            self._staged_ahead = (c, self._finish_epoch(raw, ahead=True),
                                  False)
        return time.perf_counter() - t0

    def _predispatch_round(self, coords, state, z, y, rho, cnorm) -> float:
        """Round-level overlap (cfg.overlap_round): launch the next round's
        first local epoch now, behind this round's comm step, before the
        host reads this round's results.  Its inputs are the comm step's
        outputs (read, not changed) and the staging look-ahead's epoch;
        its activity mask is the stateless participation draw of
        ``coords``.  Values are those of the sequential loop; the counter
        advances when :meth:`_take_round_ahead` consumes the result.
        Returns the host seconds of the launch, 0.0 when skipped."""
        c = self._epochs_staged
        if c >= self._total_epochs():
            return 0.0
        t0 = time.perf_counter()
        self._prestage_round()
        # population, whose payload waits for the cohort, is gated off
        assert self._staged_ahead is not None and not self._staged_ahead[2]
        nloop, ci, nadmm = coords
        active = None
        if self._block_flags(ci)[0]:
            active = (np.ones(self.cfg.K, np.float32)
                      if self.cfg.participation >= 1.0
                      else self._participation_host(nloop, ci, nadmm))
        xb, yb, wb = self._take_staged(self._staged_ahead[1])
        out = self.train_epoch(state, ci, y, z, rho, xb, yb, wb, c,
                               active=active, norm=cnorm)
        self._round_ahead = (coords, c, out)
        return time.perf_counter() - t0

    def _take_round_ahead(self, coords):
        """The pre-launched epoch's (state, losses) if it was launched for
        this round at the current counter (else None: recompute);
        advances the counter as the sequential ``_stage_epoch`` would."""
        ra, self._round_ahead = self._round_ahead, None
        if ra is None:
            return None
        rc, c, out = ra
        if rc != coords or c != self._epochs_staged:
            return None
        self._epochs_staged += 1
        self._staged_ahead = None
        self._host_dispatches += 1
        return out

    def close(self) -> None:
        """Release the stage pool (a pending prefetch is dropped) and drain
        the async checkpoint writer, so an aborted run's last submitted
        round is still on disk; a write failure here does not mask the
        exception that ended the run (a normal exit re-raises it)."""
        self._pending = self._staged_ahead = self._round_ahead = None
        if self._stage_pool is not None:
            self._stage_pool.shutdown(wait=True)
            self._stage_pool = None
        try:
            self._flush_ckpt_writer()
        except Exception:
            pass

    def _flush_ckpt_writer(self) -> None:
        """Write barrier: wait for queued async saves, retire the writer
        (re-raises a background failure)."""
        writer, self._ckpt_writer = self._ckpt_writer, None
        if writer is not None:
            writer.close()

    # ------------------------------------------------------------------
    # the local epoch and the comm step
    # ------------------------------------------------------------------
    def noise(self, words: Sequence[int], batch: int):
        """The reparametrisation noise of a batch of ``batch`` rows drawn
        from the seed words ``words`` (``None`` for a model without noise):
        ``(cfg.seed, epoch counter, client, step)`` in training,
        :data:`EVAL_NOISE_WORDS` in evaluation."""
        if self.noise_shape is None:
            return None
        return self.normal(words, self.noise_shape(batch), self.device)

    def model_loss(self, p, bs, xb, yb, wb, noise=None):
        """Per-batch classifier loss -> (scalar, new batch_stats).  The pad
        rows of the last partial minibatch (weight 0) are out of the loss
        and, unless the data has no partial batch, out of the BN stats.
        ``noise``: the step's reparametrisation draw (unused here)."""
        bn_w = None if getattr(self.data, "remainder", 1) == 0 else wb
        logits, new_bs = self.model.apply(p, bs, xb, train=True,
                                          sample_weight=bn_w)
        return cross_entropy(logits, yb, wb), new_bs

    def _sanitized(self, kind: str, ci):
        """The sanitizer's scope of one instrumented step (``--sanitize``;
        a no-op context when it is off)."""
        return sanitize.scope(
            self._sanitizer,
            f"{kind} (block {ci}, round {self._sanitize_round})")

    def train_epoch(self, state: ClientState, ci: Optional[int], *args,
                    **kwargs):
        """:meth:`_train_epoch` as one instrumented step."""
        with self._sanitized("train step", ci):
            return self._train_epoch(state, ci, *args, **kwargs)

    def _train_epoch(self, state: ClientState, ci: Optional[int], y, z, rho,
                     xb, yb, wb, counter: int = 0, active=None, norm=None):
        """One local epoch (number ``counter``, which keys the noise) of
        every client on block ``ci`` (``None``: the whole net); returns the
        new state and the [K] per-client sums of the step losses.
        ``active`` (numpy [K], None: every client): the clients that train;
        the others keep their parameters, statistics and optimizer state
        bit for bit and their loss reads 0.  ``norm``: the [K, 2, 3]
        normalisation of the slots (default the clients' own)."""
        cfg, algo = self.cfg, self.algo
        order, mask = self.order, self.mask_for_block(ci)
        lam1, lam2 = self.reg_for_block(ci)
        reg_on = lam1 != 0.0 or lam2 != 0.0
        lbfgs = self.optimizer_for_block(ci) == "lbfgs"
        lr = self.lr_for_block(ci)
        norm = self.client_norm if norm is None else norm
        opt = state.opt_state
        X = codec.get_trainable_stack(state.params, order, mask)
        xs, opts, bss, losses = [], [], [], []
        steps = xb.shape[1]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        for k in range(cfg.K):
            bsk = tree_map(lambda t: t[k], state.batch_stats)
            xk = X[k]
            ok = opt[k] if lbfgs else (opt.mu[k], opt.nu[k])
            if active is not None and not active[k] > 0:
                xs.append(xk)
                opts.append(ok)
                bss.append(bsk)
                losses.append(zero)
                continue
            pk = tree_map(lambda t: t[k], state.params)
            count0 = 0 if lbfgs else int(opt.count[k])
            step_losses = []
            for step in range(steps):
                xn = _normalize_u8(xb[k, step], norm[k])
                # one draw a step: the line search's evaluations share it
                noise = self.noise((cfg.seed, counter, k, step),
                                   xb.shape[2])

                def batch_loss(v, xn=xn, step=step, bsk=bsk, noise=noise):
                    p = codec.put_trainable_values(pk, order, mask, v)
                    loss, new_bs = self.model_loss(p, bsk, xn, yb[k, step],
                                                   wb[k, step], noise)
                    loss = loss + algo.penalty(v, z, y[k], rho)
                    if reg_on:
                        loss = loss + l1_l2(v, lam1, lam2)
                    return loss, new_bs

                if lbfgs:
                    # the closure is the flat loss of the active block; a
                    # BN-free model has no statistics to carry
                    xk, ok, loss = self.lbfgs.step(
                        lambda v: batch_loss(v)[0], xk, ok)
                else:
                    v = xk.detach().requires_grad_(True)
                    loss, bsk = batch_loss(v)
                    (g,) = torch.autograd.grad(loss, v)
                    with torch.no_grad():
                        xk, mu, nu = adam_step(xk, g, *ok,
                                               count0 + step + 1, lr)
                    ok = (mu, nu)
                step_losses.append(loss.detach())
            xs.append(xk)
            opts.append(ok)
            bss.append(bsk)
            losses.append(torch.stack(step_losses).sum())
        params = codec.put_trainable_stack(state.params, order, mask,
                                           torch.stack(xs))
        batch_stats = tree_stack(bss) if self.has_bn else state.batch_stats
        if not lbfgs:
            ran = (torch.ones(cfg.K, dtype=torch.int64) if active is None
                   else torch.from_numpy(np.asarray(active) > 0).long())
            opts = AdamState(torch.stack([m for m, _ in opts]),
                             torch.stack([n for _, n in opts]),
                             opt.count + steps * ran)
        return (ClientState(params, batch_stats, opts, state.comp),
                torch.stack(losses))

    def _block_flags(self, ci: int):
        """Block ``ci``'s round shape ``(partial, corruption)``: whether
        its rounds carry activity masks, and the ``(mode, scale)`` its
        exchange poisons corrupted deltas with (None: no corruption).  Read
        from the fault spec in force when the block is first built, at its
        start before the round's campaign tick, and kept for the trainer's
        life (a compressor swap rebuilds): the JAX engine bakes both into
        the step it compiles and caches a block.  Under a campaign a window
        that turns faults on or off mid-block therefore changes the draws
        and the round record's counts, but not this shape."""
        flags = self._flag_cache.get(ci)
        if flags is None:
            f = self.faults
            partial = self._partial
            corruption = ((f.mode, f.scale) if f.enabled and f.corrupt > 0
                          else None)
            flags = self._flag_cache[ci] = (partial, corruption)
        return flags

    def _comm_mode(self, nadmm: int) -> str:
        """plain | bb_store (round 0 of a block) | bb (every bb_period_T
        rounds) — consensus_multi.py:242-278."""
        cfg = self.cfg
        if cfg.bb_update and nadmm == 0:
            return "bb_store"
        if cfg.bb_update and nadmm > 0 and nadmm % cfg.bb_period_T == 0:
            return "bb"
        return "plain"

    def comm_round(self, state: ClientState, ci: int, *args, **kwargs):
        """:meth:`_comm_round` as one instrumented step."""
        with self._sanitized("comm step", ci):
            return self._comm_round(state, ci, *args, **kwargs)

    def _comm_round(self, state: ClientState, ci: int, z, y, rho, x0, yhat0,
                    mode: str = "plain", active=None, corrupt=None,
                    gbound=None):
        """The communication round of block ``ci``.  On a partial round
        (``_block_flags``) ``active`` is the [K] activity vector (0/1, or
        the async staleness weights), ``corrupt`` the [K] 0/1 corruption
        indicator and ``gbound`` the guard's norm bound; the three are
        ignored on the full-participation round.  Returns (state, z, y,
        rho, x0, yhat0, diag, okf): ``okf`` the [K] guard verdicts (None
        with the guard off).  With the client record on, ``_client_norms``
        holds the [K] ``||x_k - z||`` and ``||x_k - z_new||``."""
        cfg = self.cfg
        K = cfg.K
        order, mask = self.order, self.mask_for_block(ci)
        partial, corruption = self._block_flags(ci)
        guard_on = cfg.update_guard
        dev = z.device
        if partial:
            active = torch.as_tensor(np.asarray(active, np.float32),
                                     device=dev)
        x = codec.get_trainable_stack(state.params, order, mask)
        if corruption is not None:
            # the wire delta is poisoned before compression, where a faulty
            # client corrupts a real deployment; the EF residual sees it
            c = torch.as_tensor(np.asarray(corrupt, np.float32), device=dev)
            x = z[None, :] + apply_corruption(
                x - z[None, :], c, *corruption, w=active, mesh=self.mesh)
        comp = state.comp
        mean_fn = self.mean_fn
        if self.compressor.name != "none":
            # uplink-compress the deltas x_k - z: every update below (mean,
            # duals, BB) runs on the reconstructions the server sees
            payload, comp_new = self.compressor.encode(x - z[None, :], comp)
            if self._fused_coll and self.compressor.sparse:
                # the k-sized payloads go over the wire themselves
                mean_fn = make_sparse_fused_mean(payload, z, K, self.mesh)
            x = z[None, :] + decode_stack(payload, self.compressor, x.shape[1])
            if partial and comp is not None:
                # a non-participant's stream and residual stay untouched
                comp_new = _sel(active, comp_new, comp)
            comp = comp_new
        w = active if partial else None
        # the client record's probe: each client's raw ||x_k - z|| on what
        # the round folds (a non-finite delta stays visible here)
        probe = self._client_probe
        cl_nrm = torch.linalg.vector_norm(x - z[None, :], dim=1) \
            if probe else None
        okf = None
        if guard_on:
            # every incoming delta must be finite and within the bound;
            # selects only, so no NaN reaches the aggregation
            d = x - z[None, :]
            finite = torch.isfinite(d).all(dim=1)
            nrm = torch.linalg.vector_norm(
                torch.where(finite[:, None], d, torch.zeros_like(d)), dim=1)
            bound = torch.as_tensor(np.float32(gbound), device=dev)
            okf = (finite & (nrm <= bound)).to(torch.float32)
            w = active * okf
            psum = lambda v: self.mesh.psum([s.sum() for s in
                                             self.mesh.shards(v)])
            n_ok = psum(w)
            n_trip = psum(active * (1.0 - okf))
            norm_mean = psum(w * nrm) / torch.clamp(n_ok, min=1.0)
            # rejected rows are neutralised to z
            x = torch.where(okf[:, None] > 0, x, z[None, :])
            if comp is not None and self.compressor.name != "none":
                # a rejected round's residual came from the rejected delta:
                # reset it, keep the stream state
                comp = _sel(1.0 - active * (1.0 - okf), comp,
                            self.compressor.reset_state(comp))
        if mode == "bb_store":
            x0 = x
        elif mode == "bb":
            rho, x0, yhat0 = bb_rho_update(
                x, z, y, rho, x0, yhat0,
                BBConfig(cfg.bb_period_T, cfg.bb_alphacorrmin,
                         cfg.bb_epsilon, cfg.bb_rhomax))
        znew, ynew, diag = self.algo.global_update(
            x, z, y, rho, K, self.mesh, w=w, mean_fn=mean_fn)
        if guard_on:
            # an all-rejected round keeps z
            znew = torch.where(n_ok > 0, znew, z)
            diag["guard_trips"] = n_trip
            diag["guard_norm_mean"] = norm_mean
            diag["n_ok"] = n_ok
        self._client_norms = ((cl_nrm, torch.linalg.vector_norm(
            x - znew[None, :], dim=1)) if probe else (None, None))
        params = state.params
        if self.algo.writeback:
            wrote = codec.put_trainable_stack(
                params, order, mask, znew.unsqueeze(0).expand(K, -1))
            # only the round's accepted participants receive z
            params = _sel(w, wrote, params) if partial else wrote
        if partial:
            diag["n_active"] = self.mesh.psum(
                [s.sum() for s in self.mesh.shards(active)])
        return (ClientState(params, state.batch_stats, state.opt_state, comp),
                znew, ynew, rho, x0, yhat0, diag, okf)

    def eval_batch_metric(self, p, bs, xb, yb, wb):
        """One test batch's metric, summed over the evaluation (classifier:
        the correct count; the pad rows carry weight 0)."""
        logits, _ = self.model.apply(p, bs, xb, train=False)
        return accuracy_count(logits, yb, wb)

    def eval_finalize(self, totals: np.ndarray, n_samples: int) -> np.ndarray:
        """Classifier: percent accuracy (federated_multi.py:121)."""
        return 100.0 * totals / n_samples

    @torch.no_grad()
    def evaluate(self, state: ClientState) -> np.ndarray:
        """Per-client metric over the whole test set (the wrap-pad rows
        weighted out): top-1 accuracy (%) for the classifiers."""
        totals = []
        for k in range(self.cfg.K):
            pk = tree_map(lambda t: t[k], state.params)
            bsk = tree_map(lambda t: t[k], state.batch_stats)
            acc = torch.zeros((), dtype=torch.float32, device=self.device)
            for b in range(self.test_x.shape[0]):
                acc = acc + self.eval_batch_metric(
                    pk, bsk, _normalize_u8(self.test_x[b], self.client_norm[k]),
                    self.test_y[b], self.test_w[b])
            totals.append(acc)
        return self.eval_finalize(torch.stack(totals).cpu().numpy(),
                                  self.test_n)

    def _serve_export(self, state: ClientState):
        """The served consensus: the mean over the [K] client stack of
        (params, batch_stats), computed into new tensors (a read: the
        trainer keeps using ``state``)."""
        return consensus_weights((state.params, state.batch_stats))

    def _build_serve_plane(self, sched) -> dict:
        """The serving runtime of the classifier-shaped engines: the head
        in a bucketed predictor over the eval-mode forward ``evaluate``
        runs, the double-buffered hot-swap, the micro-batcher and a host
        traffic pool of the test rows whose weight is > 0 (uint8).  The
        consensus reads the mean of the clients' normalisation statistics.
        The classifier gets the eval stream (``serve_drift``'s feed).  A
        model with reparametrisation noise has no served forward: the JAX
        serve forward calls it without its noise argument and fails at the
        first dispatch, and so does this one, with a ValueError."""
        dev = self.device
        norm = torch.from_numpy(np.asarray(
            self._client_norm_host.mean(axis=0), np.float32)).to(dev)
        model, noisy = self.model, self.noise_shape is not None

        def forward(weights, xb_u8):
            if noisy:
                raise ValueError(
                    f"the {self.obs_engine!r} engine cannot serve: its "
                    "forward needs reparametrisation noise, which the "
                    "serve forward does not pass (the JAX serve forward "
                    "calls the model without its rng argument)")
            p, bs = weights
            return model.apply(p, bs, _normalize_u8(xb_u8, norm),
                               train=False)[0]

        head_key = "vae" if self.obs_engine.startswith("vae") else "classifier"
        pred = BatchedPredictor(HEADS[head_key](forward), sched.buckets,
                                stage=lambda a: torch.from_numpy(a).to(dev))
        plane: dict = {"buffer": DoubleBuffer(), "pred": pred}
        # the dispatch reads the tick's acquired snapshot: one weights
        # version a drained round
        plane["batcher"] = MicroBatcher(
            sched, lambda batch: pred(plane["current"], batch),
            max_queue=1 << 20)
        xt = self.test_x.cpu().numpy()
        keep = self.test_w.cpu().numpy().reshape(-1) > 0
        plane["pool_x"] = xt.reshape((-1,) + xt.shape[2:])[keep]
        plane["pool_y"] = self.test_y.cpu().numpy().reshape(-1)[keep]
        plane["pool_n"] = int(plane["pool_x"].shape[0])
        plane["stream"] = (EvalStream(sched, window=self.cfg.health_window)
                           if head_key == "classifier" else None)
        return plane

    def round_bytes_on_wire(self, N: int, n_active: int) -> int:
        """Uplink bytes of a round: every participant ships one encoded
        block payload (the float32 block on the dense path)."""
        return int(n_active) * int(self.compressor.bytes_on_wire(N))

    def round_bytes_fused(self, N: int) -> int:
        """Predicted device-to-device bytes of the fused collective this
        round: the packed reduce-scatter and all-gather."""
        return int(fused_bytes_on_wire(self.compressor, N, self.D, self.cfg.K))

    # ------------------------------------------------------------------
    # the loop nest
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, state: Optional[ClientState] = None,
            log: Callable[[str], None] = print,
            checkpoint_path: Optional[str] = None, resume: bool = False):
        """Nloop x blocks x Nadmm rounds; returns (state, history), one
        record per communication round.  ``checkpoint_path``: save a
        mid-run checkpoint after every round; ``resume``: continue from
        its newest usable slot, if one exists."""
        try:
            with profile_ctx(self.cfg.profile_dir, self.device):
                return self._run(state, log, checkpoint_path, resume)
        except BaseException:
            # the stream gets its summary, flagged aborted (a no-op when
            # the run closed it)
            if self.obs_recorder is not None:
                self.obs_recorder.close(status="aborted")
            raise
        finally:
            self.close()

    # ------------------------------------------------------------------
    # mid-run checkpoint / resume: params, statistics, the block's
    # optimizer and compressor state, z/y/rho/BB state, the epoch counter
    # (the whole data-order state) and the kernel's ledgers
    # ------------------------------------------------------------------
    def _save_midrun(self, path: str, state: ClientState, blockvars, nxt,
                     history) -> None:
        nloop, ci, nadmm = nxt
        mid_block = nadmm > 0
        tree = {**ckpt.flatten_dict(state.params, "params/"),
                **ckpt.flatten_dict(state.batch_stats, "batch_stats/")}
        if mid_block:       # block vars matter only inside a block
            for i, leaf in enumerate(leaves(state.opt_state)):
                tree[f"opt/{i}"] = torch.as_tensor(leaf)
            for i, leaf in enumerate(leaves(state.comp)):
                tree[f"comp/{i}"] = leaf
            tree.update(zip(("z", "y", "rho", "x0", "yhat0"), blockvars))
        meta = {
            "nloop": nloop, "ci": ci, "nadmm": nadmm,
            "mid_block": int(mid_block),
            # epochs are keyed on this counter: the data-order state
            "epochs_staged": self._epochs_staged,
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
        # mesh.  Every saved tensor is a [K, ...] client stack (params,
        # statistics, optimizer and codec state, EF residuals, y, x0,
        # yhat0) or replicated (z, rho); the padded [K, D*seg] stacks of
        # the fused collective and the chunked estimators live inside a
        # round only, so nothing saved depends on D
        ckpt.validate_geometry(meta, devices=self.D, processes=1,
                               K=self.cfg.K, elastic=self.cfg.elastic_resume)
        dev = self.device
        on_dev = lambda t: tree_map(lambda v: v.to(dev), t)
        params = on_dev(ckpt.unflatten_dict(tree, "params/"))
        batch_stats = on_dev(ckpt.unflatten_dict(tree, "batch_stats/"))
        mid = bool(meta["mid_block"])
        opt = comp = blockvars = None
        if mid:
            ci = int(meta["ci"])
            n_opt = sum(1 for k in tree if k.startswith("opt/"))
            opt = unflatten_like(self.init_opt(params, ci),
                                 [tree[f"opt/{i}"] for i in range(n_opt)])
            comp = self._init_comp_state(ci)
            if comp is not None:
                comp = unflatten_like(comp, [tree[f"comp/{i}"] for i in
                                             range(len(leaves(comp)))])
            blockvars = tuple(tree[k].to(dev)
                              for k in ("z", "y", "rho", "x0", "yhat0"))
        state = ClientState(params, batch_stats, opt, comp)
        # a pending prefetch whose counter differs is dropped at the next
        # _stage_epoch (epochs are pure functions of the counter)
        self._epochs_staged = int(meta["epochs_staged"])
        self._restore_ledger_meta(meta)
        history = ckpt.unpack_history(meta["history"])
        return state, blockvars, (int(meta["nloop"]), int(meta["ci"]),
                                  int(meta["nadmm"]), mid), history

    @staticmethod
    def _check_restored_finite(restored) -> None:
        """Reject a restored snapshot whose params or z/y carry NaN or inf:
        checksum-valid but a replay of the failure, so the slot walk falls
        back to the next-older slot."""
        state, blockvars = restored[0], restored[1]
        vals = leaves(state.params)
        if blockvars is not None:
            vals += [blockvars[0], blockvars[1]]
        for t in vals:
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise ValueError("restored state carries non-finite values "
                                 "(poisoned checkpoint)")

    def _resume(self, checkpoint_path: str, log):
        """Walk the slots newest first; returns the first usable one's
        restore, or None when there is no slot.  A slot that fails its
        checksum, its load or the finite screen is skipped; a geometry
        error is not (every slot has the same geometry)."""
        failures = []
        for slot in ckpt.checkpoint_slots(checkpoint_path):
            try:
                ckpt.verify_checkpoint(slot)
                restored = self._restore_midrun(slot)
                self._check_restored_finite(restored)
            except ckpt.CheckpointGeometryError:
                raise
            except Exception as e:
                failures.append(f"{slot}: {e}")
                log(f"WARNING: checkpoint slot {slot} is unusable ({e}); "
                    "falling back to the previous slot")
                continue
            log(f"resumed mid-run checkpoint {slot} at "
                f"(nloop, block, nadmm)={restored[2][:3]}")
            return restored
        if failures:
            raise ckpt.CheckpointCorruptError(
                "no valid mid-run checkpoint slot survives: "
                + "; ".join(failures))
        return None

    def _obs_epoch_images(self) -> int:
        """Images a local epoch of all clients processes (K * steps *
        batch, pad rows included); a round covers ``cfg.Nepoch`` of
        these."""
        steps = getattr(self.data, "steps", None)
        batch = getattr(self.data, "batch", None)
        if not steps or not batch:
            return 0
        return int(self.cfg.K * steps * batch)

    def _apply_block_control(self, obs, log=print) -> None:
        """Act-mode block-scope decisions (the compressor swap), at the
        block boundary before the block's compressor state is built, as
        if the run had been constructed with the new compressor.  A swap
        the construction rules forbid (a dense wire, or a sparse wire
        under a fused dual-state collective) is skipped and logged."""
        for d in obs.control.take_block():
            if d.param != "compress":
                continue
            new = str(d.to_value)
            if new == self.cfg.compress:
                continue
            comp = make_compressor(new, topk_frac=self.cfg.topk_frac,
                                   quant_chunk=self.cfg.quant_chunk,
                                   error_feedback=self.cfg.error_feedback)
            if self._fused_coll and comp.name == "none":
                log("control: skip compress -> none (fused_collective "
                    "needs a packed wire format)")
                continue
            if self._fused_coll and comp.sparse and self.algo.needs_dual:
                log(f"control: skip compress -> {new} (sparse wire is "
                    "unavailable under a fused dual-state collective)")
                continue
            old = self.cfg.compress
            with self._cfg_swap_lock:
                self.compressor = comp
                self.cfg = dataclasses.replace(self.cfg, compress=new)
                if self._fused_coll:
                    self.mean_fn = (None if comp.sparse else make_fused_mean(
                        comp, self.mesh, self.cfg.K))
            # the blocks are rebuilt as the JAX engine recompiles its steps
            self._flag_cache.clear()
            log(f"control: {d.intervention} compress {old} -> {new} at "
                f"block boundary ({d.reason})")

    def _run(self, state, log, checkpoint_path=None, resume=False):
        cfg, algo = self.cfg, self.algo
        K, dev = cfg.K, self.device
        state = state or self.init_state()
        history: List[Dict[str, Any]] = []
        f32 = dict(dtype=torch.float32, device=dev)
        resume_at = r_blockvars = None
        if resume and checkpoint_path is not None:
            restored = self._resume(checkpoint_path, log)
            if restored is not None:
                state, r_blockvars, resume_at, history = restored
        # one-shot preemption: a resumed segment replaying the drawn round
        # must not fire again
        self._preempt_armed = resume_at is None
        self._campaign_resume_floor(resume_at is not None, len(history))
        if cfg.async_checkpoint and checkpoint_path is not None \
                and self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointWriter()
        obs = self._open_obs(resumed=resume_at is not None,
                             rounds_prior=len(history))
        if obs.control is not None:
            # a restart decision needs a checkpoint to restart from
            obs.control.can_restart = checkpoint_path is not None
        obs_images = cfg.Nepoch * self._obs_epoch_images()
        profile_on = cfg.profile_dir is not None
        for nloop in range(cfg.Nloop):
            for ci in range(self.L):
                if resume_at is not None and (nloop, ci) < resume_at[:2]:
                    continue
                if obs.control is not None:
                    self._apply_block_control(obs, log)
                # the block's round shape, from the fault spec in force now
                self._block_flags(ci)
                N = self.block_size(ci)
                nadmm_start = 0
                if (resume_at is not None and (nloop, ci) == resume_at[:2]
                        and resume_at[3]):
                    # resume inside this block
                    z, y, rho, x0, yhat0 = r_blockvars
                    nadmm_start = resume_at[2]
                    resume_at = None
                else:
                    resume_at = None
                    z = torch.zeros(N, **f32)
                    y = torch.zeros(K, N if algo.needs_dual else 1, **f32)
                    rho = torch.tensor(cfg.admm_rho0, **f32)
                    x0 = torch.zeros(K, N if cfg.bb_update else 1, **f32)
                    yhat0 = (codec.get_trainable_stack(
                        state.params, self.order, self.mask_for_block(ci))
                        if cfg.bb_update else torch.zeros(K, 1, **f32))
                    state = ClientState(state.params, state.batch_stats,
                                        self.init_opt(state.params, ci),
                                        self._init_comp_state(ci))
                    # a fresh block: fresh guard scale, async updates void
                    self._reset_block_ledgers()
                for nadmm in range(nadmm_start, cfg.Nadmm):
                    with round_trace(len(history), enabled=profile_on):
                        state, z, y, rho, x0, yhat0 = self._step_round(
                            obs, obs_images, state, (z, y, rho, x0, yhat0),
                            nloop, ci, nadmm, N, history, checkpoint_path,
                            log)
        obs.close()
        # write barrier: every queued save is durable before the caller
        # sees the run finished (a failed background save surfaces here)
        self._flush_ckpt_writer()
        return state, history

    def _read_async(self, tensors):
        """Start the device-to-host copy of ``tensors`` and return a
        function that waits for it and gives them as numpy arrays of their
        own dtypes.  On the card the copy goes into pinned memory behind an
        event, so work launched after this call (the overlap's pre-launch)
        does not hold the read back."""
        if self.device.type != "cuda":
            host = [t.detach().cpu().numpy() for t in tensors]
            return lambda: host
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors])
        buf = torch.empty(flat.shape, dtype=torch.float64, pin_memory=True)
        buf.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()

        def wait():
            event.synchronize()
            out, i = [], 0
            for t in tensors:
                a = buf[i:i + t.numel()].numpy()
                out.append(a.astype(torch.empty(0, dtype=t.dtype).numpy()
                                    .dtype).reshape(tuple(t.shape)))
                i += t.numel()
            return out
        return wait

    def _step_round(self, obs, obs_images, state, blockvars, nloop, ci,
                    nadmm, N, history, checkpoint_path, log):
        """One communication round of block ``ci``; returns the state and
        the block variables (z, y, rho, x0, yhat0) after it."""
        cfg, algo = self.cfg, self.algo
        K, dev = cfg.K, self.device
        partial = self._block_flags(ci)[0]
        z, y, rho, x0, yhat0 = blockvars
        t_round = time.perf_counter()
        self._sanitize_round = len(history)
        launches0 = _launch_counts()
        # the campaign tick first: it derives this round's fault spec (and
        # may raise its deterministic preemption) before any family draws
        self._campaign_tick(len(history), nloop, ci, nadmm, checkpoint_path)
        self._maybe_preempt(nloop, ci, nadmm, len(history), checkpoint_path)
        train_m, comm_m, corrupt, comm_host, fcounts = \
            self._round_activity(nloop, ci, nadmm)
        n_comm = fcounts.pop("n_comm", 1)
        cnorm = self.client_norm
        if self._pop_active:
            # the cohort rotated: move the compressor/EF rows and point
            # slot k's normalisation at its shard
            if leaves(state.comp):
                state = state._replace(
                    comp=self._population_swap_comp(state.comp, ci))
            rows = (self._cohort % K).astype(np.int64)
            cnorm = torch.from_numpy(self._client_norm_host[rows]).to(dev)
        if (self._churn_live and self._rejoined_mask.any()
                and leaves(state.comp)):
            # rejoining clients are new clients: fresh rows
            state = state._replace(comp=self._reset_comp_rows(
                state.comp, ci, self._rejoined_mask))
        q_start = (int(np.sum(self._quarantine > 0))
                   if cfg.update_guard else 0)
        loss_acc = None
        stage_s = overlap_s = overlap_dispatch_s = 0.0
        phase_marks = []
        dispatch0 = self._host_dispatches
        diag: Dict[str, Any] = {}
        okf = None
        self._client_norms = (None, None)
        comm_ran = algo.communicates and n_comm > 0
        predispatch = (self._overlap_round and comm_ran
                       and nadmm + 1 < cfg.Nadmm)
        # a fused round (cfg.fused_rounds) runs the same epochs and update
        # as one host call: the round's Nepoch row indices go to the device
        # up front, its only host-to-device traffic; nothing syncs or reads
        # the host before the round's reads behind the comm step (blocks
        # whose optimizer is L-BFGS excepted: the line search reads the
        # host every step), and the whole call is train time
        fused = self._use_fused and comm_ran
        if fused:
            t_stage = time.perf_counter()
            rows_dev, counters = self._fused_epoch_rows()
            self._obs_sync(obs)
            stage_s = time.perf_counter() - t_stage
            self._host_dispatches += 1
            if obs.enabled:
                phase_marks.append(("stage", "phase", t_stage,
                                    t_stage + stage_s))
        # a fused round is one instrumented step: its epochs and comm step
        # run inside it and are checked once, after the comm step
        with (self._sanitized("fused round", ci) if fused
              else contextlib.nullcontext()):
            t_train = time.perf_counter()
            for nepoch in range(cfg.Nepoch):
                ahead = (self._take_round_ahead((nloop, ci, nadmm))
                         if nepoch == 0 and self._overlap_round else None)
                t_stage = time.perf_counter()
                if ahead is not None:
                    # launched behind the previous round's comm step
                    # (cfg.overlap_round): same inputs, same values
                    state, losses = ahead
                    t_staged = t_stage
                else:
                    if fused:
                        counter = counters[nepoch]
                        xb, yb, wb = self._gather_epoch(rows_dev[nepoch])
                    else:
                        counter = self._epochs_staged
                        xb, yb, wb = self._stage_epoch(
                            last=(nloop == cfg.Nloop - 1 and ci == self.L - 1
                                  and nadmm == cfg.Nadmm - 1
                                  and nepoch == cfg.Nepoch - 1))
                        self._obs_sync(obs)
                        self._host_dispatches += 1
                        stage_s += time.perf_counter() - t_stage
                    t_staged = time.perf_counter()
                    state, losses = self.train_epoch(
                        state, ci, y, z, rho, xb, yb, wb, counter,
                        active=train_m if partial else None, norm=cnorm)
                loss_acc = losses if loss_acc is None else loss_acc + losses
                if cfg.be_verbose:
                    # per-client epoch losses (the reference's be_verbose
                    # prints, federated_multi.py:199-200): the only host
                    # sync inside the epoch loop
                    log(f"verbose: block={ci} nadmm={nadmm} epoch={nepoch} "
                        "client_loss=" + np.array2string(losses.cpu().numpy(),
                                                         precision=4))
                if obs.enabled and not fused:
                    self._obs_sync(obs)
                    if ahead is None:
                        phase_marks.append(("stage", "phase", t_stage,
                                            t_staged))
                    phase_marks.append(("train", "phase", t_staged,
                                        time.perf_counter()))
            if not fused:
                self._sync()
            t_comm = time.perf_counter()
            if comm_ran:
                state, z, y, rho, x0, yhat0, diag, okf = self.comm_round(
                    state, ci, z, y, rho, x0, yhat0, self._comm_mode(nadmm),
                    active=comm_m, corrupt=corrupt,
                    gbound=self._round_gbound())
                # the reads of the round, queued behind the comm step
                reads = self._read_async(self._round_values(loss_acc, rho,
                                                            diag, okf))
                if self._overlap and not fused:
                    # the comm step runs on the card meanwhile
                    t_ov = time.perf_counter()
                    overlap_s = self._prestage_round()
                    if obs.enabled and overlap_s > 0:
                        phase_marks.append(("overlap", "phase", t_ov,
                                            t_ov + overlap_s))
                if predispatch and not obs.enabled:
                    # before the host waits on this round's reads: the
                    # queue does not drain across the round boundary
                    overlap_dispatch_s = self._predispatch_round(
                        (nloop, ci, nadmm + 1), state, z, y, rho, cnorm)
            else:
                reads = self._read_async(self._round_values(loss_acc, rho,
                                                            {}, None))
                if algo.communicates:
                    # every client out of the exchange: no collective,
                    # z/y/rho carry over, quarantine still ticks
                    diag = {"n_active": 0.0}
                    if cfg.update_guard:
                        diag.update(guard_trips=0.0, n_ok=0.0)
                        self._quarantine = np.maximum(self._quarantine - 1, 0)
        if overlap_dispatch_s > 0:
            # the comm span ends with the round's reads (a sync would
            # wait for the pre-launched epoch too)
            reads()
        else:
            self._sync()
        t_done = time.perf_counter()
        if fused:
            train_s, comm_s = t_done - t_train, 0.0
            if obs.enabled:
                phase_marks.append(("train", "phase", t_train, t_done))
        else:
            train_s, comm_s = t_comm - t_round - stage_s, t_done - t_comm
            if obs.enabled and algo.communicates:
                phase_marks.append(("comm", "phase", t_comm, t_done))
        if predispatch and obs.enabled:
            # with a recorder writing, the pre-launch follows the comm
            # span, which keeps measuring the comm step alone
            t_ov = time.perf_counter()
            overlap_dispatch_s = self._predispatch_round(
                (nloop, ci, nadmm + 1), state, z, y, rho, cnorm)
            if overlap_dispatch_s > 0:
                phase_marks.append(("overlap_dispatch", "phase", t_ov,
                                    t_ov + overlap_dispatch_s))
        vals = reads()
        loss_host, rho_host = vals[0], float(vals[1])
        if comm_ran:
            diag = {k: float(v) for k, v in zip(diag, vals[2:])}
            if cfg.update_guard:
                self._apply_guard_verdicts(diag, vals[2 + len(diag)],
                                           comm_host)
        cl_nrm, cl_dist = (vals[-2], vals[-1]) if self._client_probe \
            and self._client_norms[0] is not None else (None, None)
        rec = dict(nloop=nloop, block=ci, nadmm=nadmm, N=N,
                   loss=float(np.sum(loss_host)), rho=rho_host,
                   round_seconds=time.perf_counter() - t_round,
                   stage_seconds=stage_s, train_seconds=train_s,
                   comm_seconds=comm_s, **fcounts, **diag)
        if self._overlap:
            # host seconds of the staging look-ahead behind the comm step
            # (0.0 on a fused round and when there was nothing to stage)
            rec["overlap_seconds"] = overlap_s
        if self._overlap_round:
            # host seconds of the next round's pre-launched epoch (0.0 on
            # the last round of a block)
            rec["overlap_dispatch_seconds"] = overlap_dispatch_s
        # local-training calls this round: Nepoch, or 1 when fused
        rec["host_dispatches"] = self._host_dispatches - dispatch0
        rec["kernel_launches"] = {
            k: v - launches0[k] for k, v in _launch_counts().items()}
        if cfg.update_guard and algo.communicates:
            # quarantine census at round start
            rec["quarantined"] = q_start
        if algo.communicates:
            rec["bytes_on_wire"] = self.round_bytes_on_wire(
                N, diag.get("n_active", K))
            if self._fused_coll:
                rec["bytes_fused"] = self.round_bytes_fused(N)
        if cfg.check_results:
            rec["accuracy"] = self.evaluate(state)
        history.append(rec)
        if nadmm + 1 < cfg.Nadmm:
            nxt = (nloop, ci, nadmm + 1)
        elif ci + 1 < self.L:
            nxt = (nloop, ci + 1, 0)
        else:
            nxt = (nloop + 1, 0, 0)
        blockvars = (z, y, rho, x0, yhat0)
        t_ckpt = None
        if checkpoint_path is not None:
            t_ckpt = time.perf_counter()
            self._save_midrun(checkpoint_path, state, blockvars, nxt,
                              history)
            rec["ckpt_write_seconds"] = time.perf_counter() - t_ckpt
        extra_fields = {}
        if cfg.async_rounds:
            extra_fields["async_mode"] = True
            # the cutoff in force: the control plane may have moved it
            extra_fields["max_staleness"] = self.cfg.max_staleness
        if algo.communicates:
            extra_fields["bytes_dense"] = 4 * N * int(
                diag.get("n_active", K))
        self._emit_round_obs(
            obs, rec, round_index=len(history) - 1, t_round=t_round,
            images=obs_images, extra_fields=extra_fields, N=N,
            loss_host=loss_host, cl_nrm=cl_nrm, cl_dist=cl_dist,
            phase_marks=phase_marks, t_ckpt=t_ckpt,
            checkpoint_path=checkpoint_path, state=state,
            blockvars=blockvars, nxt=nxt, history=history, log=log)
        blk = self.block_ids[ci]
        msg = (f"block=[{blk[0]},{blk[1]}]({N},{rho_host:f}) "
               f"round={nadmm}/{nloop} "
               + " ".join(f"{k}={v:e}" for k, v in diag.items()))
        if cfg.check_results:
            msg += " acc=" + np.array2string(rec["accuracy"], precision=2)
        log(msg)
        return (state,) + blockvars

    def _round_values(self, loss_acc, rho, diag, okf) -> list:
        """The tensors a round reads to the host, in :meth:`_step_round`'s
        order: the [K] losses, rho, the diagnostics, the guard verdicts
        (guard on) and the client record's two [K] norms (record on)."""
        vals = [loss_acc, rho, *diag.values()]
        if okf is not None:
            vals.append(okf)
        if self._client_norms[0] is not None:
            vals.extend(self._client_norms)
        return vals

    def run_independent(self, state: Optional[ClientState] = None,
                        log: Callable[[str], None] = print):
        """The no-consensus baseline (no_consensus_multi.py:128-166): the
        whole net trains for Nepoch epochs, Adam created afresh every
        epoch, no comm; returns (state, history), one record per epoch
        (and one obs ``round`` record an epoch)."""
        try:
            with profile_ctx(self.cfg.profile_dir, self.device):
                return self._run_independent(state, log)
        except BaseException:
            if self.obs_recorder is not None:
                self.obs_recorder.close(status="aborted")
            raise
        finally:
            self.close()

    def _run_independent(self, state, log):
        cfg = self.cfg
        state = state or self.init_state()
        f32 = dict(dtype=torch.float32, device=self.device)
        z = torch.zeros(1, **f32)
        y = torch.zeros(cfg.K, 1, **f32)
        rho = torch.tensor(cfg.admm_rho0, **f32)
        history: List[Dict[str, Any]] = []
        obs = self._open_obs(resumed=False, rounds_prior=0)
        obs_images = self._obs_epoch_images()
        for epoch in range(cfg.Nepoch):
            t_epoch = time.perf_counter()
            state = ClientState(state.params, state.batch_stats,
                                self.init_opt(state.params, None))
            counter = self._epochs_staged
            xb, yb, wb = self._stage_epoch(last=epoch == cfg.Nepoch - 1)
            self._sanitize_round = epoch
            state, losses = self.train_epoch(state, None, y, z, rho,
                                             xb, yb, wb, counter)
            self._host_dispatches += 1
            loss_host = losses.cpu().numpy()
            rec = dict(epoch=epoch, loss=float(np.sum(loss_host)),
                       epoch_seconds=time.perf_counter() - t_epoch,
                       host_dispatches=1)
            if cfg.check_results:
                rec["accuracy"] = self.evaluate(state)
                log(f"Epoch {epoch} acc="
                    + np.array2string(rec["accuracy"], precision=2))
            else:
                log(f"Epoch {epoch} loss={rec['loss']:e}")
            history.append(rec)
            if obs.enabled or obs.health is not None:
                obs.round(dict(rec, round_index=epoch,
                               round_seconds=rec["epoch_seconds"],
                               images=obs_images, t_start=t_epoch,
                               **device_memory_stats(self.device)))
                if (obs.health is not None
                        and obs.health.tripped is not None):
                    # no mid-run checkpoint on this path: checkpoint-abort
                    # is a plain abort
                    raise RunHealthAbort(obs.health.tripped)
        obs.close()
        return state, history
