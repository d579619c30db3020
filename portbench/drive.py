"""The one adapter between the benchmark and the program under test.

Every call into ``federated_pytorch_test_tpu_torch`` goes through this
module: the trainer is built as the classifier drivers build it
(``drivers/common.py`` ``make_trainer``), the benchmark's weights and
images are handed in, one fixed block's variables are made as
``BlockwiseFederatedTrainer._run`` makes them at a block's start, and
:meth:`Cell.round` runs one communication round through
``BlockwiseFederatedTrainer._step_round``, the entry the window drives.
A later rename of that entry is followed here and nowhere else.

Besides rounds, the adapter reads what the check and the per-layer
metrics need: the round and client records of the program's recorder
(its memory sink), the block stack, the consensus, Adam's moments and the
running statistics, and, in a traced run, the benchmark's own spans
around the program's calls (host intervals on the profiler's clock, CUDA
events around the comm step) and the shape of every launch of the
quantize kernels (through the program's ``sanitize.report`` hook, which
each launch calls with its outputs).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.analysis import sanitize
from federated_pytorch_test_tpu_torch.data.cifar10 import (
    FederatedCifar10,
    client_norm_stats,
)
from federated_pytorch_test_tpu_torch.models.resnet import ResNet9, ResNet18
from federated_pytorch_test_tpu_torch.train.algorithms import (
    AdmmConsensus,
    FedAvg,
)
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer,
    ClientState,
)
from federated_pytorch_test_tpu_torch.utils import codec

MODELS = {"resnet18": ResNet18, "resnet9": ResNet9}
ALGORITHMS = {"admm": AdmmConsensus, "fedavg": FedAvg}

#: rounds a block is given: more than any window runs
ROUNDS_CAP = 1_000_000


@dataclasses.dataclass
class HandedCifar10(FederatedCifar10):
    """The program's CIFAR-10 pipeline over the benchmark's arrays:
    ``handed`` = (train_x [K, n, 32, 32, 3] uint8, train_y [K, n],
    test_x [T, 32, 32, 3] uint8, test_y [T]), numpy."""

    handed: Optional[tuple] = None

    def __post_init__(self):
        xtr, ytr, xte, yte = self.handed
        self.source = "portbench"
        self._norm = client_norm_stats(self.K, self.biased_input)
        n = xtr.shape[1]
        full = n // self.batch
        self.remainder = n - full * self.batch
        self.steps = full + (1 if self.remainder else 0)
        self._train_x, self._train_y = xtr, ytr.astype(np.int32)
        self._test_x, self._test_y = xte, yte.astype(np.int32)


def _nested(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def _flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def program_config(traffic: dict, config: dict, prog_seed: int,
                   device: str) -> FederatedConfig:
    """The program's run configuration of a cell: the driver defaults of
    the traffic's algorithm, its knobs, a record stream kept in memory."""
    return FederatedConfig(
        K=traffic["K"], default_batch=traffic["batch"], Nloop=1,
        Nepoch=traffic["Nepoch"], Nadmm=ROUNDS_CAP, seed=prog_seed,
        lambda1=config["lambda1"], lambda2=config["lambda2"],
        admm_rho0=traffic["rho0"], lr=traffic["lr"],
        biased_input=traffic["biased_input"],
        check_results=traffic["check_results"], model=config["model"],
        compress=traffic["compress"],
        error_feedback=traffic.get("error_feedback", False),
        quant_chunk=traffic.get("quant_chunk", 256),
        fused_collective=traffic.get("fused_collective", False),
        num_devices=traffic.get("num_devices"),
        device_data=traffic["device_data"],
        fused_rounds=traffic["fused_rounds"],
        obs_sinks="memory", save_model=False, device=device)


class Cell:
    """The program on one cell: a trainer on the traffic's block, at the
    state the block starts from."""

    def __init__(self, config: dict, traffic: dict,
                 weights: Dict[str, torch.Tensor], images, prog_seed: int,
                 device, spans: bool = False):
        self.traffic = traffic
        dev = torch.device(device)
        cfg = program_config(traffic, config, prog_seed, str(dev))
        host = lambda t: t.cpu().numpy()
        data = HandedCifar10(
            K=traffic["K"], batch=traffic["batch"],
            biased_input=traffic["biased_input"],
            handed=(host(images.train_x), host(images.train_y),
                    host(images.test_x), host(images.test_y)))
        model = MODELS[config["model"]]()
        t = BlockwiseFederatedTrainer(model, cfg, data,
                                      ALGORITHMS[traffic["algorithm"]]())
        t.obs_run_name = "portbench"
        order = set(t.order)
        if set(weights) != order:
            raise ValueError("the benchmark's weights and the program's "
                             f"parameters differ: {sorted(set(weights) ^ order)}")
        K = t.n_rows
        t.params0 = _nested({n: w.to(dev).unsqueeze(0).expand(K, *w.shape)
                             .contiguous() for n, w in weights.items()})
        self.trainer = t
        self.ci = ci = traffic["block"]
        t._block_flags(ci)
        self.N = N = t.block_size(ci)
        f32 = dict(dtype=torch.float32, device=dev)
        z = torch.zeros(N, **f32)
        y = torch.zeros(K, N if t.algo.needs_dual else 1, **f32)
        rho = torch.tensor(cfg.admm_rho0, **f32)
        x0 = torch.zeros(K, 1, **f32)
        yhat0 = torch.zeros(K, 1, **f32)
        state = t.init_state()
        self.state = ClientState(state.params, state.batch_stats,
                                 t.init_opt(state.params, ci),
                                 t._init_comp_state(ci))
        t._reset_block_ledgers()
        self.blockvars = (z, y, rho, x0, yhat0)
        self.mask = t.mask_for_block(ci)
        self.x_init = codec.get_trainable_stack(
            self.state.params, t.order, self.mask).to("cpu", copy=True)
        self.obs = t._open_obs(resumed=False, rounds_prior=0)
        self.obs_images = cfg.Nepoch * t._obs_epoch_images()
        self.history: List[dict] = []
        self.nadmm = 0
        self.comm_events: List[tuple] = []
        self.launches: List[tuple] = []
        self.spans: List[tuple] = []
        self.exchanges: List[dict] = []
        if spans:
            self._add_spans()

    @property
    def images_per_round(self) -> int:
        """Real training images of a round (wrap-padding rows left out)."""
        tr = self.traffic
        return tr["K"] * tr["train_images_per_client"] * tr["Nepoch"]

    def round(self) -> None:
        """One communication round through the program's round entry."""
        t = self.trainer
        out = t._step_round(self.obs, self.obs_images, self.state,
                            self.blockvars, 0, self.ci, self.nadmm, self.N,
                            self.history, None, lambda msg: None)
        self.state, self.blockvars = out[0], tuple(out[1:])
        self.nadmm += 1

    # -- records ---------------------------------------------------------
    def records(self, event: str) -> List[dict]:
        return [r for r in self.trainer.obs_recorder.memory
                if r.get("event") == event]

    def client_losses(self, round_index: int) -> List[float]:
        for r in self.records("client"):
            if r["round_index"] == round_index:
                return list(r["loss_client"])
        raise KeyError(f"no client record of round {round_index}")

    def state_of(self, keys=("x", "z", "mu", "stats")) -> dict:
        """What the check reads, on the host: the block stack ``x``
        [K, N], the consensus ``z`` [N], Adam's first moment ``mu``
        [K, N], the running statistics by name [K, C]."""
        t, out = self.trainer, {}
        host = lambda v: v.detach().to("cpu", copy=True)
        if "x" in keys:
            out["x"] = host(codec.get_trainable_stack(self.state.params,
                                                      t.order, self.mask))
        if "z" in keys:
            out["z"] = host(self.blockvars[0])
        if "mu" in keys:
            out["mu"] = host(self.state.opt_state.mu)
        if "stats" in keys:
            out["stats"] = {n: host(v) for n, v in
                            _flat(self.state.batch_stats).items()}
        return out

    def capture_exchanges(self) -> Callable[[], None]:
        """Keep, for every comm step from now on, the block stack, the
        consensus, the duals and the error-feedback residuals the step
        took, and what it left (``self.exchanges``, on the host); returns
        the function that stops it."""
        t = self.trainer
        fn = t.comm_round
        host = lambda v: None if v is None else v.detach().to("cpu", copy=True)
        stack = lambda st: host(codec.get_trainable_stack(st.params, t.order,
                                                          self.mask))
        dual = t.algo.needs_dual
        resid = lambda st: host(st.comp["resid"]) if isinstance(
            st.comp, dict) and "resid" in st.comp else None

        def taken(state, ci, z, y, rho, x0, yhat0, *a, **kw):
            io = {"x": stack(state), "z": host(z),
                  "y": host(y) if dual else None, "resid": resid(state)}
            out = fn(state, ci, z, y, rho, x0, yhat0, *a, **kw)
            io["out"] = {"x": stack(out[0]), "z": host(out[1]),
                         "y": host(out[2]) if dual else None,
                         "resid": resid(out[0])}
            self.exchanges.append(io)
            return out

        t.comm_round = taken

        def stop():
            t.comm_round = fn
        return stop

    def close(self) -> None:
        self.trainer.close()
        self.trainer = self.state = self.blockvars = self.obs = None

    # -- the traced run's spans ------------------------------------------
    def _add_spans(self) -> None:
        """Time the program's calls on the host clock (``time.time_ns``,
        the profiler's clock) under the labels of :data:`SPANS`, time the
        comm step on the card with CUDA events, and record each quantize
        kernel launch's shape."""
        t = self.trainer
        cuda = t.device.type == "cuda"
        for attr, label in SPANS.items():
            fn = getattr(t, attr)
            timed = attr == "comm_round" and cuda

            def wrapped(*a, _fn=fn, _label=label, _timed=timed, **kw):
                if _timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                s0 = time.time_ns()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.spans.append((s0, time.time_ns(), _label))
                    if _timed:
                        ev[1].record()
                        self.comm_events.append(ev)

            setattr(t, attr, functools.wraps(fn)(wrapped))
        report = sanitize.report
        chunk = self.traffic.get("quant_chunk", 256)

        def counted(name, *outputs, _report=report):
            # quantize_rows reports its scales [c], dequant_add its [c, w]
            o = outputs[0]
            width = o.shape[1] if o.dim() == 2 else chunk
            self.launches.append((name, o.shape[0], width))
            return _report(name, *outputs)

        sanitize.report = counted
        self._restore_report = report

    def drop_spans(self) -> None:
        if hasattr(self, "_restore_report"):
            sanitize.report = self._restore_report


#: the program's calls a traced run times, by the label of their span
SPANS = {"_fused_epoch_rows": "stage", "_stage_epoch": "stage",
         "train_epoch": "local epoch", "comm_round": "comm step",
         "evaluate": "evaluation", "_emit_round_obs": "round records"}
