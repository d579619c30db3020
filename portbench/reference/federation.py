"""The federated rounds of one trained block, in plain PyTorch: K clients
train the block locally for an epoch with Adam, then exchange it.

The source's drivers (SarodYatawatta/federated-pytorch-test
``consensus_multi.py``, ``federated_multi.py``), on one fixed block:

* a client's minibatch loss is the mean cross-entropy over its real rows
  (wrap-padding rows of the last partial minibatch weigh 0), plus the
  algorithm's term on the block vector ``x``: ADMM's
  ``y_k . (x - z) + rho/2 ||x - z||^2``, none for FedAvg; plus
  ``lambda1 ||x||_1 + lambda2 ||x||^2`` where the configuration lists the
  block among ``l1_l2_blocks``;
* each client's images are normalised with its own (mean, std) triple,
  ``(0.5 + k/100, 0.5 - k/100, 0.5)`` for both under ``biased_input``;
* Adam (optax's update: bias corrections, ``mu_hat / (sqrt(nu_hat) +
  eps)``), its state fresh at the block's start and kept across rounds;
* ADMM: ``z = mean_k(y_k + rho x_k) / rho``, ``y_k += rho (x_k - z)``;
  FedAvg: ``z = mean_k x_k``, written back to every client;
* under ``compress: q8`` with error feedback the server sees
  ``z + Q(x_k - z + r_k)``, ``r_k`` the carried residual, and under
  ``fused_collective`` the mean runs as the packed collective over the
  configured number of devices (``flat.packed_mean``).

Only the block trains: the other leaves keep their initial values, and
every client carries its own BatchNorm running statistics, updated by each
training forward.

Imports torch, numpy and the benchmark's own modules, nothing of the
program; the inputs (weights, images, data order, quantizer draws) come
from :mod:`portbench.inputs`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench import inputs as inp
from portbench.reference import flat, resnet

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 (TF32 off), or TF32 for convolutions and matmuls."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def client_norm(k: int, biased: bool, device) -> torch.Tensor:
    """[3] mean (= std) of client ``k``."""
    m = [0.5 + k / 100.0, 0.5 - k / 100.0, 0.5] if biased else [0.5] * 3
    return torch.tensor(m, dtype=torch.float32, device=device)


class Federation:
    """K clients on one block; :meth:`round` runs one communication round.

    ``weights``: the initial weights by name; ``images``: an
    :class:`portbench.inputs.Images`; ``prog_seed``: the seed of the data
    order and the quantizer draws."""

    def __init__(self, config: dict, traffic: dict, weights: Dict[str, torch.Tensor],
                 images: inp.Images, prog_seed: int, device):
        self.cfg, self.tr, self.device = config, traffic, device
        self.nb = config["num_blocks"]
        shapes = resnet.param_shapes(self.nb, config["num_classes"])
        order = list(shapes)
        lo, hi = config["blocks"][traffic["block"]]
        self.names = order[lo:hi + 1]
        self.shapes = [shapes[n] for n in self.names]
        self.sizes = flat.leaf_sizes(self.shapes)
        self.shared = {n: t.to(device) for n, t in weights.items()
                       if n not in self.names}
        K = traffic["K"]
        x0 = flat.flatten([weights[n].to(device) for n in self.names])
        self.N = x0.numel()
        self.X = x0.unsqueeze(0).repeat(K, 1)
        self.stats = [resnet.init_stats(self.nb, device) for _ in range(K)]
        f32 = dict(dtype=torch.float32, device=device)
        self.mu = torch.zeros(K, self.N, **f32)
        self.nu = torch.zeros(K, self.N, **f32)
        self.count = [0] * K
        self.z = torch.zeros(self.N, **f32)
        self.y = torch.zeros(K, self.N, **f32)
        self.rho = torch.tensor(traffic["rho0"], **f32)
        self.images = inp.Images(*(t.to(device) for t in (
            images.train_x, images.train_y, images.test_x, images.test_y)))
        self.prog_seed = prog_seed
        self.n = images.train_x.shape[1]
        self.steps, self.rem = inp.steps_and_remainder(self.n, traffic["batch"])
        reg = traffic["block"] in config.get("l1_l2_blocks", [])
        self.lam = ((config["lambda1"], config["lambda2"]) if reg else None)
        self.norms = [client_norm(k, traffic["biased_input"], device)
                      for k in range(K)]
        if traffic["compress"] not in ("none", "q8"):
            raise ValueError(f"compress={traffic['compress']!r}: the "
                             "reference has q8 and none")
        if traffic["compress"] == "q8":
            self.streams = inp.quant_streams(prog_seed, traffic["block"], K)
            self.resid = torch.zeros(K, self.N, **f32)
        self.rounds = 0

    # -- the local epoch ------------------------------------------------------
    def _loss(self, v, k, xb, yb, wb):
        params = dict(self.shared)
        params.update(flat.unflatten(v, self.names, self.shapes))
        logits, new = resnet.forward(params, self.stats[k], xb, self.nb,
                                     train=True,
                                     w=wb if self.rem else None)
        ce = F.cross_entropy(logits, yb, reduction="none")
        loss = (ce * wb).sum() / torch.clamp(wb.sum(), min=1.0)
        if self.tr["algorithm"] == "admm":
            d = v - self.z
            loss = loss + torch.dot(self.y[k], d) + 0.5 * self.rho * torch.dot(d, d)
        if self.lam is not None:
            loss = loss + self.lam[0] * v.abs().sum() + self.lam[1] * torch.dot(v, v)
        return loss, new

    def _adam(self, k: int, g: torch.Tensor) -> None:
        self.count[k] += 1
        self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
        self.nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[k]
        one = torch.ones((), dtype=torch.float32, device=self.device)
        bc1 = one - (one * ADAM_B1) ** self.count[k]
        bc2 = one - (one * ADAM_B2) ** self.count[k]
        u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + ADAM_EPS)
        self.X[k] = self.X[k] + u * (-self.tr["lr"])

    def local_epoch(self, counter: int) -> List[float]:
        """Epoch ``counter`` of every client; returns each client's summed
        loss."""
        B, K = self.tr["batch"], self.tr["K"]
        rows = torch.from_numpy(inp.epoch_rows(self.prog_seed, counter, K,
                                               self.n, B)).to(self.device)
        wb = torch.ones(self.steps, B, device=self.device)
        if self.rem:
            wb[-1, self.rem:] = 0.0
        losses = []
        for k in range(K):
            m = self.norms[k]
            total = torch.zeros((), device=self.device)
            for s in range(self.steps):
                idx = rows[k, s * B:(s + 1) * B]
                x = self.images.train_x[k, idx].to(torch.float32) / 255.0
                xb = ((x - m) / m).permute(0, 3, 1, 2)
                yb = self.images.train_y[k, idx]
                v = self.X[k].detach().requires_grad_(True)
                loss, self.stats[k] = self._loss(v, k, xb, yb, wb[s])
                (g,) = torch.autograd.grad(loss, v)
                with torch.no_grad():
                    self._adam(k, g)
                total = total + loss.detach()
            losses.append(total)
        return [float(t) for t in torch.stack(losses).cpu()]

    # -- the exchange --------------------------------------------------------
    def _mean(self, stack: torch.Tensor) -> torch.Tensor:
        K, tr = self.tr["K"], self.tr
        if tr.get("fused_collective"):
            D = tr["num_devices"]
            partials = [s.sum(dim=0) for s in stack.split(K // D)]
            return flat.packed_mean(partials, K, 127, tr["quant_chunk"])
        return stack.sum(dim=0) / K

    @torch.no_grad()
    def exchange(self) -> None:
        tr = self.tr
        x = self.X
        if tr["compress"] == "q8":
            u = x - self.z[None, :] + self.resid
            chunks = -(-self.N // tr["quant_chunk"])
            draws = inp.quant_draws(self.streams, self.rounds, chunks,
                                    tr["quant_chunk"], self.device)
            dec = flat.stochastic_quantize(u, draws, 127, tr["quant_chunk"])
            del draws
            if tr.get("error_feedback"):
                self.resid = u - dec
            x = self.z[None, :] + dec
        if tr["algorithm"] == "admm":
            z = self._mean(self.y + self.rho * x) / self.rho
            self.y = self.y + self.rho * (x - z)
        elif tr["algorithm"] == "fedavg":
            z = self._mean(x)
            self.X = z.unsqueeze(0).repeat(tr["K"], 1)
        else:
            raise ValueError(f"algorithm={tr['algorithm']!r}")
        self.z = z

    def round(self) -> List[float]:
        """One round: the local epoch, then the exchange; the clients'
        summed losses."""
        n = self.tr["Nepoch"]
        per_epoch = [self.local_epoch(self.rounds * n + e) for e in range(n)]
        losses = [sum(ls) for ls in zip(*per_epoch)]
        self.exchange()
        self.rounds += 1
        return losses

    # -- what the check reads ------------------------------------------------
    def state(self) -> dict:
        """The block stack, the consensus, Adam's first moment and the
        running statistics, on the host."""
        host = lambda t: t.detach().to("cpu", copy=True)
        names = sorted(self.stats[0])
        return {"x": host(self.X), "z": host(self.z), "mu": host(self.mu),
                "stats": {n: host(torch.stack([s[n] for s in self.stats]))
                          for n in names}}


def follow(config: dict, traffic: dict, weights, images, prog_seed: int,
           rounds: int, device, tf32: bool = False) -> dict:
    """The reference's first ``rounds`` rounds from the inputs: the losses
    of each ``[round][client]``, :meth:`Federation.state` after round 1
    and after the last.  With ``traffic["follow"] == "stepwise"`` only
    round 1's local epoch, and the state before its exchange."""
    out = {"losses": [], "states": {}}
    stepwise = traffic.get("follow") == "stepwise"
    with precision(tf32):
        fed = Federation(config, traffic, weights, images, prog_seed, device)
        if stepwise:
            out["losses"].append(fed.local_epoch(0))
            out["states"][1] = fed.state()
        else:
            for r in range(1, rounds + 1):
                out["losses"].append(fed.round())
                if r in (1, rounds):
                    out["states"][r] = fed.state()
    out["names"], out["sizes"] = fed.names, fed.sizes
    out["fed"] = fed
    return out


def replay_exchanges(fed: Federation, taken: List[dict]) -> List[dict]:
    """The reference's exchange of each round the program took, from the
    program's own state before it (``taken``: per round ``x`` [K, N],
    ``z``, ``y``, ``resid`` as the program held them): the consensus, the
    duals, the residuals and the block stack after it, on the host."""
    out = []
    host = lambda t: t.detach().to("cpu", copy=True)
    for r, io in enumerate(taken):
        dev = fed.device
        fed.X = io["x"].to(dev)
        fed.z = io["z"].to(dev)
        if io.get("y") is not None:
            fed.y = io["y"].to(dev)
        if io.get("resid") is not None:
            fed.resid = io["resid"].to(dev)
        fed.rounds = r
        fed.exchange()
        rec = {"z": host(fed.z), "x": host(fed.X)}
        if io.get("y") is not None:
            rec["y"] = host(fed.y)
        if io.get("resid") is not None:
            rec["resid"] = host(fed.resid)
        out.append(rec)
    return out
