"""Accuracy-curve comparison — the reference's only published result — on
the card.

Port of ``federated_pytorch_test_tpu/drivers/accuracy_comparison.py``
(reference README.md:28-30 + comparison.png): the test accuracy of K=10
{standalone, FedAvg, consensus} against a K=1 upper bound, trained with
the Net model on the same data (CIFAR-10 batches when a directory is
given, else the synthetic multi-prototype stand-in).  The accuracy-vs-round
curves go to a JSON file of the JAX driver's layout.  ``--device``
defaults to ``cuda``; ``cpu`` runs only when asked for.

    python -m federated_pytorch_test_tpu_torch.drivers.accuracy_comparison \\
        [--K 10] [--Nloop 3] [--Nadmm 3] [--batch 64] [--n-train 1024] \\
        [--n-test 2048] [--out artifacts/accuracy_comparison_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.train.algorithms import (
    AdmmConsensus,
    FedAvg,
    NoConsensus,
)
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import BlockwiseFederatedTrainer

_SILENT = lambda m: None


def _curve(history) -> List[float]:
    """Mean-over-clients test accuracy per evaluated round."""
    return [float(np.mean(h["accuracy"])) for h in history
            if "accuracy" in h]


def run_comparison(K: int = 10, Nloop: int = 3, Nadmm: int = 3,
                   batch: int = 64, n_train: int = 1024,
                   n_test: int = 2048, seed: int = 5,
                   synthetic_noise: float = 48.0,
                   synthetic_prototypes: int = 32,
                   device: str = "cuda", log=_SILENT) -> Dict[str, object]:
    """All four runs of the reference comparison; returns the curve dict.

    Budget fairness: the standalone runs get Nloop*Nadmm full-net epochs,
    the federated runs Nloop sweeps x Nadmm rounds x 1 epoch (the
    reference's published configuration shape, federated_multi.py:13-16);
    the K=1 upper bound sees the union of all clients' data (K*n_train).
    """
    total_epochs = Nloop * Nadmm
    results: Dict[str, object] = {
        "config": dict(K=K, Nloop=Nloop, Nadmm=Nadmm, batch=batch,
                       n_train=n_train, n_test=n_test, seed=seed,
                       synthetic_noise=synthetic_noise,
                       synthetic_prototypes=synthetic_prototypes),
    }

    # with one prototype per class the synthetic stand-in saturates at 100%
    # for every run; many prototypes make test accuracy scale with the
    # training samples seen, so the published ordering is non-degenerate
    dataK = FederatedCifar10(K=K, batch=batch, limit_per_client=n_train,
                             limit_test=n_test,
                             synthetic_noise=synthetic_noise,
                             synthetic_prototypes=synthetic_prototypes)
    results["data_source"] = dataK.source

    log(f"standalone K={K} ({total_epochs} epochs)")
    cfg = FederatedConfig(K=K, Nepoch=total_epochs, default_batch=batch,
                          check_results=True, seed=seed, device=device)
    t = BlockwiseFederatedTrainer(Net(), cfg, dataK, NoConsensus())
    _, hist = t.run_independent(log=_SILENT)
    results["standalone"] = _curve(hist)

    for name, algo, rho in (("fedavg", FedAvg(), 1.0),
                            ("consensus", AdmmConsensus(), 0.1)):
        log(f"{name} K={K} (Nloop={Nloop} Nadmm={Nadmm})")
        cfg = FederatedConfig(K=K, Nloop=Nloop, Nepoch=1, Nadmm=Nadmm,
                              default_batch=batch, check_results=True,
                              admm_rho0=rho, seed=seed, device=device)
        t = BlockwiseFederatedTrainer(Net(), cfg, dataK, algo)
        _, hist = t.run(log=_SILENT)
        results[name] = _curve(hist)

    log(f"upper bound K=1 ({total_epochs} epochs, {K * n_train} samples)")
    data1 = FederatedCifar10(K=1, batch=batch,
                             limit_per_client=K * n_train,
                             limit_test=n_test,
                             synthetic_noise=synthetic_noise,
                             synthetic_prototypes=synthetic_prototypes)
    cfg = FederatedConfig(K=1, Nepoch=total_epochs, default_batch=batch,
                          check_results=True, seed=seed, device=device)
    t = BlockwiseFederatedTrainer(Net(), cfg, data1, NoConsensus())
    _, hist = t.run_independent(log=_SILENT)
    results["upper_k1"] = _curve(hist)

    results["final"] = {k: results[k][-1] for k in
                        ("standalone", "fedavg", "consensus", "upper_k1")}
    return results


#: fixed color per entity (the JAX driver's palette and labels)
_SERIES = (("upper_k1", "#2a78d6", "K=1 upper bound"),
           ("fedavg", "#eb6834", "FedAvg K=10"),
           ("consensus", "#1baf7a", "consensus K=10"),
           ("standalone", "#eda100", "standalone 1/K"))


def write_plot(results: Dict[str, object], path: str) -> None:
    """The accuracy curves of the four runs over the normalised training
    budget (the reference's comparison.png).  matplotlib is imported only
    here: the drivers run without it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.2, 4.4), dpi=150)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    ends = []
    for name, color, label in _SERIES:
        c = results[name]
        x = [100.0 * i / max(len(c) - 1, 1) for i in range(len(c))]
        ax.plot(x, c, color=color, linewidth=2, label=label,
                solid_capstyle="round")
        ends.append([label, float(c[-1])])
    # dodge overlapping end-of-line labels (saturated runs all finish ~100)
    ends.sort(key=lambda e: e[1])
    for prev, cur in zip(ends, ends[1:]):
        cur[1] = max(cur[1], prev[1] + 3.2)
    for label, y in ends:
        ax.annotate(label, (100.0, y), xytext=(6, 0),
                    textcoords="offset points", fontsize=8,
                    color="#52514e", va="center")
    ax.set_xlim(0, 118)                      # headroom for end labels
    ax.set_xlabel("training budget (%)", color="#52514e")
    ax.set_ylabel("test accuracy (%)", color="#52514e")
    ax.set_title("CIFAR10 federated comparison "
                 f"(K={results['config']['K']}, "
                 f"data={results['data_source']})",
                 color="#0b0b0b", fontsize=11)
    ax.grid(True, color="#e4e3df", linewidth=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#c3c2b7")
    ax.tick_params(colors="#52514e")
    ax.legend(loc="lower right", fontsize=8, frameon=False,
              labelcolor="#0b0b0b")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, facecolor=fig.get_facecolor())
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(prog="accuracy_comparison",
                                description=__doc__.splitlines()[0])
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--Nloop", type=int, default=3)
    p.add_argument("--Nadmm", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--n-test", type=int, default=2048)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--noise", type=float, default=48.0,
                   help="synthetic-fallback pixel-noise std")
    p.add_argument("--prototypes", type=int, default=32,
                   help="synthetic-fallback templates per class")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default="artifacts/accuracy_comparison_torch.json")
    p.add_argument("--plot", nargs="?",
                   const="artifacts/comparison_torch.png", default=None,
                   help="also write the accuracy-curve plot (needs "
                        "matplotlib); optional PATH")
    p.add_argument("--replot", metavar="JSON", default=None,
                   help="skip training; plot from an existing results JSON")
    args = p.parse_args(argv)
    if args.replot:
        if args.plot is None:        # --replot's whole point is the plot
            args.plot = "artifacts/comparison_torch.png"
        with open(args.replot) as f:
            res = json.load(f)
    else:
        res = run_comparison(K=args.K, Nloop=args.Nloop, Nadmm=args.Nadmm,
                             batch=args.batch, n_train=args.n_train,
                             n_test=args.n_test, seed=args.seed,
                             synthetic_noise=args.noise,
                             synthetic_prototypes=args.prototypes,
                             device=args.device, log=print)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")
    if args.plot:
        write_plot(res, args.plot)
        print(f"wrote {args.plot}")
    print(json.dumps(res["final"]))
    return res


if __name__ == "__main__":
    main()
