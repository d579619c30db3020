"""The pieces of a run that the harness (``run.py``) and the calibration
(``calibrate.py``) share: the program's first rounds from the seed's
inputs, the reference's, and their comparison."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from portbench import check, drive, inputs
from portbench.reference import federation, resnet


@dataclass
class Start:
    """The program after its compared rounds, and the inputs they came
    from (on the host)."""

    cell: drive.Cell
    prog: dict
    x_init: torch.Tensor
    weights: Dict[str, torch.Tensor]
    images: inputs.Images
    prog_seed: int
    #: seconds of each set-up phase: inputs, trainer, compared rounds
    phases: Dict[str, float]


def start(spec, seed: int, device, spans: bool = False,
          fault: Optional[Callable] = None) -> Start:
    """Make the inputs from ``seed`` on ``device``, build the program's
    trainer on them and run its compared rounds, keeping what the check
    reads.  ``fault`` plants a fault in the program (the checks' tests)."""
    config, traffic = spec.config, spec.traffic
    t0 = time.perf_counter()
    weights = inputs.make_weights(config, seed, device)
    images = inputs.make_images(traffic, seed, device)
    prog_seed = inputs.program_seed(seed)
    t1 = time.perf_counter()
    cell = drive.Cell(config, traffic, weights, images, prog_seed, device,
                      spans=spans)
    t2 = time.perf_counter()
    # the benchmark's copies leave the card before the program runs
    weights = {n: w.cpu() for n, w in weights.items()}
    images = inputs.Images(*(t.cpu() for t in (
        images.train_x, images.train_y, images.test_x, images.test_y)))
    if fault is not None:
        fault(cell)
    compare = traffic["compare_rounds"]
    prog: dict = {"losses": [], "states": {}}
    if stepwise(traffic):
        stop = cell.capture_exchanges()
        for r in range(compare):
            cell.round()
            if r == 0:
                prog["states"][1] = cell.state_of(("mu", "stats"))
        stop()
        prog["losses"].append(cell.client_losses(0))
        prog["states"][1]["x"] = cell.exchanges[0]["x"]
        prog["exchanges"] = cell.exchanges
        cell.exchanges = []
    else:
        for r in range(1, compare + 1):
            cell.round()
            prog["losses"].append(cell.client_losses(r - 1))
            if r == 1:
                prog["states"][1] = cell.state_of(("mu",))
            if r == compare:
                prog["states"].setdefault(r, {}).update(
                    cell.state_of(("x", "z", "stats")))
    sync(device)
    phases = {"inputs": t1 - t0, "trainer": t2 - t1,
              "compared_rounds": time.perf_counter() - t2}
    return Start(cell, prog, cell.x_init, weights, images, prog_seed, phases)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stepwise(traffic: dict) -> bool:
    """Whether the reference follows the program round by round from the
    program's own state (the rounds' exchanges) after following its first
    local epoch from the inputs, rather than whole rounds from the inputs:
    for traffic whose exchange rounds stochastically, where float32
    rounding upstream flips a draw's outcome, which whole rounds would
    carry on."""
    return traffic.get("follow") == "stepwise"


def reference(spec, st: Start, device, tf32: bool = False) -> dict:
    """The reference's compared rounds from the same inputs (``tf32``: in
    the control's precision)."""
    return federation.follow(spec.config, spec.traffic, st.weights,
                             st.images, st.prog_seed,
                             spec.traffic["compare_rounds"], device,
                             tf32=tf32)


def compare(spec, prog: dict, ref: dict, x_init: torch.Tensor,
            detail: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of ``prog`` (the program's or the control's
    rounds) against the reference's; under :func:`stepwise`, with the
    reference's exchanges from the program's own states."""
    stats0 = resnet.init_stats(spec.config["num_blocks"])
    nums = check.numbers(prog, ref, ref["sizes"], x_init, stats0,
                         detail=detail)
    if "exchanges" in prog:
        replayed = federation.replay_exchanges(
            ref["fed"], [{k: v for k, v in io.items() if k != "out"}
                         for io in prog["exchanges"]])
        nums["exchange"] = check.exchange(
            [io["out"] for io in prog["exchanges"]], replayed, ref["sizes"],
            detail)
    return nums


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
