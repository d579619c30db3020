"""A cell at a toy size for the CPU: the same files and code paths, two
clients, a handful of images."""

from __future__ import annotations

import copy

from portbench import spec as speclib

#: per traffic: images a client and batch at the toy size (the b512 cell
#: keeps a partial last minibatch)
TOY = {"batch": 4, "test_images": 8, "K": 2}


def toy_spec(name: str) -> speclib.CellSpec:
    spec = copy.deepcopy(speclib.load(name))
    tr = spec.traffic
    partial = tr["train_images_per_client"] % tr["batch"] != 0
    tr.update(TOY)
    tr["train_images_per_client"] = 7 if partial else 8
    return spec


def rehearse(name: str, seed: int = 5, trace: bool = False, fault=None,
             seconds: float = 0.0) -> dict:
    """One run of cell ``name`` at the toy size on the CPU."""
    from portbench import run

    return run.run_cell(toy_spec(name), seed, seconds, trace, "cpu",
                        fault=fault)
