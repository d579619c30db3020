"""Each cell, at a toy size on the CPU, through the whole run but the look
for a card: one round through ``drive.py`` with its records read, a
sound run that comes out correct, and a run with each fault the cell can
have planted in the program, which comes out not correct."""

import pytest
import torch

from portbench import drive, faults, inputs, spec as speclib
from portbench.tests.toy import rehearse, toy_spec

CELLS = [w["name"] for w in speclib.benchmark()["workloads"]]
FAULTED = [(c, f) for c in CELLS
           for f in faults.applicable(speclib.load(c).traffic)]


@pytest.mark.parametrize("cell", CELLS)
def test_one_round_through_drive(cell):
    spec = toy_spec(cell)
    weights = inputs.make_weights(spec.config, 3, "cpu")
    images = inputs.make_images(spec.traffic, 3, "cpu")
    c = drive.Cell(spec.config, spec.traffic, weights, images,
                   inputs.program_seed(3), "cpu", spans=True)
    try:
        c.round()
        (rec,) = c.records("round")
        for key in ("stage_seconds", "train_seconds", "comm_seconds", "loss"):
            assert key in rec
        assert len(c.client_losses(0)) == spec.traffic["K"]
        assert {label for *_, label in c.spans} >= {"local epoch", "comm step"}
    finally:
        c.drop_spans()
        c.close()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = rehearse(cell, trace=True)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "compared"
    assert {"stage_ms", "train_ms"} <= set(r["metrics"])


@pytest.mark.parametrize("cell,fault", FAULTED)
def test_fault_makes_the_run_incorrect(cell, fault):
    r = rehearse(cell, fault=faults.FAULTS[fault])
    assert not r["correct"], r["compared"]


def test_same_seed_same_inputs():
    spec = toy_spec(CELLS[0])
    a = inputs.make_images(spec.traffic, 2**31 + 7, "cpu")
    b = inputs.make_images(spec.traffic, 2**31 + 7, "cpu")
    assert torch.equal(a.train_x, b.train_x) and torch.equal(a.test_y, b.test_y)
    wa = inputs.make_weights(spec.config, 2**31 + 7, "cpu")
    wb = inputs.make_weights(spec.config, 2**31 + 7, "cpu")
    assert all(torch.equal(wa[n], wb[n]) for n in wa)
