"""On the card, at a size a test run holds: the control (the reference in
TF32, the precision below the configuration's float32 with TF32 off) in
the program's place fails the cell's limits; the program itself passes
them; the quantize kernels report each launch's shape.  On a machine with
an NVIDIA card: ``python3 -m pytest portbench/tests -m card -q -p
no:cacheprovider``."""

import pytest

from portbench import check, session, spec as speclib
from portbench.tests.toy import toy_spec

CELLS = [w["name"] for w in speclib.benchmark()["workloads"]]


def card_spec(cell):
    spec = toy_spec(cell)
    spec.traffic.update(K=4, batch=32, train_images_per_client=64 + 16 * (
        speclib.load(cell).traffic["train_images_per_client"] % 128 != 0))
    return spec


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    spec = card_spec(cell)
    st = session.start(spec, 2**31 + 101, card)
    st.cell.close()
    st.cell = None
    session.free(card)
    ref = session.reference(spec, st, card)
    prog = session.compare(spec, st.prog, ref, st.x_init)
    assert check.verdict(prog, spec.limits), prog
    ctl = session.reference(spec, st, card, tf32=True)
    nums = session.compare(spec, ctl, ref, st.x_init)
    assert not check.verdict(nums, spec.limits), nums


@pytest.mark.card
def test_quantize_launches_are_recorded(card):
    from portbench import drive, inputs

    spec = card_spec("resnet18.fedavg-q8.block8")
    c = drive.Cell(spec.config, spec.traffic,
                   inputs.make_weights(spec.config, 5, card),
                   inputs.make_images(spec.traffic, 5, card),
                   inputs.program_seed(5), card, spans=True)
    try:
        c.round()
        assert {k for k, *_ in c.launches} == {"quantize_rows", "dequant_add"}
        assert len(c.comm_events) == 1
    finally:
        c.drop_spans()
        c.close()
