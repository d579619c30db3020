"""The benchmark's readers of the round's spans and counters
(``portbench/metrics/``): each is the mean of its round-record field over
the window's rounds, in its unit, and nothing (``None``) where the
program writes no such field."""

from types import SimpleNamespace

import pytest

from portbench import spec as speclib

#: metric -> (round-record field, scale to the metric's unit)
READERS = {"epoch_host_ms": ("epoch_host_seconds", 1e3),
           "fwd_host_ms": ("step_forward_seconds", 1e3),
           "bwd_host_ms": ("step_backward_seconds", 1e3),
           "opt_host_ms": ("step_optimizer_seconds", 1e3),
           "eval_ms": ("eval_seconds", 1e3),
           "comm_dev_ms": ("comm_device_seconds", 1e3),
           "host_syncs": ("host_syncs", 1)}


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_the_mean_of_its_field(metric):
    field, scale = READERS[metric]
    read = speclib.reader(metric)
    rounds = [{field: 0.25, "loss": 1.0}, {field: 0.5, "loss": 1.0},
              {field: 0.75, "loss": 1.0}]
    assert read(SimpleNamespace(rounds=rounds)) == pytest.approx(0.5 * scale)
    assert read(SimpleNamespace(rounds=[{"loss": 1.0}])) is None
    assert read(SimpleNamespace(rounds=[])) is None
    (entry,) = [m for m in speclib.benchmark()["per_layer"]
                if m["name"] == metric]
    assert (entry["source"], entry["moves"]) == ("program_span",
                                                 "train_images_per_s")
    assert "workloads" not in entry


def test_graph_step_share_is_the_replayed_share_of_the_client_steps():
    read = speclib.reader("graph_step_share")
    rec = lambda g, e: {"graph_steps": g, "eager_steps": e, "loss": 1.0}
    assert read(SimpleNamespace(rounds=[rec(100, 0), rec(90, 0)])) == 100.0
    assert read(SimpleNamespace(rounds=[rec(0, 100), rec(100, 0)])) == 50.0
    assert read(SimpleNamespace(rounds=[rec(0, 100)])) == 0.0
    for rounds in ([], [{"loss": 1.0}], [rec(0, 0)]):
        assert read(SimpleNamespace(rounds=rounds)) is None
    (entry,) = [m for m in speclib.benchmark()["per_layer"]
                if m["name"] == "graph_step_share"]
    assert entry == {"name": "graph_step_share", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "local epoch", "moves": "train_images_per_s"}
