"""Every configuration, cell, traffic mix and metric is found by name, and
a new one is added by files and entries alone."""

import json
import os
import re
import shutil

import pytest

from portbench import spec as speclib

BENCH = speclib.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = speclib.load(cell)
    assert spec.config["name"] == spec.entry["config"]
    for key in ("algorithm", "block", "K", "batch", "train_images_per_client",
                "test_images", "compare_rounds"):
        assert key in spec.traffic
    assert spec.limits and all(v >= 0 for v in spec.limits.values())
    reported = {m["name"] for m in spec.end_to_end}
    assert {"setup_s", "train_images_per_s"} <= reported
    assert spec.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    assert callable(speclib.reader(metric))


def test_manifest_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + METRICS)
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(speclib.ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "width", "widths"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    metric as new files and entries, and find them by name; no existing
    file changes."""
    root = tmp_path / "checkout"
    here = root / "portbench"
    shutil.copytree(speclib.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(here) for p in fs}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(speclib.HERE, "configs",
                                      "resnet9-cifar10.json")))
    cfg["name"] = "resnet9-cifar10-b"
    (here / "configs" / "resnet9-cifar10-b.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(speclib.HERE, "traffic",
                                          "admm.stem.b128.json")))
    traffic["block"] = 1
    (here / "traffic" / "admm.block1.b128.json").write_text(json.dumps(traffic))
    (here / "workloads" / "resnet9.admm.block1.json").write_text(
        json.dumps({"limits": {"loss": 1.0}}))
    (here / "metrics" / "rounds_n.py").write_text(
        "def read(ctx):\n    return float(len(ctx.rounds)) or None\n")
    bench["configs"].append(dict(bench["configs"][1], name="resnet9-cifar10-b",
                                 file="portbench/configs/resnet9-cifar10-b.json"))
    bench["workloads"].append({"name": "resnet9.admm.block1",
                               "config": "resnet9-cifar10-b",
                               "traffic": "admm.block1.b128", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "rounds_n", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "round",
                               "moves": "train_images_per_s",
                               "workloads": ["resnet9.admm.block1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = speclib.load("resnet9.admm.block1", root=str(root), here=str(here))
    assert spec.traffic["block"] == 1 and spec.config["num_blocks"] == [1, 1, 1, 1]
    assert "rounds_n" in [m["name"] for m in spec.per_layer]
    read = speclib.reader("rounds_n", here=str(here))

    class Ctx:
        rounds = [{}, {}]

    assert read(Ctx) == 2.0
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(here) for p in fs}
    assert all(after[p] == b for p, b in before.items())
