"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic file, its own file of limits, and the
per-layer metrics that read it.

Layout under the benchmark's folder:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: the parameters of a traffic mix, which
  :mod:`portbench.inputs` and :mod:`portbench.drive` read;
* ``workloads/<cell>.json``: the cell's correctness limits, with the
  readings they were set from;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class CellSpec:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is read in ``cell``, whose end-to-end metrics
    are ``reported``: listed under its ``workloads``, or, without that
    key, wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load(name: str, root: str = ROOT, here: str = HERE) -> CellSpec:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; its files are
    read from the benchmark folder ``here``."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"no configuration {entry['config']!r}")
    config = _json(os.path.join(root, configs[0]["file"]))
    traffic = _json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    limits = _json(os.path.join(here, "workloads", name + ".json"))["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if applies(m, name, reported)]
    return CellSpec(name, entry, config, traffic, limits, e2e, per_layer)


def reader(metric: str, here: str = HERE) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(here, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
