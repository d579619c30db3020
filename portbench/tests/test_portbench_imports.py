"""What a run loads and when it refuses to run."""

import json
import os
import shutil
import subprocess
import sys

from portbench import spec as speclib

CODE = """
import sys, torch
torch.set_num_threads(1)
from portbench.tests.toy import rehearse
r = rehearse("resnet18.fedavg-q8.block8", trace=True)
assert r["correct"], r["compared"]
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
FORBIDDEN = {"jax", "jaxlib", "flax", "federated_pytorch_test_tpu"}


def test_rehearsal_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=speclib.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(out.stdout.split())
    assert "federated_pytorch_test_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "resnet9.admm.stem", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=speclib.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_in_a_bare_directory_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    has no program to run."""
    shutil.copy(os.path.join(speclib.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(speclib.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "resnet9.admm.stem", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
