"""The port's boundary: it imports no JAX and nothing of the JAX package,
and it runs on the card unless the caller asks for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from federated_pytorch_test_tpu_torch.drivers import federated_cpc
from federated_pytorch_test_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = "federated_pytorch_test_tpu_torch"


def test_port_imports_no_jax():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter; neither ``jax`` nor the JAX package may be loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / PORT).rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m in ('flax', 'optax') or m == 'federated_pytorch_test_tpu'"
        " or m.startswith('federated_pytorch_test_tpu.'))\n"
        "print(json.dumps({'n': len(sys.modules), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(mods) > 15
    assert {f"{PORT}.{m}" for m in (
        "data.cifar10", "models.simple", "models.resnet", "ops.gram",
        "parallel.mesh", "parallel.comm", "train.algorithms", "train.losses",
        "train.engine", "drivers.common", "drivers.consensus_multi")} <= set(mods)


def test_driver_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        federated_cpc.main(["--device", "cuda", "--Lc", "8", "--Rc", "4",
                            "--batch-size", "2", "--Niter", "1"],
                           log=lambda m: None)


def test_driver_defaults_to_cuda():
    args = federated_cpc.build_parser().parse_args([])
    assert args.device == "cuda"
    assert (args.Lc, args.Rc, args.batch_size, args.patch_size, args.Niter,
            args.Nloop, args.Nadmm, len(args.file_list)) == (
                256, 32, 128, 32, 10, 1, 1, 4)


@pytest.mark.parametrize("name,ok", [("cpu", True), ("cuda:0", False),
                                     ("meta", False)])
def test_resolve_device(monkeypatch, name, ok):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if ok:
        assert resolve_device(name).type == "cpu"
    else:
        with pytest.raises((RuntimeError, ValueError)):
            resolve_device(name)


def test_chip_smoke_refuses_without_a_card():
    """``python3 chip_smoke.py`` on a machine with no CUDA exits non-zero
    and prints no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernels raises; nothing falls back."""
    from federated_pytorch_test_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    for name in ("infonce", "gram"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.load_library(name)
    assert list(tmp_path.glob("*.so")) == []
