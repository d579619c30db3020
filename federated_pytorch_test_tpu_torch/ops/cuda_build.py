"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
first use into ``build/torch_kernels/lib<name>-<hash>.so`` at the repo
root (the hash covers the source and the flags, so an edited source is
rebuilt).  Nothing is compiled when a module is imported: the CPU tests
import every module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: no --use_fast_math: expf, logf, sqrtf and division must stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source name: {"seconds": build wall time (0.0 if the library was
#: already built), "ptxas": the compiler's -Xptxas -v report, "path": .so}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda): cannot build the CUDA kernels")


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
        info = {"seconds": 0.0, "ptxas": "", "path": str(lib_path)}
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} (rc={proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            info["ptxas"] = " | ".join(
                line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                if line.strip())
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        BUILD_INFO[name] = info
        _libs[name] = lib
        return lib
