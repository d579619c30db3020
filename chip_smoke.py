#!/usr/bin/env python3
"""On-card smoke check of the PyTorch + CUDA port (``federated_pytorch_test_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Phases, each of
which stops the script with a non-zero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/infonce.cu`` with ``nvcc`` for ``sm_90a`` (the ptxas
   report on one line, the build seconds);
3. kernels vs plain: the InfoNCE forward and backward kernels against
   their plain PyTorch versions at the CPC path's shape (D=4096, P=9), at
   D=8/P=1, D=4099/P=130, D=256/P=1000 and with an all-zero column in Z
   and in Zhat; then, at the path's shape, the time per call of kernel
   and plain version from CUDA events around 200 back-to-back calls
   (``ms``, host launch cost included), the kernels' device time from
   ``torch.profiler`` (``device_ms``), and the card's bound;
4. the slice at full width: ``drivers.federated_cpc`` with its defaults
   (K=4, Lc=256, Rc=32, batch 128, patch 32, Niter=10, Nloop=1, Nadmm=1:
   one rotation of 4 communication rounds), with the launch counts set to
   0 just before and read just after; every round's loss and dual residual
   finite, every trained block changed, both kernels launched;
5. the path's own data: the CPC loss and its gradient in the predictor's
   flat vector, at the initial weights and one real minibatch, through the
   kernels and through the plain versions;
6. a profile of one L-BFGS step per sub-model at full width: host wall
   time, device busy time and the InfoNCE kernels' share (printed only).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: forward: |kernel - plain| <= FWD_ATOL + FWD_RTOL*|plain| elementwise.
#: Both are float32 with the dot products summed in different orders, so
#: log_p (of order log P) agrees to a few ulps.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
#: backward: |kernel - plain| <= BWD_RTOL*|plain| + BWD_ATOL_REL*max|plain|.
#: Gradients are sums of P products of scores, so a few ulps of the largest
#: element is the scale of the rounding difference.
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-5
#: the CPC loss through kernels vs plain versions, and its gradient
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def within(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, whether every element is within atol + rtol*|want|)."""
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        got.isfinite().all() == want.isfinite().all())
    return float(err.max()), ok


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, name: str, iters: int = 50):
    """Device time per call (ms) of the CUDA kernels whose name contains
    ``name``, from ``torch.profiler``; None if the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if name in e.key)
    return us / iters / 1e3 if us > 0 else None


def fwd_bound(D: int, P: int) -> tuple:
    """(bytes, flops) the forward must move and do: Z and Zhat read once,
    log_p written once; D*P^2 multiply-adds of the scores, the 2*D*P
    squares-and-adds of the norms."""
    return (2 * D * P + P) * 4, 2 * D * P * P + 4 * D * P


def bwd_bound(D: int, P: int) -> tuple:
    """(bytes, flops) of the backward: Z, Zhat, log_p, ghat read once, dZ and
    dZhat written once; the score rebuild (2DP^2), the norms (4DP), the two
    [D,P]x[P,P] products (4DP^2) and the two norm-path terms (4DP)."""
    return (4 * D * P + 2 * P) * 4, 6 * D * P * P + 8 * D * P


def bound_ms(nbytes: int, flops: int) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_device():
    """Phase 1; returns (the nvidia-smi line of card 0, the torch device)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return card, torch.device("cuda:0")


def build() -> None:
    """Phase 2."""
    from federated_pytorch_test_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.load_library("infonce")
    info = cuda_build.BUILD_INFO["infonce"]
    log(f"build: infonce.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s) -> {info['path']}")
    log(f"ptxas: {info['ptxas']}")


def check_kernels(dev, card: str):
    """Phase 3; returns ({kernel: max_abs_err at the path's shape},
    {kernel: (kernel_ms, plain_ms, (bound_ms, bound_by))})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.ops.infonce_core import log_p_flat

    rng = np.random.default_rng(0)

    def case(D, P, zero_cols=False):
        Z = rng.standard_normal((D, P)).astype(np.float32)
        Zh = rng.standard_normal((D, P)).astype(np.float32)
        if zero_cols:
            Z[:, 1] = 0.0
            Zh[:, P - 1] = 0.0
        g = rng.standard_normal(P).astype(np.float32)
        return (torch.from_numpy(Z).to(dev), torch.from_numpy(Zh).to(dev),
                torch.from_numpy(g).to(dev))

    path_err = {}
    for D, P, zero in ((4096, 9, False), (8, 1, False), (4099, 130, False),
                       (256, 1000, False), (4096, 9, True)):
        Z, Zh, ghat = case(D, P, zero)
        lp_k = infonce.infonce_fwd(Z, Zh)
        lp_p = log_p_flat(Z, Zh)
        dz_k, dzh_k = infonce.infonce_bwd(Z, Zh, lp_p, ghat)
        dz_p, dzh_p = infonce.grads_plain(Z, Zh, lp_p, ghat)
        torch.cuda.synchronize()
        ef, okf = within(lp_k, lp_p, FWD_RTOL, FWD_ATOL)
        scale = float(torch.maximum(dz_p.abs().max(), dzh_p.abs().max()))
        eb1, okb1 = within(dz_k, dz_p, BWD_RTOL, BWD_ATOL_REL * scale)
        eb2, okb2 = within(dzh_k, dzh_p, BWD_RTOL, BWD_ATOL_REL * scale)
        log(f"kernel check D={D} P={P} zero_cols={zero}: fwd max_abs_err={ef:.3e} "
            f"bwd max_abs_err dZ={eb1:.3e} dZhat={eb2:.3e} (grad scale {scale:.3e})")
        if not (okf and okb1 and okb2):
            fail(f"kernel disagrees with its plain version at D={D} P={P} "
                 f"zero_cols={zero}: fwd ok={okf} dZ ok={okb1} dZhat ok={okb2}")
        if zero and not (lp_k.isfinite().all() and dz_k.isfinite().all()
                         and dzh_k.isfinite().all()):
            fail("non-finite kernel output with a zero-norm column")
        if (D, P, zero) == (4096, 9, False):
            path_err = {"infonce_fwd": ef, "infonce_bwd": max(eb1, eb2)}

    D, P = 4096, 9
    Z, Zh, ghat = case(D, P)
    lp = log_p_flat(Z, Zh)
    timing = {
        "infonce_fwd": (cuda_time_ms(lambda: infonce.infonce_fwd(Z, Zh)),
                        cuda_time_ms(lambda: log_p_flat(Z, Zh)),
                        bound_ms(*fwd_bound(D, P))),
        "infonce_bwd": (cuda_time_ms(lambda: infonce.infonce_bwd(Z, Zh, lp, ghat)),
                        cuda_time_ms(lambda: infonce.grads_plain(Z, Zh, lp, ghat)),
                        bound_ms(*bwd_bound(D, P))),
    }
    device = {
        "infonce_fwd": profiled_device_ms(lambda: infonce.infonce_fwd(Z, Zh),
                                          "infonce_fwd_kernel"),
        "infonce_bwd": profiled_device_ms(
            lambda: infonce.infonce_bwd(Z, Zh, lp, ghat), "infonce_bwd_"),
    }
    for name, (k_ms, p_ms, (b_ms, b_by)) in timing.items():
        log(json.dumps({"kernel": name, "D": D, "P": P, "kernel_ms": k_ms,
                        "device_ms": device[name], "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "card": card}))
    return path_err, timing, device


def run_slice(dev):
    """Phase 4; returns (trainer, launches on the main path)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_cpc
    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.train.cpc_engine import SUBMODELS
    from federated_pytorch_test_tpu_torch.utils import codec

    for k in infonce.LAUNCHES:
        infonce.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, state, history = federated_cpc.main(["--device", "cuda"], log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(infonce.LAUNCHES)
    log(f"slice: {len(history)} rounds in {wall:.2f} s, launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "model", "block", "N", "loss", "dual_residual", "round_seconds",
            "stage_seconds", "compute_seconds", "kernel_launches")}))
    if len(history) != 4:
        fail(f"expected 4 rounds (one rotation), got {len(history)}")
    for rec in history:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["dual_residual"])):
            fail(f"non-finite loss or dual residual: {rec}")
    for mdl in SUBMODELS:
        for ci in range(len(trainer.models[mdl].train_order_block_ids())):
            order, mask, _ = trainer.block(mdl, ci)
            before = codec.get_trainable_values(trainer.state0[mdl], order, mask)
            after = codec.get_trainable_values(state[mdl], order, mask)
            if torch.equal(before, after):
                fail(f"block {ci} of {mdl} did not change")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return trainer, launches


def profile_steps(trainer) -> None:
    """One L-BFGS step of client 0 on block 0 of each sub-model at full
    width, under ``torch.profiler`` (CUDA activity only): host wall time,
    device busy time, and the InfoNCE kernels' share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.train.cpc_engine import (
        SUBMODELS,
        client_params,
    )
    from federated_pytorch_test_tpu_torch.utils import codec

    px, py, batch = trainer.data.round_batches(1, clients=[0])
    y = trainer.stage(batch)[0, 0]
    params = client_params(trainer.state0, 0)
    for mdl in SUBMODELS:
        order, mask, _ = trainer.block(mdl, 0)
        x = codec.get_trainable_values(params[mdl], order, mask)
        loss_fn = trainer.block_loss(mdl, order, mask, params, y, px, py)
        trainer.lbfgs.step(loss_fn, x, trainer.lbfgs.init(x))     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, st, _ = trainer.lbfgs.step(loss_fn, x, trainer.lbfgs.init(x))
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        nce_ms = sum(e.self_device_time_total for e in ev
                     if "infonce_" in e.key) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
        log(json.dumps({
            "profile_step": mdl, "closure_evals": st.func_evals,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "infonce_device_ms": nce_ms,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top]}))


def check_path_data(trainer) -> None:
    """Phase 5: loss and predictor gradient, kernels vs plain versions."""
    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.optim.lbfgs import value_and_grad
    from federated_pytorch_test_tpu_torch.train.cpc_engine import client_params
    from federated_pytorch_test_tpu_torch.utils import codec

    px, py, batch = trainer.data.round_batches(1, clients=[0])
    y = trainer.stage(batch)[0, 0]
    params = client_params(trainer.state0, 0)
    order, mask, _ = trainer.block("predictor", 0)
    x0 = codec.get_trainable_values(params["predictor"], order, mask)
    out = {}
    for label, impl in (("kernels", infonce.KERNELS), ("plain", infonce.PLAIN)):
        loss_fn = trainer.block_loss("predictor", order, mask, params, y,
                                     px, py, impl)
        out[label] = value_and_grad(loss_fn, x0)
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    loss_err = abs(float(lk) - float(lp))
    g_err, g_ok = within(gk, gp, GRAD_RTOL, GRAD_ATOL_REL * float(gp.abs().max()))
    log(f"path data: loss kernels={float(lk):.8e} plain={float(lp):.8e} "
        f"abs_err={loss_err:.3e}; grad max_abs_err={g_err:.3e} "
        f"(max |grad| {float(gp.abs().max()):.3e})")
    if loss_err > LOSS_RTOL * abs(float(lp)) or not g_ok:
        fail("CPC loss or gradient through the kernels disagrees with the "
             "plain versions on the path's data")


def main() -> None:
    import torch

    card, dev = check_device()
    sys.path.insert(0, ROOT)
    build()
    path_err, timing, device = check_kernels(dev, card)
    trainer, launches = run_slice(dev)
    check_path_data(trainer)
    profile_steps(trainer)

    replaces = {"infonce_fwd": "federated_pytorch_test_tpu/ops/infonce.py:135",
                "infonce_bwd": "federated_pytorch_test_tpu/ops/infonce.py:262"}
    kernels = []
    for name, (k_ms, p_ms, (b_ms, b_by)) in timing.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/infonce.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": path_err[name], "ms": k_ms,
            "device_ms": device[name], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
