#!/usr/bin/env python3
"""On-card smoke check of the PyTorch + CUDA port (``federated_pytorch_test_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Phases, each of
which stops the script with a non-zero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/infonce.cu``, ``csrc/gram.cu`` and ``csrc/quant.cu`` with
   ``nvcc`` for ``sm_90a``, the three compilers started together (the
   ptxas reports on one line each, the build seconds);
3. InfoNCE kernels vs plain: the forward and backward kernels against
   their plain PyTorch versions at the CPC path's shape (D=4096, P=9), at
   D=8/P=1, D=4099/P=130, D=256/P=1000, with an all-zero column in Z and
   in Zhat, on each side of ``plan``'s threshold (P=32 takes the cluster
   branch, P=33 the rows branch), at D=100,003/P=9 (a block's rows in
   tiles) and at D=20,000/P=4 and D=10,000/P=13 (a backward tile of more
   rows than a block's threads form at once), each case printed with its
   branch; at the path's shape three runs of both kernels equal bit for
   bit; then, at the path's shape, the time per call of kernel and plain
   version from CUDA events around 200 back-to-back calls (``ms``, host
   launch cost included), the kernels' device time from ``torch.profiler``
   (``device_ms``), the device kernels a call from a CUDA graph capture
   of one call (``device_kernels``, which must be 1; every profiler window
   is logged with the records it lost), the host-only time per call
   (``host_ms``: ``time.perf_counter`` around the calls, read before the
   device is synchronised), the card's bound, and the device time of the
   same calls on the rows branch, the first design's kernels
   (``rows_branch_device_ms``);
4. Gram kernel vs plain: ``gram`` against ``gram_plain`` at [10, 928] (the
   ResNet18 stem block's shard), [10, 2,360,320] (the largest block's
   shard), [1, 1], [3, 513], [16, 100,003], [128, 4,096], K = 17 and 33
   (tiled), n under one pipeline stage ([10, 300], [17, 700]), a slab with
   an all-zero row, column slabs ``w[:, 3:3+n]`` of a wider [10, n+8]
   matrix (rows off 16-byte alignment) at n = 928 and 100,003, and a row
   stride that is not a multiple of 4, within
   ``|kernel - plain| <= 1e-5 * max_i G_ii + 1e-6``, symmetric, repeating
   bit for bit; then three calls back to back at other n and the first
   again (the cross-block counter resets, G repeats bit for bit).  At the
   largest shard and at the stem: the time per call of the kernel and of
   ``torch.matmul(a, a.T)`` (TF32 off; the library yardstick), taken in
   turns, the plain version's, the kernel's device time, the host-only
   time per call, the device kernels per call (1, from a graph capture)
   and the bound;
5. slice 1 at full width: ``drivers.federated_cpc`` with its defaults
   (K=4, Lc=256, Rc=32, batch 128, patch 32, Niter=10, Nloop=1, Nadmm=1:
   one rotation of 4 communication rounds; nothing cut), with the InfoNCE
   launch counts set to 0 just before and read just after; every round's
   loss and dual residual finite, every trained block changed, both
   kernels launched;
6. slice 1's own data: the CPC loss and its gradient in the predictor's
   flat vector, at the initial weights and one real minibatch, through the
   kernels and through the plain versions;
7. a profile of one L-BFGS step per CPC sub-model at full width: host wall
   time, device busy time and the InfoNCE kernels' share (printed only);
8. slice 2 at full width: ``drivers.consensus_multi`` (ADMM consensus,
   ResNet18, K=10 clients, batch 128, float32, krum with
   ``--robust-chunked`` over a 2-shard client mesh), with the Gram launch
   count set to 0 just before and read just after.  Cut: Nloop 12 -> 1 and
   Nadmm 5 -> 2 (one rotation over the 10 blocks, 20 rounds), 1,280
   training images per client instead of 5,000, 1,000 test images; the
   data is the synthetic CIFAR-10 (the dataset is not in the repository).
   Every round's loss and residuals finite, every block changed, the Gram
   kernel launched in every round;
9. slice 2's own data: at the largest block's ([54,59], N = 4,720,640)
   first comm round, the real ``y + rho*x`` stack's shard Grams through
   the kernel and through ``gram_plain`` within the tolerance of phase 4,
   and krum's selection both ways.  Selections that differ fail, unless
   the float32 tie band of a score reaches the spread of all the scores:
   then krum is undecidable in float32 on that stack (on the synthetic
   data the clients move alike), which is printed as "undecided" and not
   counted as a pass.  Then the same stack with f clients (krum's
   attacker count) moved away, by a seeded offset that clears the others'
   scores by at least 100 tie bands: the shard Grams within tolerance,
   krum dropping exactly the moved clients through the kernel and through
   ``gram_plain`` alike, and the engine's krum estimate equal to the kept
   clients' mean;
10. a profile of one Adam step of all K clients on the stem block and on
    the largest block (printed only);
11. quantize (B1) and dequantize-accumulate (B2) kernels vs plain: at
    [9,220, 256] (the largest block's shard at D=2) with qmax 127 and 7,
    [4, 256] (the stem block's shard), [1, 2], [3, 130], [33, 64],
    [7, 512], [37, 1,000] and [5, 2,048],
    each with a zero row and a saturating row, and a row holding inf and
    NaN (its scale only: the cast of NaN to int8 has no defined value).
    Scale and q exactly equal; B2 bit for bit out of place, into a given
    ``out`` and in place (``out=acc``).  Then at [9,220, 256], over a ring
    of inputs larger than the L2 cache: the time per call of B2 out of
    place against ``torch.addcmul`` and in place against
    ``Tensor.addcmul_`` (each pair taken in turns), B1's, the device and
    host-only times, the plain versions' time and the bound;
12. slice 3 at full width: ``drivers.consensus_multi`` with ResNet18,
    ``--compress q8 --fused-collective --num-devices 2`` and slice 2's cuts
    (20 rounds), the B1/B2 launch counts set to 0 just before and read just
    after.  Every round's loss and residuals finite, every block changed,
    both kernels launched in every round, ``bytes_fused`` equal to the byte
    model and ``bytes_on_wire`` to K times the codec's payload;
13. slice 3's own data: at the largest block's first comm round, the real
    ``y + rho*x`` stack's fused mean through the kernels and through the
    plain versions bit for bit equal, at D=2 (butterfly) and D=5 (ring),
    both within ``(log2 D + 1)`` grid steps of the dense mean;
14. a profile of one comm step (encode, fused mean with the hops
    accumulating in place, ADMM update) at the largest block (printed
    only).

The line before the last is the per-kernel JSON record (with each
kernel's host-only time, and B3's stem and B2's in-place fields); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
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
#: phase 3's InfoNCE cases (D, P, zero columns): the CPC path's shape, a
#: single column, the rows branch at P = 130 and 1,000, a zero column in Z
#: and in Zhat, the last P of the cluster branch and the first of the rows
#: branch (ops/infonce.py plan), a D whose block rows go in tiles, and two
#: whose backward tiles (1,252 rows of P = 4, 628 of P = 13) hold more rows
#: than a block's 512 threads form at once
INFONCE_CASES = ((4096, 9, False), (8, 1, False), (4099, 130, False),
                 (256, 1000, False), (4096, 9, True), (4096, 32, False),
                 (4096, 33, False), (100_003, 9, False), (20_000, 4, False),
                 (10_000, 13, False))
#: the CPC loss through kernels vs plain versions, and its gradient
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
#: Gram: |kernel - plain| <= GRAM_REL * max_i G_ii + GRAM_ABS.  Both sum
#: float32 products in different orders; every entry is bounded by the
#: largest diagonal entry (Cauchy-Schwarz), so that sets the rounding scale.
GRAM_REL, GRAM_ABS = 1e-5, 1e-6
#: the Gram shapes: the stem and largest shards of ResNet18 at D=2, then
#: edge cases (one column, K past one tile and past two, n under one
#: pipeline stage)
GRAM_SHAPES = ((10, 928), (10, 2_360_320), (1, 1), (3, 513), (16, 100_003),
               (128, 4096), (17, 5_000), (33, 5_000), (10, 300), (17, 700))
GRAM_PATH_SHAPE = (10, 2_360_320)
GRAM_STEM_SHAPE = (10, 928)
#: column slabs w[:, 3:3+n] of a wider [10, n+8] matrix: rows off 16 B
GRAM_SLAB_NS = (928, 100_003)
#: back-to-back calls at different n (each several column chunks), then
#: the first again
GRAM_SEQUENCE = ((10, 100_003), (10, 1_000_000), (17, 60_000))
#: slice 2 as chip_smoke drives it (see the module docstring for the cuts)
SLICE2_ARGV = ["--device", "cuda", "--model", "resnet18", "--robust-agg",
               "krum", "--robust-chunked", "--num-devices", "2", "--Nloop",
               "1", "--Nadmm", "2", "--n-train", "1280", "--n-test", "1000"]
SLICE2_ROUNDS = 20
LARGEST_BLOCK_N = 4_720_640
#: B1/B2 shapes: the largest and the stem shard of ResNet18 at D=2, then
#: edge cases (a 2-wide row, a width that is not a multiple of 4, rows that
#: take B1's vector path with 1, 4 and 8 float4 a lane, a row wider than
#: the vector path's 1,024)
QUANT_SHAPES = ((9220, 256), (4, 256), (1, 2), (3, 130), (33, 64), (7, 512),
                (37, 1000), (5, 2048))
QUANT_PATH_SHAPE = (9220, 256)
#: timing ring: inputs enough to exceed the H100's 50 MB L2 cache in total
QUANT_RING = 8
#: slice 3 as chip_smoke drives it: slice 2's configuration and cuts with
#: the q8 fused collective in place of krum
SLICE3_ARGV = ["--device", "cuda", "--model", "resnet18", "--compress", "q8",
               "--fused-collective", "--num-devices", "2", "--Nloop", "1",
               "--Nadmm", "2", "--n-train", "1280", "--n-test", "1000"]
#: the byte models at the largest block (ops/packed_reduce.py,
#: compress/quantize.py): what the records must carry
LARGEST_BYTES_FUSED = 9_588_800
LARGEST_BYTES_ON_WIRE = 47_944_000
#: the Pallas sites B1 and B2 replace
QUANTIZE_SITE = "federated_pytorch_test_tpu/ops/comm_kernels.py:124"
DEQUANT_SITE = "federated_pytorch_test_tpu/ops/comm_kernels.py:182"
#: phase 9's separated case: each moved client's offset has squared norm
#: OUTLIER_SCALE2 * max G_ii, and the moved clients' krum scores must clear
#: the others' by SEPARATION float32 tie bands
OUTLIER_SCALE2, SEPARATION = 0.1, 100.0
#: the krum estimate vs a plain mean of the kept rows (float32, 9 rows
#: summed in another order): |est - mean| <= KRUM_MEAN_REL * max |kept rows|
KRUM_MEAN_REL = 1e-5


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


def paired_ms(fns: dict, iters: int = 200, rounds: int = 3) -> dict:
    """``cuda_time_ms`` of each function, taken in turns (a, b, a, b, ...)
    over ``rounds`` rounds; the median of each.  A kernel and the library
    call it is compared with are timed so, because the host's speed drifts
    within a call."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_time_ms(fn, iters=iters, warmup=10))
    return {k: statistics.median(v) for k, v in times.items()}


def host_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host time per call (ms): ``time.perf_counter`` around ``iters``
    back-to-back calls, read before the device is synchronised, so it is
    the wrapper's own cost (checks, allocation, the launch) and not the
    kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def kernels_a_call(fn) -> int:
    """Kernels that one call of ``fn`` launches, counted in a CUDA graph
    capture of the call: exact, where the profiler can lose records.  The
    first capture is a warm-up (a wrapper may set up state for the capture
    stream); nothing captured runs."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    for _ in range(2):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed on a captured call")
    nodes = (ctypes.c_void_p * n.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    graph.reset()
    return sum(k == 0 for k in kinds)       # CU_GRAPH_NODE_TYPE_KERNEL


def profiled(fn, name: str, iters: int = 50, tries: int = 3) -> tuple:
    """(device time per call (ms) of the CUDA kernels whose name contains
    ``name``, or None if the profiler saw none; device kernels per call,
    from :func:`kernels_a_call`), the time from ``torch.profiler``.  Every
    window is logged.  A window in which the profiler recorded none of the
    named kernels is taken again, up to ``tries`` windows.  In a long
    process the profiler can lose kernel records (on the H100, 43 of 50
    launches of a wrapper that launches one kernel a call, every call); a
    window that recorded fewer kernels than the capture's count times the
    calls is logged as such, and its time scaled by the share recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = kernels_a_call(fn)
    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in ev if name in e.key)
        count = sum(e.count for e in ev if name in e.key)
        total = sum(e.count for e in ev)
        lost = per_call * iters - total
        log(f"profile {name!r} window {t + 1}: {count} named and {total} "
            f"device kernels recorded in {iters} calls of {per_call} "
            f"kernels each, {us:.3f} us named"
            + (f"; the profiler lost {lost} records" if lost else ""))
        if count:
            break
    if us and lost > 0:
        us *= per_call * iters / total
    return (us / iters / 1e3 if us > 0 else None, per_call)


def profiled_device_ms(fn, name: str, iters: int = 50):
    """Device time per call (ms) of the CUDA kernels whose name contains
    ``name``, from ``torch.profiler``; None if the profiler saw none."""
    return profiled(fn, name, iters)[0]


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
    """Phase 2: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from federated_pytorch_test_tpu_torch.ops import cuda_build

    names = ("infonce", "gram", "quant")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load_library, n) for n in names]:
            f.result()
    log(f"build: {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for n in names:
        info = cuda_build.BUILD_INFO[n]
        log(f"build {n}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        log(f"ptxas {n}: {info['ptxas']}")


def check_kernels(dev, card: str):
    """Phase 3; returns ({kernel: max_abs_err at the path's shape},
    {kernel: (kernel_ms, plain_ms, (bound_ms, bound_by))},
    {kernel: device_ms}, {kernel: {"host_ms": host-only ms a call,
    "device_kernels": device kernels a call}})."""
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
    for D, P, zero in INFONCE_CASES:
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
        log(f"kernel check D={D} P={P} zero_cols={zero} "
            f"branch={infonce.plan(D, P).branch}: fwd max_abs_err={ef:.3e} "
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
    runs = [(infonce.infonce_fwd(Z, Zh), *infonce.infonce_bwd(Z, Zh, lp, ghat))
            for _ in range(3)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)):
        fail("InfoNCE kernels do not repeat bit for bit at D=4096 P=9")
    log("kernel check D=4096 P=9: log_p, dZ and dZhat equal bit for bit over 3 runs")
    timing = {
        "infonce_fwd": (cuda_time_ms(lambda: infonce.infonce_fwd(Z, Zh)),
                        cuda_time_ms(lambda: log_p_flat(Z, Zh)),
                        bound_ms(*fwd_bound(D, P))),
        "infonce_bwd": (cuda_time_ms(lambda: infonce.infonce_bwd(Z, Zh, lp, ghat)),
                        cuda_time_ms(lambda: infonce.grads_plain(Z, Zh, lp, ghat)),
                        bound_ms(*bwd_bound(D, P))),
    }
    calls = {"infonce_fwd": (lambda: infonce.infonce_fwd(Z, Zh), "infonce_fwd"),
             "infonce_bwd": (lambda: infonce.infonce_bwd(Z, Zh, lp, ghat),
                             "infonce_bwd_")}
    prof = {k: profiled(fn, key) for k, (fn, key) in calls.items()}
    device = {k: v[0] for k, v in prof.items()}
    extra = {k: {"host_ms": host_time_ms(fn), "device_kernels": prof[k][1]}
             for k, (fn, _) in calls.items()}
    for k, (_, per_call) in prof.items():
        if per_call != 1:
            fail(f"{k} at D={D} P={P} ran {per_call} device kernels a call; "
                 f"expected 1")
    # the same calls on the rows branch (the first design's kernels)
    rows = {"infonce_fwd": lambda: infonce.infonce_fwd(Z, Zh, branch="rows"),
            "infonce_bwd": lambda: infonce.infonce_bwd(Z, Zh, lp, ghat,
                                                       branch="rows")}
    for k, fn in rows.items():
        extra[k]["rows_branch_device_ms"] = profiled(fn, calls[k][1])[0]
    for name, (k_ms, p_ms, (b_ms, b_by)) in timing.items():
        log(json.dumps({"kernel": name, "D": D, "P": P,
                        "branch": infonce.plan(D, P).branch, "kernel_ms": k_ms,
                        "device_ms": device[name], **extra[name],
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "card": card}))
    return path_err, timing, device, extra


def gram_within(got, want) -> tuple:
    """(max |got - want|, tolerance, whether every entry is within it)."""
    tol = GRAM_REL * float(want.diagonal().max()) + GRAM_ABS
    err = float((got - want).abs().max())
    return err, tol, err <= tol and bool(got.isfinite().all())


def gram_bound(K: int, n: int) -> tuple:
    """(bytes, flops) of A.A^T for A [K, n] float32: A read once, G written
    once; 2*K^2*n operations for the product."""
    return (K * n + K * K) * 4, 2 * K * K * n


def gram_cases(dev, gen) -> list:
    """(label, A) of phase 4: GRAM_SHAPES, a slab with an all-zero row,
    column slabs ``w[:, 3:3+n]`` of a wider [10, n+8] matrix (base 12 B off
    16-byte alignment), and a row stride that is not a multiple of 4."""
    import torch

    cases = [(f"[{K}, {n}]", torch.randn(K, n, generator=gen, device=dev))
             for K, n in GRAM_SHAPES]
    a = torch.randn(10, 100_003, generator=gen, device=dev)
    a[4] = 0.0
    cases.append(("[10, 100003] zero row 4", a))
    for n in GRAM_SLAB_NS:
        w = torch.randn(10, n + 8, generator=gen, device=dev)
        cases.append((f"w[:, 3:3+{n}] of [10, {n + 8}]", w[:, 3:3 + n]))
    w = torch.randn(10, 1_001, generator=gen, device=dev)
    cases.append(("w[:, :1000] of [10, 1001] (lda % 4 = 1)", w[:, :1_000]))
    return cases


def check_gram(dev, card: str):
    """Phase 4; returns (max_abs_err at the path's shape,
    (kernel_ms, plain_ms, library_ms, (bound_ms, bound_by)), device_ms,
    {the host-only, kernels-per-call and stem fields of the JSON line})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import gram

    gen = torch.Generator(device=dev).manual_seed(0)
    path_err = None
    for label, a in gram_cases(dev, gen):
        g_k = gram.gram(a)
        g_p = gram.gram_plain(a)
        repeat = torch.equal(g_k, gram.gram(a))
        torch.cuda.synchronize()
        err, tol, ok = gram_within(g_k, g_p)
        vec = gram.vector_path(a.data_ptr(), a.stride(0) if a.shape[0] > 1
                               else 0, a.shape[1])
        log(f"gram check {label} strides {a.stride()} "
            f"{'16-byte' if vec else '4-byte'} copies: max_abs_err={err:.3e} "
            f"tol={tol:.3e} symmetric={torch.equal(g_k, g_k.t())} "
            f"repeats={repeat}")
        if not (ok and repeat and torch.equal(g_k, g_k.t())):
            fail(f"gram kernel disagrees with gram_plain (or is not symmetric "
                 f"or not repeatable) at {label}")
        if "zero row" in label and not (g_k[4].eq(0).all()
                                        and g_k[:, 4].eq(0).all()):
            fail("gram of a zero row is not a zero row and column")
        if tuple(a.shape) == GRAM_PATH_SHAPE:
            path_err = err
    # back to back at three n (each with several chunks, so the cross-block
    # counter is used), then the first again: the counter was reset, and G
    # repeats bit for bit
    seq = [torch.randn(K, n, generator=gen, device=dev)
           for K, n in GRAM_SEQUENCE]
    first = [gram.gram(a) for a in seq]
    again = gram.gram(seq[0])
    torch.cuda.synchronize()
    for (K, n), a, g_k in zip(GRAM_SEQUENCE, seq, first):
        err, tol, ok = gram_within(g_k, gram.gram_plain(a))
        if not ok:
            fail(f"gram kernel disagrees with gram_plain at [{K}, {n}] in a "
                 f"back-to-back sequence")
    log(f"gram sequence {list(GRAM_SEQUENCE)} then the first again: "
        f"bit-for-bit repeat {torch.equal(first[0], again)}")
    if not torch.equal(first[0], again):
        fail("gram does not repeat bit for bit after calls at other n")

    out = {}
    for key, (K, n) in (("", GRAM_PATH_SHAPE), ("stem_", GRAM_STEM_SHAPE)):
        a = torch.randn(K, n, generator=gen, device=dev)
        big = key == ""
        turns = paired_ms({"kernel": lambda: gram.gram(a),
                           "library": lambda: torch.matmul(a, a.t())},
                          iters=100)
        k_ms, l_ms = turns["kernel"], turns["library"]
        p_ms = cuda_time_ms(lambda: gram.gram_plain(a), iters=3 if big else 50,
                            warmup=1)
        dev_ms, per_call = profiled(lambda: gram.gram(a), "gram_")
        out[key] = {"kernel_ms": k_ms, "device_ms": dev_ms,
                    "host_ms": host_time_ms(lambda: gram.gram(a)),
                    "kernels_per_call": per_call, "plain_ms": p_ms,
                    "library_ms": l_ms, "bound": bound_ms(*gram_bound(K, n))}
        if per_call != 1:
            fail(f"gram at [{K}, {n}] ran {per_call} device kernels a call; "
                 f"expected 1")
    big, stem = out[""], out["stem_"]
    extra = {"host_ms": big["host_ms"],
             "kernels_per_call": big["kernels_per_call"],
             **{f"stem_{k}": stem[k] for k in (
                 "kernel_ms", "device_ms", "host_ms", "kernels_per_call",
                 "plain_ms", "library_ms")},
             "stem_bound_ms": stem["bound"][0],
             "stem_bound_by": stem["bound"][1]}
    K, n = GRAM_PATH_SHAPE
    log(json.dumps({"kernel": "gram", "K": K, "n": n,
                    "kernel_ms": big["kernel_ms"],
                    "device_ms": big["device_ms"], "plain_ms": big["plain_ms"],
                    "library_ms": big["library_ms"],
                    "bound_ms": big["bound"][0], "bound_by": big["bound"][1],
                    **extra, "card": card}))
    return path_err, (big["kernel_ms"], big["plain_ms"], big["library_ms"],
                      big["bound"]), big["device_ms"], extra


def run_slice(dev):
    """Phase 5; returns (trainer, launches on the main path)."""
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
    """Phase 6: loss and predictor gradient, kernels vs plain versions."""
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


def run_slice2(dev):
    """Phase 8; returns (the Gram launches of the run, the captured
    ``y + rho*x`` stack of the largest block's first comm round)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm
    from federated_pytorch_test_tpu_torch.utils import codec

    captured = {}
    chunked = comm.robust_federated_mean_chunked

    def capture(x, w=None, **kw):
        # the engine's krum estimator sees the ADMM stack y + rho*x itself
        if x.shape[1] == LARGEST_BLOCK_N and "stack" not in captured:
            captured["stack"] = x.detach().clone()
        return chunked(x, w, **kw)

    comm.robust_federated_mean_chunked = capture
    try:
        gram.LAUNCHES["gram"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(SLICE2_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram.LAUNCHES["gram"]
    finally:
        comm.robust_federated_mean_chunked = chunked
    log(f"slice 2: {len(history)} rounds in {wall:.2f} s, gram launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "primal_residual",
            "round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
            "kernel_launches")}))
    if len(history) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "dual_residual", "primal_residual")):
            fail(f"non-finite loss or residual: {rec}")
        if rec["kernel_launches"]["gram"] < 1:
            fail(f"the Gram kernel was not launched in round {rec}")
    if launches < len(history):
        fail(f"gram launched {launches} times over {len(history)} rounds")
    for ci in range(trainer.L):
        mask = trainer.mask_for_block(ci)
        before = codec.get_trainable_stack(trainer.params0, trainer.order, mask)
        after = codec.get_trainable_stack(state.params, trainer.order, mask)
        if torch.equal(before, after):
            fail(f"block {ci} did not change")
    if "stack" not in captured:
        fail("the largest block's comm round was not reached")
    return launches, captured["stack"], trainer, state


def profile_slice2(trainer, state) -> None:
    """Phase 10 (printed only): one Adam step of all K clients on the stem
    block [0,2] and on the largest block [54,59] under ``torch.profiler``
    (CUDA activity): host wall time, device busy time and idle share, the
    top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.train.engine import (
        AdamState,
        ClientState,
    )

    K = trainer.cfg.K
    xb, yb, wb = trainer._stage_epoch(last=True)
    xb, yb, wb = xb[:, :1], yb[:, :1], wb[:, :1]
    for ci in (0, 8):
        N = trainer.block_size(ci)
        zeros = torch.zeros(K, N, device=trainer.device)
        st = ClientState(state.params, state.batch_stats,
                         AdamState(zeros, zeros.clone(), 0))
        args = (ci, zeros, zeros[0], torch.tensor(0.1, device=trainer.device),
                xb, yb, wb)
        trainer.train_epoch(st, *args)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_epoch(st, *args)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
        log(json.dumps({
            "profile_step": f"classifier block {ci}", "N": N, "clients": K,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top]}))


def krum_two_ways(stack, trainer, label: str) -> dict:
    """Krum on ``stack`` [K, N] over the trainer's client mesh, with the
    shard Grams from the kernel and from ``gram_plain``.  Fails if a shard
    Gram is out of the tolerance of phase 4.  Returns the summed Grams,
    selections and scores both ways, the active mask, f, and the float32
    tie band of a score: a squared distance is ``G_ii + G_jj - 2 G_ij``,
    so it carries the two Grams' difference (x4) plus the rounding of its
    own three operations on values up to ``2 max G_ii``, and a score sums
    ``n_nb`` of them."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm

    K, mesh, trim = stack.shape[0], trainer.mesh, trainer.cfg.trim_frac
    slabs = mesh.all_to_all(stack)
    finite = mesh.psum([(~torch.isfinite(s)).float().sum(dim=1)
                        for s in slabs]) == 0
    _, act, m, _ = comm._screen(None, K, finite, stack)
    safe = [comm._where0(act[:, None], s) for s in slabs]
    kern = [gram.gram(s) for s in safe]
    plain = [gram.gram_plain(s) for s in safe]
    torch.cuda.synchronize()
    for d, (gk, gp) in enumerate(zip(kern, plain)):
        err, tol, ok = gram_within(gk, gp)
        log(f"path data ({label}): shard {d} gram [{K}, {safe[d].shape[1]}] "
            f"max_abs_err={err:.3e} tol={tol:.3e} "
            f"(max G_ii {float(gp.diagonal().max()):.6e})")
        if not ok:
            fail(f"gram kernel disagrees with gram_plain on shard {d} of the "
                 f"path's {label} stack")
    out = {"act": act, "m": m}
    for way, parts in (("kernel", kern), ("plain", plain)):
        g = mesh.psum(parts)
        score, f = comm.krum_scores(g, act, m, trim)
        out[way] = (comm.krum_select(g, act, m, trim), score, g)
    out["f"] = int(f)
    g_k, g_p = out["kernel"][2], out["plain"][2]
    n_nb = max(float(m) - out["f"] - 2.0, 1.0)
    ulp = torch.finfo(torch.float32).eps * 2.0 * float(g_p.diagonal().max())
    out["band"] = n_nb * (4.0 * float((g_k - g_p).abs().max()) + 3.0 * ulp)
    for way in ("kernel", "plain"):
        sel, score, _ = out[way]
        log(f"path data ({label}): krum keeps clients "
            f"{torch.nonzero(sel).flatten().tolist()} ({way}); scores "
            f"{score.tolist()}")
    log(f"path data ({label}): float32 tie band of a score {out['band']:.3e}")
    return out


def check_gram_path_data(stack, trainer) -> str:
    """Phase 9: krum on the real ``y + rho*x`` stack, and on the same stack
    with f clients moved away, through the kernel and ``gram_plain``.
    Returns what the raw stack showed: "same" or "undecided"."""
    import torch

    raw = krum_two_ways(stack, trainer, "y + rho*x")
    act = raw["act"]
    if torch.equal(raw["kernel"][0], raw["plain"][0]):
        verdict = "same"
    else:
        scores = torch.cat([raw[w][1][act] for w in ("kernel", "plain")])
        spread = float(scores.max() - scores.min())
        if raw["band"] < spread:
            fail("krum selects other clients through the kernel than "
                 "through gram_plain on the path's own data, while the "
                 f"scores spread {spread:.3e}, beyond the float32 tie band "
                 f"{raw['band']:.3e}")
        verdict = "undecided"
        log(f"path data (y + rho*x): UNDECIDED, not counted as a pass: the "
            f"selections differ, and the float32 tie band of a score "
            f"{raw['band']:.3e} reaches the spread of all scores "
            f"{spread:.3e}, so no float32 summation order decides krum here")

    # The separated case: move f clients (krum's attacker count) away from
    # the rest by an offset of norm^2 OUTLIER_SCALE2 * max G_ii in a random
    # direction each.  Krum must then drop exactly those, both ways alike.
    f = raw["f"]
    if f < 1:
        fail("the configuration gives krum no client to drop (f = 0)")
    outl = sorted(np.random.default_rng(1).choice(
        torch.nonzero(act).flatten().tolist(), f, replace=False).tolist())
    r = (OUTLIER_SCALE2 * float(raw["plain"][2].diagonal().max())) ** 0.5
    gen = torch.Generator(device=stack.device).manual_seed(1)
    sep = stack.clone()
    for i in outl:
        u = torch.randn(stack.shape[1], generator=gen, device=stack.device)
        sep[i] += r * u / u.norm()
    moved = torch.zeros_like(act)
    moved[outl] = True
    keep = act & ~moved
    res = krum_two_ways(sep, trainer, "separated")
    for way in ("kernel", "plain"):
        score = res[way][1]
        gap = float(score[moved].min() - score[keep].max())
        log(f"path data (separated): clients {outl} moved by "
            f"{r:.4e}; score gap ({way}) {gap:.4e} = "
            f"{gap / res['band']:.1f} tie bands")
        if gap < SEPARATION * res["band"]:
            fail(f"the offset separates the moved clients by {gap:.3e}, "
                 f"less than {SEPARATION} tie bands ({res['band']:.3e})")
    sk, sp = res["kernel"][0], res["plain"][0]
    if not torch.equal(sk, sp) or not torch.equal(sk, keep):
        fail(f"krum keeps {torch.nonzero(sk).flatten().tolist()} through the "
             f"kernel and {torch.nonzero(sp).flatten().tolist()} through "
             f"gram_plain; expected every active client but {outl}")
    # the engine's own estimator on the separated stack: the mean of the
    # kept clients
    est = trainer.mean_fn(sep)
    want = sep[keep].mean(dim=0)
    torch.cuda.synchronize()
    err = float((est - want).abs().max())
    tol = KRUM_MEAN_REL * float(sep[keep].abs().max())
    log(f"path data (separated): krum estimate vs the kept clients' mean "
        f"max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        fail("the engine's krum estimate is not the mean of the clients "
             "krum keeps")
    return verdict

def same_scale(a, b) -> bool:
    """Scales equal element for element, a NaN matching a NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def quant_bound(c: int, w: int, name: str) -> tuple:
    """(bytes, operations) of B1 or B2 on [c, w] rows, each input read once
    and each output written once.  B1 reads v (f32) and writes q (int8) and
    the scales; per element abs, max, divide, round and two clamps.  B2
    reads acc (f32), q (int8) and the scales and writes out (f32); per
    element a multiply and an add."""
    if name == "quantize_chunks":
        return c * w * 4 + c * w + c * 4, 6 * c * w
    return c * w * 4 + c * w + c * 4 + c * w * 4, 2 * c * w


def check_quant(dev, card: str):
    """Phase 11; returns ({kernel: max_abs_err at the path's shape},
    {kernel: (kernel_ms, plain_ms, library_ms, (bound_ms, bound_by))},
    {kernel: device_ms}, {kernel: {host-only and in-place fields}})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(3)
    path_err = {}
    for c, w in QUANT_SHAPES:
        for qmax in (127, 7):
            v = torch.randn(c, w, generator=gen, device=dev)
            if c >= 3:
                v[1] = 0.0                              # a zero row
                v[2] *= 1e-6                            # a saturating row
                v[2, w // 2] = -50.0
            q_k, s_k = quant.quantize_chunks(v, qmax)
            q_p, s_p = quant.quantize_plain(v, qmax)
            acc = torch.randn(c, w, generator=gen, device=dev)
            o_p = quant.dequant_add_plain(acc, q_p, s_p)
            # B2 out of place, into a given out, and in place (out=acc) on
            # a clone of acc
            o_k = quant.dequant_add(acc, q_p, s_p)
            o_out = torch.empty_like(acc)
            quant.dequant_add(acc, q_p, s_p, out=o_out)
            o_in = acc.clone()
            quant.dequant_add(o_in, q_p, s_p, out=o_in)
            torch.cuda.synchronize()
            s_err = float((s_k - s_p).abs().max())
            q_err = int((q_k.int() - q_p.int()).abs().max())
            o_err = max(float((o - o_p).abs().max()) for o in (o_k, o_out, o_in))
            sat = c < 3 or int(q_k[2, w // 2]) == -qmax
            b2_same = [torch.equal(o, o_p) for o in (o_k, o_out, o_in)]
            log(f"quant check [{c}, {w}] qmax={qmax}: scale max_abs_err="
                f"{s_err:.3e} q max_abs_err={q_err} dequant_add max_abs_err="
                f"{o_err:.3e} bitwise (out of place, into out, in place) "
                f"{b2_same} saturating row -> -qmax: {sat}")
            if not (same_scale(s_k, s_p) and torch.equal(q_k, q_p)
                    and all(b2_same) and sat):
                fail(f"quantize/dequant_add kernels disagree with their plain "
                     f"versions at [{c}, {w}] qmax={qmax}")
            if (c, w) == QUANT_PATH_SHAPE and qmax == 127:
                path_err = {"quantize_chunks": max(s_err, float(q_err)),
                            "dequant_add": o_err}
    # a row with inf, a row with NaN, a row with both: the scale only (the
    # cast of NaN to int8 has no defined value on either side)
    v = torch.randn(4, 256, generator=gen, device=dev)
    v[1, 3] = float("inf")
    v[2, 5] = float("nan")
    v[3, 0], v[3, 7] = float("-inf"), float("nan")
    _, s_k = quant.quantize_chunks(v, 127)
    _, s_p = quant.quantize_plain(v, 127)
    torch.cuda.synchronize()
    log(f"quant check non-finite rows: scales kernel {s_k.tolist()} plain "
        f"{s_p.tolist()}")
    if not (same_scale(s_k, s_p) and s_k[1].isinf() and s_k[2].isnan()
            and s_k[3].isnan()):
        fail("the quantize kernel's scale of a non-finite row disagrees with "
             "the plain version's")

    # time at the path's shape over a ring of inputs (75 MB of v, 94 MB of
    # acc: more than the 50 MB L2), so that each call reads device memory
    c, w = QUANT_PATH_SHAPE
    vs = [torch.randn(c, w, generator=gen, device=dev)
          for _ in range(QUANT_RING)]
    accs = [torch.randn(c, w, generator=gen, device=dev)
            for _ in range(QUANT_RING)]
    packs = [quant.quantize_plain(x, 127) for x in vs]
    safes = [torch.where(s > 0, s, torch.ones_like(s))[:, None]
             for _, s in packs]
    turn = [0]

    def ring(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % QUANT_RING
            return fn(i)
        return call

    b1 = ring(lambda i: quant.quantize_chunks(vs[i], 127))
    b1_plain = ring(lambda i: quant.quantize_plain(vs[i], 127))
    b2 = ring(lambda i: quant.dequant_add(accs[i], *packs[i]))
    b2_plain = ring(lambda i: quant.dequant_add_plain(accs[i], *packs[i]))
    b2_lib = ring(lambda i: torch.addcmul(accs[i], packs[i][0], safes[i]))
    # in place: the accumulators grow by one decoded payload a call
    b2_in = ring(lambda i: quant.dequant_add(accs[i], *packs[i], out=accs[i]))
    b2_in_lib = ring(lambda i: accs[i].addcmul_(packs[i][0], safes[i]))
    out_of_place = paired_ms({"kernel": b2, "library": b2_lib})
    in_place = paired_ms({"kernel": b2_in, "library": b2_in_lib})
    timing = {
        "quantize_chunks": (cuda_time_ms(b1), cuda_time_ms(b1_plain, iters=50),
                            None, bound_ms(*quant_bound(c, w, "quantize_chunks"))),
        "dequant_add": (out_of_place["kernel"],
                        cuda_time_ms(b2_plain, iters=50),
                        out_of_place["library"],
                        bound_ms(*quant_bound(c, w, "dequant_add"))),
    }
    device = {"quantize_chunks": profiled_device_ms(b1, "quantize_"),
              "dequant_add": profiled_device_ms(b2, "dequant_add_")}
    extra = {
        "quantize_chunks": {"host_ms": host_time_ms(b1)},
        "dequant_add": {"host_ms": host_time_ms(b2),
                        "inplace_ms": in_place["kernel"],
                        "inplace_device_ms": profiled_device_ms(
                            b2_in, "dequant_add_"),
                        "inplace_host_ms": host_time_ms(b2_in),
                        "inplace_library_ms": in_place["library"]},
    }
    for name, (k_ms, p_ms, l_ms, (b_ms, b_by)) in timing.items():
        log(json.dumps({"kernel": name, "c": c, "chunk": w, "qmax": 127,
                        "kernel_ms": k_ms, "device_ms": device[name],
                        **extra[name], "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "timed_over": f"a ring of {QUANT_RING} inputs",
                        "card": card}))
    return path_err, timing, device, extra


def run_slice3(dev):
    """Phase 12; returns (the B1/B2 launches of the run, the captured
    ``y + rho*x`` stack of the largest block's first comm round, the
    trainer, the final state)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        fused_bytes_on_wire,
    )
    from federated_pytorch_test_tpu_torch.train import engine
    from federated_pytorch_test_tpu_torch.utils import codec

    captured = {}
    make = engine.make_fused_mean

    def capturing(compressor, mesh, K):
        mean_fn = make(compressor, mesh, K)

        def fn(stack, w=None):
            # the engine's fused mean sees the ADMM stack y + rho*x itself
            if stack.shape[1] == LARGEST_BLOCK_N and "stack" not in captured:
                captured["stack"] = stack.detach().clone()
            return mean_fn(stack, w)

        return fn

    engine.make_fused_mean = capturing
    try:
        for k in quant.LAUNCHES:
            quant.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(SLICE3_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(quant.LAUNCHES)
    finally:
        engine.make_fused_mean = make
    log(f"slice 3: {len(history)} rounds in {wall:.2f} s, launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    K, comp = trainer.cfg.K, trainer.compressor
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "primal_residual",
            "round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
            "bytes_on_wire", "bytes_fused", "kernel_launches")}))
    if len(history) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "dual_residual", "primal_residual")):
            fail(f"non-finite loss or residual: {rec}")
        if min(rec["kernel_launches"][k] for k in launches) < 1:
            fail(f"a quantize kernel was not launched in round {rec}")
        N = rec["N"]
        if rec["bytes_fused"] != fused_bytes_on_wire(comp, N, trainer.D, K):
            fail(f"bytes_fused {rec['bytes_fused']} is not the byte model's "
                 f"{fused_bytes_on_wire(comp, N, trainer.D, K)} at N={N}")
        if rec["bytes_on_wire"] != K * comp.bytes_on_wire(N):
            fail(f"bytes_on_wire {rec['bytes_on_wire']} is not "
                 f"{K} x {comp.bytes_on_wire(N)} at N={N}")
        if N == LARGEST_BLOCK_N and (
                rec["bytes_fused"], rec["bytes_on_wire"]) != (
                LARGEST_BYTES_FUSED, LARGEST_BYTES_ON_WIRE):
            fail(f"the largest block's bytes {rec['bytes_fused']}, "
                 f"{rec['bytes_on_wire']} are not {LARGEST_BYTES_FUSED}, "
                 f"{LARGEST_BYTES_ON_WIRE}")
    for ci in range(trainer.L):
        mask = trainer.mask_for_block(ci)
        before = codec.get_trainable_stack(trainer.params0, trainer.order, mask)
        after = codec.get_trainable_stack(state.params, trainer.order, mask)
        if torch.equal(before, after):
            fail(f"block {ci} did not change")
    if "stack" not in captured:
        fail("the largest block's comm round was not reached")
    return launches, captured["stack"], trainer, state


def check_fused_path_data(stack, trainer) -> None:
    """Phase 13: the fused mean of the real ``y + rho*x`` stack through the
    kernels and through the plain versions, at D=2 and D=5."""
    import math

    import torch

    from federated_pytorch_test_tpu_torch.ops import packed_reduce as pr
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

    K, n = stack.shape
    bits, chunk = pr.transport_params(trainer.compressor)
    dense = stack.double().mean(dim=0)
    pad = -n % chunk
    top = torch.nn.functional.pad(dense.abs(), (0, pad)).reshape(-1, chunk)
    step = (2.0 * top.amax(dim=1) / (2 ** bits - 2)).repeat_interleave(chunk)[:n]
    for D in (2, 5):
        mesh = ClientMesh(D)
        local, div = pr._weighted_local_sum(stack, None, K, mesh)
        before = dict(quant.LAUNCHES)
        got = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.KERNELS)
        launched = {k: quant.LAUNCHES[k] - before[k] for k in before}
        plain = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.PLAIN)
        torch.cuda.synchronize()
        steps = float(((got.double() - dense).abs() / step.clamp(min=1e-30))
                      .max())
        log(f"path data (fused mean, D={D}): kernels vs plain bitwise "
            f"{torch.equal(got, plain)} (max_abs_err "
            f"{float((got - plain).abs().max()):.3e}); launches {launched}; "
            f"vs the dense mean {steps:.4f} grid steps (limit "
            f"{math.log2(D) + 1:.4f}); max |mean| {float(dense.abs().max()):.4e}")
        if not torch.equal(got, plain):
            fail(f"the fused mean through the kernels differs from the plain "
                 f"versions on the path's stack at D={D}")
        if min(launched.values()) < 1:
            fail(f"the fused mean at D={D} launched no kernel: {launched}")
        if not steps <= math.log2(D) + 1:
            fail(f"the fused mean at D={D} lies {steps:.3f} grid steps from "
                 f"the dense mean, beyond log2(D) + 1")


def profile_comm_step(trainer, state) -> None:
    """Phase 14 (printed only): one comm step at the largest block: the
    encode (with the decode), the fused mean and the whole ADMM update,
    each timed on the host clock around a device sync; the whole step's
    wall time; then the step under ``torch.profiler``: device busy time,
    idle share, the B1/B2 share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.parallel.comm import decode_stack
    from federated_pytorch_test_tpu_torch.train.engine import ClientState
    from federated_pytorch_test_tpu_torch.utils import codec

    ci = next(c for c in range(trainer.L)
              if trainer.block_size(c) == LARGEST_BLOCK_N)
    K, dev, N = trainer.cfg.K, trainer.device, LARGEST_BLOCK_N
    z = torch.zeros(N, device=dev)
    y = torch.zeros(K, N, device=dev)
    rho = torch.tensor(trainer.cfg.admm_rho0, device=dev)
    x0 = yhat0 = torch.zeros(K, 1, device=dev)
    st = ClientState(state.params, state.batch_stats, None,
                     trainer._init_comp_state(ci))
    comp = trainer.compressor
    x = codec.get_trainable_stack(st.params, trainer.order,
                                  trainer.mask_for_block(ci))
    trainer.comm_round(st, ci, z, y, rho, x0, yhat0)            # warm-up
    parts = {}
    for _ in range(2):                    # the second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload, _ = comp.encode(x - z[None, :], st.comp)
        xh = z[None, :] + decode_stack(payload, comp, N)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.mean_fn(y + rho * xh, None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.algo.global_update(xh, z, y, rho, K, trainer.mesh,
                                   mean_fn=trainer.mean_fn)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts = {"encode_decode_ms": (t1 - t0) * 1e3,
                 "fused_mean_ms": (t2 - t1) * 1e3,
                 "admm_update_ms": (t3 - t2) * 1e3}
    # the step's wall time without the profiler (whose start and stop
    # would fall inside the window), then its device time under it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.comm_round(st, ci, z, y, rho, x0, yhat0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.comm_round(st, ci, z, y, rho, x0, yhat0)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    quant_ms = sum(e.self_device_time_total for e in ev
                   if "quantize_" in e.key or "dequant_add" in e.key) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    log(json.dumps({
        "profile_step": "comm step, largest block", "N": N, "clients": K,
        **parts, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "quant_kernels_device_ms": quant_ms,
        "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in top]}))


def main() -> None:
    import torch

    card, dev = check_device()
    sys.path.insert(0, ROOT)
    build()
    path_err, timing, device, extra = check_kernels(dev, card)
    gram_err, gram_timing, gram_device, extra["gram"] = check_gram(dev, card)
    trainer, launches = run_slice(dev)
    check_path_data(trainer)
    profile_steps(trainer)
    del trainer
    gram_launches, stack, trainer2, state2 = run_slice2(dev)
    raw_krum = check_gram_path_data(stack, trainer2)
    profile_slice2(trainer2, state2)
    del trainer2, state2, stack
    quant_err, quant_timing, quant_device, quant_extra = check_quant(dev, card)
    extra.update(quant_extra)
    quant_launches, stack3, trainer3, state3 = run_slice3(dev)
    check_fused_path_data(stack3, trainer3)
    profile_comm_step(trainer3, state3)
    log(f"summary: krum's selection on the raw y + rho*x stack, kernel vs "
        f"gram_plain: {raw_krum}")

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
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            **extra[name]})
    k_ms, p_ms, l_ms, (b_ms, b_by) = gram_timing
    kernels.append({
        "name": "gram", "route": "cuda",
        "source": "federated_pytorch_test_tpu_torch/csrc/gram.cu",
        "replaces": "federated_pytorch_test_tpu/ops/comm_kernels.py:250",
        "launches": gram_launches, "max_abs_err": gram_err, "ms": k_ms,
        "device_ms": gram_device, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms, **extra["gram"]})
    for name, (k_ms, p_ms, l_ms, (b_ms, b_by)) in quant_timing.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/quant.cu",
            "replaces": {"quantize_chunks": QUANTIZE_SITE,
                         "dequant_add": DEQUANT_SITE}[name],
            "launches": quant_launches[name], "max_abs_err": quant_err[name],
            "ms": k_ms, "device_ms": quant_device[name], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **extra[name]})
    log(card)                        # again here, where an output tail keeps it
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
