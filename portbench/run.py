"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: imports, the card, the inputs made from the
seed, the program's trainer, and its first rounds, which warm every shape
the cell uses and which the check compares) is ``setup_s``.  The window
then runs the program's rounds until ``--seconds`` have passed, at a round
boundary.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics: those of the host and the program's
records from the window, those of the card from :data:`TRACE_ROUNDS` more
rounds run under ``torch.profiler`` after it.  Then the peak device
memory is read, the
program's state is freed, and the plain reference follows the same first
rounds from the same inputs; ``correct`` says whether the program's
rounds lie within the cell's limits of it.

The last line of standard output is one JSON object; the numbers compared
and their limits are also the last lines of standard error.  Exits
non-zero, printing no result, without enough CUDA devices, when a file the
cell needs is missing, or when the process holds a JAX module at the end.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

#: rounds a ``--trace 1`` run traces after its window
TRACE_ROUNDS = 2

#: top-level module names the run may not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "federated_pytorch_test_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Keep every build and kernel cache at a fixed path in the checkout
    (the program's nvcc builds already go to ``build/torch_kernels``)."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def check_device(chips: int):
    """The card the cell runs on; exits when there are fewer than
    ``chips``."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), "
              f"this machine has {n}", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, fault=None, pre=None) -> dict:
    """One run of the cell ``spec`` on ``device``; returns the result
    object.  ``fault``: a callable planting a fault in the program under
    test (the checks' tests); ``pre``: the seconds of the set-up phases
    before the call, by name."""
    import torch

    from portbench import check, counts, session
    from portbench import spec as speclib
    from portbench import trace as tracelib

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_start0 = time.perf_counter()
    st = session.start(spec, seed, device, spans=trace, fault=fault)
    cell = st.cell
    setup_s = time.perf_counter() - t0
    print("portbench: set-up " + " ".join(
        f"{k} {v:.3f} s" for k, v in
        [*(pre or {"imports and card": t_start0 - t0}).items(),
         *st.phases.items()]), file=sys.stderr)

    # the window: rounds until --seconds have passed
    cell.comm_events.clear()
    cell.launches.clear()
    n0 = len(cell.records("round"))
    rounds, marks, cpu = 0, [], []
    c0 = time.process_time()
    t_start = time.perf_counter()
    while True:
        cell.round()
        rounds += 1
        marks.append(time.perf_counter() - t_start)
        cpu.append(time.process_time() - c0)
        if marks[-1] >= seconds:
            break
    window_s = marks[-1]
    win = cell.records("round")[n0:]
    comm_ms = [a.elapsed_time(b) for a, b in cell.comm_events]
    reduced, launches = None, []
    if trace:
        # the card's events over TRACE_ROUNDS more rounds, after the window
        # (the profiler slows the host's dispatch, so the window runs
        # without it)
        from torch.profiler import ProfilerActivity, profile
        cell.spans.clear()
        cell.launches.clear()
        with profile(activities=[ProfilerActivity.CUDA] if cuda else
                     [ProfilerActivity.CPU]) as prof:
            t_ns = time.time_ns()
            for _ in range(TRACE_ROUNDS):
                cell.round()
            t_end_ns = time.time_ns()
        reduced = tracelib.reduce(prof, t_ns, t_end_ns, cell.spans)
        launches = list(cell.launches)
        del prof
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    images_window = rounds * cell.images_per_round
    failed = sum(1 for r in win if not math.isfinite(r.get("loss", math.nan)))
    print("portbench: window rounds ended at " + " ".join(
        f"{m:.3f}" for m in marks) + " s, process CPU " + " ".join(
        f"{c:.3f}" for c in cpu) + " s", file=sys.stderr)
    cell.drop_spans()
    cell.close()
    st.cell = cell = None
    session.free(device)

    # the reference follows the same first rounds from the same inputs
    ref = session.reference(spec, st, device)
    nums = session.compare(spec, st.prog, ref, st.x_init)
    correct = check.verdict(nums, spec.limits) and failed == 0

    config, traffic = spec.config, spec.traffic
    fwd, bwd = counts.step_flops(config["num_blocks"],
                                 tuple(config["blocks"][traffic["block"]]),
                                 config["num_classes"])
    ctx = SimpleNamespace(rounds=win, window_s=window_s, images=images_window,
                          flops=images_window * (fwd + bwd), trace=reduced,
                          comm_ms=comm_ms, launches=launches,
                          traced_rounds=TRACE_ROUNDS if trace else 0,
                          traffic=traffic, config=config)
    metrics = {}
    if trace:
        for m in spec.per_layer:
            value = speclib.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"train_images_per_s": images_window / window_s,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": rounds, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["compared"] = {n: {"value": nums.get(n), "limit": lim}
                          for n, lim in spec.limits.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import check, spec as speclib

    try:
        spec = speclib.load(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: cannot load cell {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    cache_dirs(speclib.ROOT)
    t1 = time.perf_counter()
    import torch

    t2 = time.perf_counter()
    from portbench import session  # noqa: F401  (imports the program)

    t3 = time.perf_counter()
    device = check_device(spec.chips)
    torch.cuda.init()
    t4 = time.perf_counter()
    pre = {"start": t1 - T0, "torch import": t2 - t1,
           "program import": t3 - t2, "card": t4 - t3}
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                      pre=pre)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    nums = {n: c["value"] for n, c in result["compared"].items()}
    for line in check.lines(nums, spec.limits):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
