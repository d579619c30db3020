"""Readings that the limits of ``correct`` are set from, on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out <file.jsonl>]

For each seed: the program's compared rounds against the reference's
(the lower reading), on ``--control-seeds`` the reference in the control's
precision (TF32, the step below float32 with TF32 off) against it (the
upper reading), and on ``--fault-seeds`` each fault the cell can have
(``faults.py``) against it.  One JSON line a reading, with where each
number's worst gap lies; no window is run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]

    from portbench import faults, run, session
    from portbench import spec as speclib

    spec = speclib.load(args.workload)
    run.cache_dirs(speclib.ROOT)
    device = run.check_device(spec.chips)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    control, faulted = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        st = session.start(spec, seed, device)
        st.cell.close()
        st.cell = None
        session.free(device)
        t1 = time.perf_counter()
        ref = session.reference(spec, st, device)
        t2 = time.perf_counter()
        detail = {}
        nums = session.compare(spec, st.prog, ref, st.x_init, detail)
        emit({"cell": spec.name, "seed": seed, "kind": "program",
              "numbers": nums, "where": detail,
              "seconds": {"program": t1 - t0, "reference": t2 - t1}})
        if seed in control:
            t3 = time.perf_counter()
            ctl = session.reference(spec, st, device, tf32=True)
            detail = {}
            nums = session.compare(spec, ctl, ref, st.x_init, detail)
            emit({"cell": spec.name, "seed": seed, "kind": "control_tf32",
                  "numbers": nums, "where": detail,
                  "seconds": time.perf_counter() - t3})
        if seed in faulted:
            for name in faults.applicable(spec.traffic):
                t3 = time.perf_counter()
                fst = session.start(spec, seed, device,
                                    fault=faults.FAULTS[name])
                fst.cell.close()
                fst.cell = None
                session.free(device)
                detail = {}
                nums = session.compare(spec, fst.prog, ref, st.x_init, detail)
                emit({"cell": spec.name, "seed": seed, "kind": f"fault_{name}",
                      "numbers": nums, "where": detail,
                      "seconds": time.perf_counter() - t3})
        session.free(device)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
