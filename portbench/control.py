"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.control --workload <cell> --seeds 1 2 ... [--seconds 3] [--control-seeds 7 8 9]
        [--fault half_batch --fault-seeds 7 8 9]

For each seed, set-up and the check of a run of the cell (``cell.run``),
with a window of ``--seconds`` for the program's runs (default 0: none) and
none for the others: the program's numbers on ``--seeds``, the
numbers of the cell's control (``limits/<cell>.json``'s ``control``: the
program in the next lower precision) on ``--control-seeds``, and of a fault
of ``faults.py`` on ``--fault-seeds``.  One JSON line a run, then for each
number the largest sound reading and the smallest control and fault
readings.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import contextlib

    from portbench import cell as cell_lib
    from portbench import faults, spec

    cell = spec.load(args.workload)
    runs = [("program", None, s) for s in args.seeds]
    runs += [(f"control:{cell.limits['control']}", None, s) for s in args.control_seeds]
    runs += [(f"fault:{f}", f, s) for f in args.fault for s in args.fault_seeds]
    readings = {}
    for label, fault, seed in runs:
        control = cell.limits["control"] if label.startswith("control") else None
        t0 = time.perf_counter()
        with faults.plant(fault) if fault else contextlib.nullcontext():
            out = cell_lib.run(cell, seed, args.seconds if label == "program" else 0, False, device=args.device,
                               control=control, keep_numbers=True)
        numbers = out["numbers"]
        print(json.dumps({"workload": cell.name, "run": label, "seed": seed, "correct": out["correct"],
                          "numbers": numbers, "window_steps": len(out["step_s"]),
                          "seconds": time.perf_counter() - t0}), flush=True)
        for name, value in numbers.items():
            readings.setdefault((label, name), []).append(value)
    summary = {f"{label} {name}": (max(v) if label == "program" else min(v)) for (label, name), v in readings.items()}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
