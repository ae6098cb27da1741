"""The benchmark's one command: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is the result, one JSON object;
the numbers the check compared, each beside its limit, are the last lines
of standard error.  The run exits with a code other than 0, and prints no
result, when there is no such card, when the program is missing, or when the
JAX package or JAX was loaded.  ``--trace 1`` reports the per-layer metrics
of ``BENCHMARK.json``, ``--trace 0`` the end-to-end ones.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Modules that no run may load: the JAX package and JAX (whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "kb2e_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import cell as cell_lib
    from portbench import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 3
    out = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    parts = out.pop("setup_parts")
    print("portbench: set-up (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)
    print("portbench: steps of the window (s): " + " ".join(f"{x:.4f}" for x in out.pop("step_s")), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
