"""The benchmark of openpose_plus_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the NVIDIA card(s) the
cell asks for. It makes the cell's inputs and weights from the seed, sets
up and warms every shape the cell uses (`setup_s`), serves the cell's
traffic in a closed loop for `--seconds`, and prints one JSON line last:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and `compared` (each number that decides `correct`, with its
limit), which the last lines of standard error repeat. Without a CUDA card,
or with fewer than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "openpose_plus_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Module names (default: the loaded ones) whose top-level name, taken
    whole, is the JAX stack or the JAX package (the port's name merely
    begins with it)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path[:0] = [HERE, ROOT]
    from harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    import openpose_plus_tpu_torch  # noqa: F401  the program under test
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} NVIDIA H100 card(s); "
              f"CUDA available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness import runner

    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX stack or package loaded: {bad}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """The run's numbers on standard error, each compared number beside
    its limit last there, and the result line last on standard output."""
    out = dict(out)
    values, rows = out.pop("_values"), out.pop("_rows")
    out.pop("_sample")
    print("phases " + json.dumps(out.pop("_phases")), file=sys.stderr)
    print("numbers " + json.dumps(values), file=sys.stderr)
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
