"""The readings that the limits of `correct` are set from, in one process:
the program on many seeds (the lower reading is their largest), the
control, the program's own int8 path, on a few (the upper reading is their
smallest), and each program run's answers again with a fault planted in
them (one person of each image left out; the legs of each image's first
two people exchanged). Each run is a whole run of the cell with a short
window.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2]

prints one JSON line a reading: the seed, "program", "control" or the
fault's name, and every number `check.numbers` computes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONTROL_DTYPE = "int8"


def person_dropped(ans: dict) -> dict:
    """The first person left out, the rows after it moved up."""
    return {f: np.concatenate([v[1:], np.zeros_like(v[:1])])
            for f, v in ans.items()}


def parts_swapped(ans: dict) -> dict:
    """The legs (parts 8-13) of the first two people exchanged."""
    out = {f: v.copy() for f, v in ans.items()}
    for f in ("coords", "part_scores", "part_valid"):
        out[f][[0, 1], 8:14] = ans[f][[1, 0], 8:14]
    return out


FAULTS = {"person_dropped": person_dropped, "parts_swapped": parts_swapped}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from harness import check, runner, spec

    cell = spec.load_cell(ROOT, args.workload)
    plan = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), CONTROL_DTYPE) for s in args.control_seeds.split(",") if s]
    for seed, dtype in plan:
        out = runner.run(cell, seed, args.seconds, False, time.perf_counter(),
                         compute_dtype=dtype)
        readings = [("control" if dtype else "program", out["_values"])]
        if dtype is None:
            answers, ref, pp, repeats, layout = out["_sample"]
            readings += [(name, check.numbers([fault(a) for a in answers],
                                              ref, pp, repeats, layout))
                         for name, fault in FAULTS.items()]
        for side, values in readings:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "numbers": values,
                              "phases": out["_phases"],
                              "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
