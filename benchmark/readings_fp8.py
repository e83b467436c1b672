"""The reading that sets the upper side of a cell's limits: the plain
reference computed one precision below the configuration's bf16, with what
the network stores rounded to float8 e4m3 (3 mantissa bits, saturating at
+-448) in place of bf16, its people decoded by the network's decode family
(`decode`) and judged as a served answer would be, against the float32
reference, on the cell's own sample of the seed's inputs. No program runs:
the reading is the reference's alone.

    python3 benchmark/readings_fp8.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the seed, "fp8_reference", every number
`check.numbers` computes, and whether the cell's limits judge it correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FP8_MAX = 448.0


def fp8(t):
    """float8 e4m3 storage of a float32 tensor, saturating."""
    import torch

    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()


def answer(people: tuple, m: int) -> dict:
    """One image's people (coords, scores, part scores, part counts, as a
    family's `decode` gives them) as a served answer: rows by descending
    score, valid first, coordinates normalized."""
    xy, score, part_scores, counts = people
    n_parts = xy.shape[1]
    rows = np.argsort(-score, kind="stable")[:m]
    out = {"coords": np.zeros((m, n_parts, 2), np.float32),
           "part_scores": np.zeros((m, n_parts), np.float32),
           "part_valid": np.zeros((m, n_parts), bool),
           "score": np.zeros(m, np.float32),
           "n_parts": np.zeros(m, np.int32), "valid": np.zeros(m, bool)}
    for r, j in enumerate(rows):
        present = ~np.isnan(xy[j, :, 0])
        out["coords"][r, present] = xy[j, present]
        out["part_scores"][r, present] = part_scores[j, present]
        out["part_valid"][r] = present
        out["score"][r] = score[j]
        out["n_parts"][r] = counts[j]
        out["valid"][r] = True
    return out


def reading(cell, seed: int, device) -> dict:
    import torch

    from harness import check, runner, scenes, weights
    from reference import models

    m, t = cell.config["model"], cell.traffic
    w, pp = cell.config["weights"], runner.postproc(cell)
    from openpose_plus_tpu_torch.models import get_model

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in get_model(
            runner.program_config(cell).model).state_dict().items()}
    sd = weights.make(shapes, seed, device, w["bias_std"], m)
    host = np.stack(scenes.render_many(seed, t["batches"] * t["batch"],
                                       m["hin"], m["win"], t["people"]))
    weights.scale_heads(sd, m, torch.from_numpy(host[:1]).to(device), w)
    pick = np.sort(np.random.default_rng(seed).choice(
        t["batches"], size=min(t["check_batches"], t["batches"]),
        replace=False))
    planes = host.reshape(t["batches"], t["batch"], *host.shape[1:])[
        pick].reshape(-1, *host.shape[1:])
    ref = check.reference(cell.config, sd, planes, pp, device)
    answers = []
    for i in range(0, len(planes), 8):
        x = torch.from_numpy(planes[i:i + 8]).to(device)
        people, _ = ref.family.decode(models.forward(m, sd, x, r=fp8), pp,
                                      ref.skeleton, ref.extent)
        answers += [answer(p, pp["max_humans"]) for p in people]
    values = check.numbers(answers, ref, pp, 0, 0)
    correct, _ = check.judge(values, cell.limits)
    return {"workload": cell.name, "seed": seed, "side": "fp8_reference",
            "correct": bool(correct), "numbers": values}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        print(json.dumps(reading(cell, seed, torch.device(args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
