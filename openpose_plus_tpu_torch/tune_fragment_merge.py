"""Fragment-merge threshold sweep on the TRAIN bank's GT-map oracle.

Counterpart of `scripts/tune_fragment_merge.py`. The repair pass
(`postproc.decode.merge_fragments`) has one free parameter,
`fragment_merge_rel`: the largest part-to-part gap, as a fraction of the
larger fragment's bbox diagonal, across which two skeletons merge. The
value is chosen here, on the TRAIN bank's oracle decode (GT maps -> the
fidelity decoder at `fidelity(upsample=8)`), and frozen before any val
measurement (`ap_oracle.FRAGMENT_MERGE_REL`, 0.5). The maps are rendered
once on the device and decoded once a value (`ap_oracle.oracle_maps`,
`decode_detections`).

    python -m openpose_plus_tpu_torch.tune_fragment_merge --geometry serving
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from openpose_plus_tpu_torch import ap_oracle
from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.eval_coco import (EvalResult,
                                               evaluate_detections_full)

RELS = (0.0, 0.3, 0.4, 0.5, 0.6, 0.8)


def sweep(geometry: str = "serving", rels: tuple[float, ...] = RELS,
          bank: str = "train", device: str | torch.device = "cuda"
          ) -> dict[float, EvalResult]:
    """{rel: EvalResult} of the fidelity decoder with the pass at each rel
    (0 turns it off) on the tier's `bank` oracle; prints
    scripts/tune_fragment_merge.py's lines."""
    b = ap_oracle.oracle_bank(geometry, split=bank)
    out = {}
    with torch.inference_mode():
        maps = ap_oracle.oracle_maps(b, device)
        print(f"bank={bank} tier={geometry} "
              f"({len(b.samples)} scenes, fidelity decoder):")
        for rel in rels:
            pcfg = PostprocConfig().fidelity(upsample=ap_oracle.STRIDE)
            if rel > 0:
                pcfg = dataclasses.replace(pcfg, fragment_merge_rel=rel)
            t0 = time.perf_counter()
            r = evaluate_detections_full(
                ap_oracle.decode_detections(b, maps, pcfg), b.gt_by_image)
            print(f"  rel={rel:g}: AP {r.ap:.4f} AP50 {r.ap50:.4f} "
                  f"AR {r.ar:.4f} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
            out[rel] = r
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometry", choices=tuple(ap_oracle.GEOMETRIES),
                    default="serving")
    ap.add_argument("--rels", type=str, default=",".join(f"{r:g}"
                                                         for r in RELS),
                    help="comma-separated fragment_merge_rel values "
                         "(0 = pass disabled)")
    ap.add_argument("--bank", choices=("train", "val"), default="train",
                    help="train is the tuning protocol; val only for "
                         "post-hoc sensitivity reporting")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sweep(args.geometry, tuple(float(r) for r in args.rels.split(",")),
          args.bank, args.device)


if __name__ == "__main__":
    main()
