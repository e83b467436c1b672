"""Per-miss anatomy of the GT-map oracle's ceiling.

Counterpart of `scripts/analyze_oracle_misses.py`: decodes the ground-truth
conf and PAF maps of a tier's val bank through the fidelity decoder (as
`ap_bench --oracle` does), then audits every GT person the decoder failed
to match (best OKS below `oks_miss`):

  * what fraction of the person's labeled keypoints SOME detection
    recovered (per-keypoint OKS term > 0.5: localized, not assembled);
  * across how many detections those keypoints are scattered (>= 2: the
    person was fragmented, not undetected);
  * whether the person's labeled parts form a disconnected subgraph of
    the limb tree (`skeleton.COCO_PAIRS`), where no limb candidate spans
    the components and no bottom-up PAF decoder can assemble them.

    python -m openpose_plus_tpu_torch.analyze_oracle_misses --geometry serving
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from openpose_plus_tpu_torch import ap_oracle, skeleton
from openpose_plus_tpu_torch.eval_coco import compute_oks


def _components(vis: np.ndarray) -> int:
    """Connected components of the visible parts in the limb tree."""
    parent = list(range(skeleton.N_PARTS))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in skeleton.COCO_PAIRS:
        if vis[a] and vis[b]:
            parent[find(a)] = find(b)
    return len({find(p) for p in range(skeleton.N_PARTS) if vis[p]})


def audit(geometry: str = "serving", oks_miss: float = 0.5,
          frag_merge: bool = False, device: str | torch.device = "cuda",
          limit: Optional[int] = None) -> dict:
    """The audit's counts over the tier's val bank (its first `limit`
    images); prints scripts/analyze_oracle_misses.py's lines. Keys:
    gt_people, misses, and over the misses mean_recovery (a fraction),
    scattered (>= 2 detections), mean_fragments, disconnected and
    mean_components (None without misses)."""
    bank = ap_oracle.oracle_bank(geometry, limit)
    pcfg = ap_oracle.variant_config("fidelity_fm" if frag_merge
                                    else "fidelity")
    with torch.inference_mode():
        dets = ap_oracle.decode_detections(
            bank, ap_oracle.oracle_maps(bank, device), pcfg)
    dets_by_image = {s.image_id: [] for s in bank.samples}
    for d in dets:
        dets_by_image[d.image_id].append(d)

    sig = skeleton.COCO_OKS_SIGMAS
    n_gt = n_miss = 0
    recov_fracs, frag_counts, comp_counts = [], [], []
    for s in bank.samples:
        dets = dets_by_image[s.image_id]
        for g, area, kp18 in zip(s.keypoints_coco, s.areas, s.keypoints):
            g = np.asarray(g, np.float32)
            labeled = g[:, 2] > 0
            if not labeled.any():
                continue
            n_gt += 1
            best = max((compute_oks(d.keypoints, g, area) for d in dets),
                       default=0.0)
            if best >= oks_miss:
                continue
            n_miss += 1
            # per-keypoint recovery across every detection
            s2 = max(float(area), 1.0)
            rec_by_det = []
            for d in dets:
                d2 = ((d.keypoints[:, 0] - g[:, 0]) ** 2
                      + (d.keypoints[:, 1] - g[:, 1]) ** 2)
                term = np.exp(-d2 / (2.0 * s2 * (2.0 * sig) ** 2))
                rec_by_det.append(labeled & (d.keypoints[:, 2] > 0)
                                  & (term > 0.5))
            rec_any = (np.any(rec_by_det, axis=0) if rec_by_det
                       else np.zeros(17, bool))
            recov_fracs.append(rec_any.sum() / labeled.sum())
            frag_counts.append(sum(1 for r in rec_by_det if r.any()))
            comp_counts.append(_components(kp18[:, 2] > 0))

    fc = np.asarray(frag_counts)
    counts = {"gt_people": n_gt, "misses": n_miss,
              "mean_recovery": None, "scattered": int((fc >= 2).sum()),
              "mean_fragments": None,
              "disconnected": sum(c > 1 for c in comp_counts),
              "mean_components": None}
    fm = " (fragment-merge ON)" if frag_merge else ""
    print(f"tier={geometry}{fm}: {n_gt} GT people, "
          f"{n_miss} missed at OKS<{oks_miss}")
    if n_miss:
        counts.update(mean_recovery=float(np.mean(recov_fracs)),
                      mean_fragments=float(fc.mean()),
                      mean_components=float(np.mean(comp_counts)))
        print(f"  mean keypoint recovery among misses: "
              f"{100 * counts['mean_recovery']:.0f}%")
        print(f"  scattered across >=2 detections: {counts['scattered']} "
              f"of {n_miss} (mean fragments {fc.mean():.2f})")
        print(f"  GT labeled-part set DISCONNECTED in the limb tree: "
              f"{counts['disconnected']} of {n_miss} "
              f"(mean components {np.mean(comp_counts):.2f})")
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometry", choices=tuple(ap_oracle.GEOMETRIES),
                    default="serving")
    ap.add_argument("--oks-miss", type=float, default=0.5,
                    help="a GT person is a miss when its best det OKS "
                         "is below this")
    ap.add_argument("--frag-merge", action="store_true",
                    help="analyze with the fragment-merge repair pass on "
                         "(fragment_merge_rel=0.5)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    audit(args.geometry, args.oks_miss, args.frag_merge, args.device)


if __name__ == "__main__":
    main()
