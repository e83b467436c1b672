"""The GT-map oracle: the quality axis's ceiling, on the port.

Counterpart of `scripts/ap_benchmark.py::run_oracle`: ground-truth conf and
PAF maps of the seeded val bank, rendered by `data.targets.make_targets` on
the device at the tier's label geometry, decoded by the port's decoder
(`postproc.build_decoder`, with the hand-written kernels on a GPU) and
scored by `eval_coco.evaluate_detections_full`. Variants:

  perfect      GT keypoints straight into the evaluator (protocol sanity,
               AP 1.0)
  base         GT maps -> the default decoder
  fidelity     GT maps -> PostprocConfig.fidelity(upsample=stride)
  fidelity_fm  fidelity with the fragment-merge pass (rel 0.5)

The bank comes from `data.synthetic.scene_bank_annotations`, so the oracle
needs neither cv2 nor image files, and it writes no file. The trained-model
rows of ap_benchmark.py are `ap_bench`.

    from openpose_plus_tpu_torch.ap_oracle import run_oracle
    results = run_oracle("serving", device="cuda")   # {variant: EvalResult}
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.data.coco import CocoPoseDataset, PoseSample
from openpose_plus_tpu_torch.data.synthetic import scene_bank_annotations
from openpose_plus_tpu_torch.data.targets import make_targets
from openpose_plus_tpu_torch.eval_coco import (
    Detection, EvalResult, evaluate_detections_full, host_humans,
    humans_to_detections)
from openpose_plus_tpu_torch.postproc import build_decoder

# The geometry tiers of scripts/ap_benchmark.py GEOMETRIES (the fields the
# oracle reads): bank image size, network input, GT label widths (sigma,
# limb) in input pixels, val images.
GEOMETRIES = {
    "small": dict(size=256, hin=128, win=128, sigma=5.0, limb=5.0, n_val=96),
    "serving": dict(size=736, hin=368, win=432, sigma=8.0, limb=8.0,
                    n_val=96),
}
VARIANTS = ("perfect", "base", "fidelity", "fidelity_fm")
STRIDE = 8
BATCH = 8


@dataclasses.dataclass
class OracleBank:
    """The val bank of one geometry tier, ready to render and score."""

    geo: dict
    samples: list[PoseSample]
    metas: list[tuple[int, float, tuple[float, float]]]  # id, scale, pad
    gt_by_image: dict
    max_people: int


def oracle_bank(geometry: str = "small",
                limit: Optional[int] = None) -> OracleBank:
    """The tier's val bank (its first `limit` images) with the letterbox
    transform of each image (from the annotated dims; no pixel decode)."""
    geo = GEOMETRIES[geometry]
    val = CocoPoseDataset.from_annotations(
        scene_bank_annotations("val", geo["n_val"], geo["size"]), "")
    samples = [val[i] for i in range(len(val))][:limit]
    hin, win = geo["hin"], geo["win"]
    metas = []
    for s in samples:
        scale = min(win / s.width, hin / s.height)
        pad = (win / 2 - scale * s.width / 2, hin / 2 - scale * s.height / 2)
        metas.append((s.image_id, scale, pad))
    return OracleBank(
        geo, samples, metas,
        {s.image_id: (s.keypoints_coco, s.areas, s.ignore_boxes)
         for s in samples},
        max(s.keypoints.shape[0] for s in samples))


def variant_config(variant: str) -> PostprocConfig:
    """The decoder config of a map variant."""
    pcfg = PostprocConfig()
    if variant != "base":
        pcfg = pcfg.fidelity(upsample=STRIDE)
    if variant == "fidelity_fm":
        pcfg = dataclasses.replace(pcfg, fragment_merge_rel=0.5)
    return pcfg


def input_keypoints(bank: OracleBank, first: int) -> np.ndarray:
    """(BATCH, P, 18, 3) input-space keypoints of images first.. (zero
    rows pad the last batch)."""
    kps = np.zeros((BATCH, bank.max_people, 18, 3), np.float32)
    for j, s in enumerate(bank.samples[first:first + BATCH]):
        _, scale, pad = bank.metas[first + j]
        k = s.keypoints
        kps[j, : k.shape[0], :, 0] = k[:, :, 0] * scale + pad[0]
        kps[j, : k.shape[0], :, 1] = k[:, :, 1] * scale + pad[1]
        kps[j, : k.shape[0], :, 2] = k[:, :, 2]
    return kps


def oracle_detections(bank: OracleBank, variant: str,
                      device: str | torch.device) -> list[Detection]:
    """One variant's detections over the bank: for a map variant, GT maps
    rendered on `device` and decoded there, BATCH images at a time."""
    if variant == "perfect":
        dets = []
        for s in bank.samples:
            for g in s.keypoints_coco:
                kp = np.asarray(g, np.float32).copy()
                kp[:, 2] = np.where(kp[:, 2] > 0, 1.0, 0.0)
                dets.append(Detection(image_id=s.image_id, keypoints=kp,
                                      score=1.0))
        return dets
    geo = bank.geo
    hin, win = geo["hin"], geo["win"]
    decoder = build_decoder(variant_config(variant))
    dets = []
    for i in range(0, len(bank.samples), BATCH):
        kps = torch.from_numpy(input_keypoints(bank, i)).to(device)
        conf, paf = make_targets(kps, hin // STRIDE, win // STRIDE, STRIDE,
                                 geo["sigma"], geo["limb"])
        humans = host_humans(decoder(conf, paf))
        for j in range(min(BATCH, len(bank.samples) - i)):
            img_id, scale, pad = bank.metas[i + j]
            dets.extend(humans_to_detections(humans, j, img_id, scale, pad,
                                             hin, win))
    return dets


def run_oracle(geometry: str = "small", variants: tuple[str, ...] = VARIANTS,
               device: str | torch.device = "cuda",
               limit: Optional[int] = None) -> dict[str, EvalResult]:
    """{variant: EvalResult} of the GT-map oracle on the tier's val bank
    (the first `limit` images), rendered and decoded on `device`."""
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown oracle variants {sorted(unknown)}; "
                         f"have {VARIANTS}")
    bank = oracle_bank(geometry, limit)
    with torch.inference_mode():
        return {v: evaluate_detections_full(
            oracle_detections(bank, v, device), bank.gt_by_image)
            for v in variants}
