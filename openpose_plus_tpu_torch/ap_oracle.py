"""The GT-map oracle: the quality axis's ceiling, on the port.

Counterpart of `scripts/ap_benchmark.py::run_oracle`: ground-truth conf and
PAF maps of a seeded scene bank, rendered by `data.targets.make_targets` on
the device at the tier's label geometry, decoded by the port's decoder
(`postproc.build_decoder`, with the hand-written kernels on a GPU) and
scored by `eval_coco.evaluate_detections_full`. Variants:

  perfect      GT keypoints straight into the evaluator (protocol sanity,
               AP 1.0)
  base         GT maps -> the default decoder
  fidelity     GT maps -> PostprocConfig.fidelity(upsample=out_stride)
  fidelity_fm  fidelity with the fragment-merge pass (rel 0.5)

The attribution probes re-render the maps: `out_stride=4` (4x the map
pixels, the fidelity decoder's upsample matching the stride; "#s4") and
`label_sigma` (the GT Gaussian's width in input pixels; "#sig<X>"), keyed
by `oracle_key`. `split="train"` reads the train bank, on which
`tune_fragment_merge` chose the fragment-merge threshold.

The bank comes from `data.synthetic.scene_bank_annotations`, so the oracle
needs neither cv2 nor image files, and it writes no file. The trained-model
rows and the oracle's results file are `ap_bench`.

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

# scripts/ap_benchmark.py GEOMETRIES: bank image size, network input, GT
# label widths (sigma, limb) in input pixels, bank sizes, the weights' cache
# tag and the result key's suffix.
GEOMETRIES = {
    "small": dict(size=256, hin=128, win=128, sigma=5.0, limb=5.0,
                  n_train=256, n_val=96, tag="", key_suffix=""),
    "serving": dict(size=736, hin=368, win=432, sigma=8.0, limb=8.0,
                    n_train=256, n_val=96, tag="_h368", key_suffix="@368"),
}
VARIANTS = ("perfect", "base", "fidelity", "fidelity_fm")
STRIDE = 8
BATCH = 8
FRAGMENT_MERGE_REL = 0.5       # frozen by tune_fragment_merge's sweep


@dataclasses.dataclass
class OracleBank:
    """A bank of one geometry tier, ready to render and score."""

    geo: dict
    samples: list[PoseSample]
    metas: list[tuple[int, float, tuple[float, float]]]  # id, scale, pad
    gt_by_image: dict
    max_people: int


def oracle_key(geometry: str = "small", out_stride: int = STRIDE,
               label_sigma: Optional[float] = None) -> str:
    """The result key of an oracle run, by scripts/ap_benchmark.py's rule:
    "oracle<tier suffix>", then "#s<stride>" off stride 8 and "#sig<X>"
    where the sigma is overridden."""
    key = "oracle" + GEOMETRIES[geometry]["key_suffix"]
    if out_stride != STRIDE:
        key += f"#s{out_stride}"
    if label_sigma is not None:
        key += f"#sig{label_sigma:g}"
    return key


def oracle_bank(geometry: str = "small", limit: Optional[int] = None,
                split: str = "val") -> OracleBank:
    """The tier's `split` bank (its first `limit` images) with the
    letterbox transform of each image (from the annotated dims; no pixel
    decode)."""
    geo = GEOMETRIES[geometry]
    n = {"train": geo["n_train"], "val": geo["n_val"]}[split]
    bank = CocoPoseDataset.from_annotations(
        scene_bank_annotations(split, n, geo["size"]), "")
    samples = [bank[i] for i in range(len(bank))][:limit]
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


def variant_config(variant: str, out_stride: int = STRIDE) -> PostprocConfig:
    """The decoder config of a map variant at maps of `out_stride`."""
    pcfg = PostprocConfig()
    if variant != "base":
        pcfg = pcfg.fidelity(upsample=out_stride)
    if variant == "fidelity_fm":
        pcfg = dataclasses.replace(pcfg, fragment_merge_rel=FRAGMENT_MERGE_REL)
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


def oracle_maps(bank: OracleBank, device: str | torch.device,
                out_stride: int = STRIDE,
                label_sigma: Optional[float] = None) -> list[tuple]:
    """The bank's GT (conf, paf) maps rendered on `device`, one pair a
    BATCH of images, at `out_stride` and the tier's sigma unless
    `label_sigma` overrides it."""
    geo = bank.geo
    sigma = geo["sigma"] if label_sigma is None else label_sigma
    return [make_targets(torch.from_numpy(input_keypoints(bank, i)).to(
        device), geo["hin"] // out_stride, geo["win"] // out_stride,
        out_stride, sigma, geo["limb"])
        for i in range(0, len(bank.samples), BATCH)]


def decode_detections(bank: OracleBank, maps: list[tuple],
                      pcfg: PostprocConfig) -> list[Detection]:
    """`oracle_maps` decoded with `pcfg` on the maps' device, in original
    image pixels."""
    geo = bank.geo
    decoder = build_decoder(pcfg)
    dets = []
    for i, (conf, paf) in zip(range(0, len(bank.samples), BATCH), maps):
        humans = host_humans(decoder(conf, paf))
        for j in range(min(BATCH, len(bank.samples) - i)):
            img_id, scale, pad = bank.metas[i + j]
            dets.extend(humans_to_detections(humans, j, img_id, scale, pad,
                                             geo["hin"], geo["win"]))
    return dets


def oracle_detections(bank: OracleBank, variant: str,
                      device: str | torch.device, out_stride: int = STRIDE,
                      label_sigma: Optional[float] = None
                      ) -> list[Detection]:
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
    return decode_detections(
        bank, oracle_maps(bank, device, out_stride, label_sigma),
        variant_config(variant, out_stride))


def run_oracle(geometry: str = "small", variants: tuple[str, ...] = VARIANTS,
               device: str | torch.device = "cuda",
               limit: Optional[int] = None, split: str = "val",
               out_stride: int = STRIDE,
               label_sigma: Optional[float] = None) -> dict[str, EvalResult]:
    """{variant: EvalResult} of the GT-map oracle on the tier's `split`
    bank (the first `limit` images), rendered at `out_stride` (and
    `label_sigma`) and decoded on `device`."""
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown oracle variants {sorted(unknown)}; "
                         f"have {VARIANTS}")
    bank = oracle_bank(geometry, limit, split)
    with torch.inference_mode():
        return {v: evaluate_detections_full(
            oracle_detections(bank, v, device, out_stride, label_sigma),
            bank.gt_by_image) for v in variants}
