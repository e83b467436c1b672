"""COCO keypoint annotation loading — no pycocotools dependency.

Copy of `openpose_plus_tpu/data/coco.py`: the sample record with its loss
mask (`PoseSample.ignore_mask`), the COCO-17 -> OpenPose-18 conversion, the
COCO mask formats (polygon, uncompressed and compressed RLE; pycocotools is
not needed), the dataset (same filtering, ordering and eval ignore boxes)
and `pad_keypoints`. `cv2` (polygon masks) is imported inside the call.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator

import numpy as np

from openpose_plus_tpu_torch import skeleton


@dataclasses.dataclass
class PoseSample:
    image_id: int
    image_path: str
    width: int
    height: int
    # (P, 18, 3) float32 (x, y, valid) in original image pixels
    keypoints: np.ndarray
    # raw COCO keypoints (P, 17, 3) for OKS evaluation
    keypoints_coco: np.ndarray
    # annotation areas (P,) for OKS
    areas: np.ndarray
    # segmentation payloads of regions to EXCLUDE from the loss
    ignore_segms: list[Any]
    # (Q, 4) x,y,w,h boxes of crowd/unlabeled person annotations — eval
    # ignore regions (COCOeval gtIg)
    ignore_boxes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4), np.float32))

    def ignore_mask(self) -> np.ndarray:
        """uint8 (height, width): 1 where the loss applies, 0 on ignore
        regions."""
        mask = np.ones((self.height, self.width), np.uint8)
        for segm in self.ignore_segms:
            m = decode_segmentation(segm, self.height, self.width)
            mask[m > 0] = 0
        return mask


def coco17_to_openpose18(kp17: np.ndarray) -> np.ndarray:
    """(17, 3) COCO keypoints -> (18, 3) OpenPose parts.

    Neck = midpoint of the shoulders, valid only when both shoulders are.
    COCO visibility v>0 counts as valid.
    """
    out = np.zeros((skeleton.N_PARTS, 3), np.float32)
    for part, cidx in enumerate(skeleton.OPENPOSE_FROM_COCO):
        if cidx >= 0:
            x, y, v = kp17[cidx]
            out[part] = (x, y, 1.0 if v > 0 else 0.0)
    ls, rs = kp17[5], kp17[6]
    if ls[2] > 0 and rs[2] > 0:
        out[skeleton.CocoPart.Neck] = ((ls[0] + rs[0]) / 2,
                                       (ls[1] + rs[1]) / 2, 1.0)
    return out


# ----------------------------------------------------------- mask decode --

def _decode_rle_counts(counts: list[int], h: int, w: int) -> np.ndarray:
    """COCO uncompressed RLE: column-major runs, starting with zeros."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape((w, h)).T  # column-major -> (h, w)


def _decode_compressed_rle(s: str | bytes, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string (LEB128-like, 5 bits a character, sign
    folding, and every count from the 3rd on delta-coded against the count
    two before it)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return _decode_rle_counts(counts, h, w)


def decode_segmentation(segm: Any, h: int, w: int) -> np.ndarray:
    """Polygon list / RLE dict -> uint8 (h, w) binary mask."""
    if isinstance(segm, dict):
        counts = segm["counts"]
        sh, sw = segm["size"]
        if isinstance(counts, list):
            return _decode_rle_counts(counts, sh, sw)
        return _decode_compressed_rle(counts, sh, sw)
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required for polygon masks") from None
    mask = np.zeros((h, w), np.uint8)
    for poly in segm:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


# ---------------------------------------------------------------- dataset --

class CocoPoseDataset:
    """Images containing at least one keypoint-annotated person, sorted by
    image id. `from_annotations` takes the parsed JSON dict (the synthetic
    bank's annotation-only form) instead of a file."""

    def __init__(self, annotation_path: str, image_dir: str,
                 min_keypoints: int = 1, max_people: int = 32):
        with open(annotation_path) as f:
            raw = json.load(f)
        self._parse(raw, image_dir, min_keypoints, max_people)

    @classmethod
    def from_annotations(cls, raw: dict, image_dir: str,
                         min_keypoints: int = 1,
                         max_people: int = 32) -> "CocoPoseDataset":
        self = cls.__new__(cls)
        self._parse(raw, image_dir, min_keypoints, max_people)
        return self

    def _parse(self, raw: dict, image_dir: str, min_keypoints: int,
               max_people: int) -> None:
        self.image_dir = image_dir
        self.max_people = max_people
        images = {im["id"]: im for im in raw["images"]}
        by_image: dict[int, list[dict]] = {}
        for ann in raw["annotations"]:
            if ann.get("category_id", 1) != 1:
                continue
            by_image.setdefault(ann["image_id"], []).append(ann)

        self.samples: list[PoseSample] = []
        for img_id in sorted(by_image):
            anns = by_image[img_id]
            im = images[img_id]
            people, coco_kps, areas, ignores = [], [], [], []
            ign_boxes: list[np.ndarray] = []
            for ann in anns:
                kp = np.asarray(ann.get("keypoints", []),
                                np.float32).reshape(-1, 3)
                n_kp = int((kp[:, 2] > 0).sum()) if kp.size else 0
                if ann.get("iscrowd", 0) or n_kp < min_keypoints:
                    if ann.get("segmentation"):
                        ignores.append(ann["segmentation"])
                    if ann.get("bbox"):
                        ign_boxes.append(np.asarray(ann["bbox"], np.float32))
                    continue
                people.append(coco17_to_openpose18(kp))
                coco_kps.append(kp)
                areas.append(float(ann.get("area", 0.0)))
            if not people:
                continue
            people = people[: self.max_people]
            coco_kps = coco_kps[: self.max_people]
            areas = areas[: self.max_people]
            self.samples.append(PoseSample(
                image_id=img_id,
                image_path=os.path.join(self.image_dir, im["file_name"]),
                width=im["width"], height=im["height"],
                keypoints=np.stack(people),
                keypoints_coco=np.stack(coco_kps),
                areas=np.asarray(areas, np.float32),
                ignore_segms=ignores,
                ignore_boxes=(np.stack(ign_boxes) if ign_boxes
                              else np.zeros((0, 4), np.float32)),
            ))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> PoseSample:
        return self.samples[i]

    def __iter__(self) -> Iterator[PoseSample]:
        return iter(self.samples)


def pad_keypoints(kps: np.ndarray, max_people: int) -> np.ndarray:
    """(P, 18, 3) -> (max_people, 18, 3), zero-padded/truncated."""
    out = np.zeros((max_people, skeleton.N_PARTS, 3), np.float32)
    p = min(len(kps), max_people)
    out[:p] = kps[:p]
    return out
