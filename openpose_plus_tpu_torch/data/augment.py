"""Keypoint-aware augmentation as one affine warp, and the eval-time
letterbox (`openpose_plus_tpu/data/augment.py`).

Train time: rotate, scale jitter, random crop (a shift of the warped
center) and horizontal flip with the left/right parts swapped, fused into
ONE affine transform a sample, applied to the image, the loss mask and the
keypoints alike. The draws from the numpy Generator come in the
reference's order (scale, angle, shift x, shift y, flip), so one seed gives
the JAX package's sample bit for bit. `cv2` is imported inside the call.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openpose_plus_tpu_torch import skeleton
from openpose_plus_tpu_torch.config import DataConfig


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required for augmentation") from None
    return cv2


@dataclasses.dataclass
class AugmentedSample:
    image: np.ndarray       # (hin, win, 3) uint8
    keypoints: np.ndarray   # (P, 18, 3) in network-input pixels
    mask: np.ndarray        # (hin, win) uint8, 1 = apply loss


def _affine_matrix(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   angle_deg: float, scale: float, shift: tuple[float, float],
                   flip: bool) -> np.ndarray:
    """2x3 src->dst matrix: center, rotate+scale, flip, recenter+shift."""
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta) * scale, np.sin(theta) * scale
    rot = np.array([[c, -s], [s, c]], np.float64)
    if flip:
        rot = np.array([[-1.0, 0.0], [0.0, 1.0]]) @ rot
    src_c = np.array([src_w / 2, src_h / 2])
    dst_c = np.array([dst_w / 2 + shift[0], dst_h / 2 + shift[1]])
    t = dst_c - rot @ src_c
    return np.concatenate([rot, t[:, None]], axis=1)


def _apply_to_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:, :2].T + m[:, 2]


def _warp(sample_image, keypoints, mask, m, dst_w, dst_h, flip):
    cv2 = _cv2()
    img = cv2.warpAffine(sample_image, m, (dst_w, dst_h),
                         flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    # outside-source content contributes no loss
    wmask = cv2.warpAffine(mask, m, (dst_w, dst_h),
                           flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    kp = keypoints.copy()
    kp[..., :2] = _apply_to_points(m, keypoints[..., :2])
    inside = ((kp[..., 0] >= 0) & (kp[..., 0] < dst_w)
              & (kp[..., 1] >= 0) & (kp[..., 1] < dst_h))
    kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
    if flip:
        for a, b in skeleton.FLIP_SWAP_PAIRS:
            kp[:, [a, b]] = kp[:, [b, a]]
    return img, kp, wmask


def augment_sample(image: np.ndarray, keypoints: np.ndarray,
                   mask: np.ndarray, cfg: DataConfig, hin: int, win: int,
                   rng: np.random.Generator) -> AugmentedSample:
    """Random train-time augmentation (one warp)."""
    src_h, src_w = image.shape[:2]
    fit = min(win / src_w, hin / src_h)
    scale = fit * rng.uniform(cfg.scale_min, cfg.scale_max)
    angle = rng.uniform(-cfg.rotate_max_deg, cfg.rotate_max_deg)
    f = cfg.shift_frac
    shift = (rng.uniform(-f, f) * win, rng.uniform(-f, f) * hin)
    flip = bool(rng.uniform() < cfg.flip_prob)
    m = _affine_matrix(src_w, src_h, win, hin, angle, scale, shift, flip)
    img, kp, wmask = _warp(image, keypoints, mask, m, win, hin, flip)
    return AugmentedSample(image=img, keypoints=kp, mask=wmask)


def letterbox(image: np.ndarray, hin: int, win: int
              ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """Eval-time resize+pad to the network input, keypoint-free.

    Returns (image, scale, (pad_x, pad_y)); a network-space point maps back
    to the original as (p - pad) / scale.
    """
    src_h, src_w = image.shape[:2]
    scale = min(win / src_w, hin / src_h)
    m = _affine_matrix(src_w, src_h, win, hin, 0.0, scale, (0.0, 0.0), False)
    cv2 = _cv2()
    img = cv2.warpAffine(image, m, (win, hin), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    pad_x = win / 2 - scale * src_w / 2
    pad_y = hin / 2 - scale * src_h / 2
    return img, scale, (pad_x, pad_y)
