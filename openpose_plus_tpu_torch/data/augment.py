"""Eval-time letterbox (`openpose_plus_tpu/data/augment.py::letterbox` and
its `_affine_matrix`). The train-time augmentation is ROADMAP.md item
'Training'. `cv2` is imported inside the call."""

from __future__ import annotations

import numpy as np


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


def letterbox(image: np.ndarray, hin: int, win: int
              ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """Eval-time resize+pad to the network input, keypoint-free.

    Returns (image, scale, (pad_x, pad_y)); a network-space point maps back
    to the original as (p - pad) / scale.
    """
    src_h, src_w = image.shape[:2]
    scale = min(win / src_w, hin / src_h)
    m = _affine_matrix(src_w, src_h, win, hin, 0.0, scale, (0.0, 0.0), False)
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required") from None
    img = cv2.warpAffine(image, m, (win, hin), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    pad_x = win / 2 - scale * src_w / 2
    pad_y = hin / 2 - scale * src_h / 2
    return img, scale, (pad_x, pad_y)
