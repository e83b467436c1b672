"""The served network's input plane, plainly: an in-memory RGB frame
letterboxed (scaled to fit, centred, zero borders) with bilinear
sampling."""

from __future__ import annotations

import numpy as np


def letterbox_frame(frame: np.ndarray, hin: int, win: int
                    ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """(image, scale, (pad_x, pad_y)) of an (h, w) frame: a network pixel
    p is the frame's (p - pad) / scale."""
    import cv2

    h, w = frame.shape[:2]
    scale = min(win / w, hin / h)
    pad_x, pad_y = win / 2 - scale * w / 2, hin / 2 - scale * h / 2
    m = np.array([[scale, 0.0, pad_x], [0.0, scale, pad_y]])
    img = cv2.warpAffine(frame, m, (win, hin), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return img, scale, (pad_x, pad_y)
