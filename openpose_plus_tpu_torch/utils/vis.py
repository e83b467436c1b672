"""Debug renders (`openpose_plus_tpu/utils/vis.py::draw_maps_overlay`):
the training loop's predicted-vs-GT heatmap dumps. `cv2` is imported inside
the call."""

from __future__ import annotations

import numpy as np

from openpose_plus_tpu_torch import skeleton


def draw_maps_overlay(image: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """Heatmap max-projection (parts only) blended over a BGR uint8
    image."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 unavailable") from None
    h, w = image.shape[:2]
    m = np.asarray(conf)[..., : skeleton.N_PARTS].max(-1)
    m = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
    m8 = np.clip(m * 255, 0, 255).astype(np.uint8)
    heat = cv2.applyColorMap(m8, cv2.COLORMAP_JET)
    return cv2.addWeighted(image, 0.6, heat, 0.4, 0)
