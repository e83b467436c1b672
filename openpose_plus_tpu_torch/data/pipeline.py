"""Host image loading (`openpose_plus_tpu/data/pipeline.py::_load_image`).
The training pipeline (`TrainPipeline`) is ROADMAP.md item 'Training'.
`cv2` is imported inside the call."""

from __future__ import annotations

import numpy as np


def _load_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required to load images") from None
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
