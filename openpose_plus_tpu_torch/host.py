"""The engine's uint8 input layouts and their host-side space-to-depth
packers.

The packers are the numpy paths of `openpose_plus_tpu/native.py` (`s2d_u8`,
`s2d2_u8`, `d2s_u8`), copied so that the port imports nothing of the JAX
package (tests/test_torch_export.py pins them equal); byte for byte the
layout `models.common.space_to_depth` produces on the device. The native C++
loader they sit beside in the reference is ROADMAP.md item 11.
"""

from __future__ import annotations

import numpy as np

# the engine's input layouts, by space-to-depth level
INPUT_LAYOUTS = ("plain", "s2d", "s2d2")


def s2d_u8(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H/2, W/2, 12) space-to-depth layout (channel =
    (wy*2+wx)*3 + c)."""
    h, w, _ = image.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs even dims, got {h}x{w}")
    x = image.reshape(h // 2, 2, w // 2, 2, 3)
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3, 4)).reshape(
        h // 2, w // 2, 12)


def _once(a: np.ndarray) -> np.ndarray:
    """One space-to-depth level of any channel count."""
    hh, ww, c = a.shape
    a = a.reshape(hh // 2, 2, ww // 2, 2, c).transpose(0, 2, 1, 3, 4)
    return a.reshape(hh // 2, ww // 2, 4 * c)


def s2d2_u8(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H/4, W/4, 48): space-to-depth applied twice."""
    h, w, _ = image.shape
    if h % 4 or w % 4:
        raise ValueError(
            f"space-to-depth squared needs dims % 4 == 0, got {h}x{w}")
    return np.ascontiguousarray(_once(_once(image)))


def d2s_u8(image: np.ndarray) -> np.ndarray:
    """Inverse of s2d_u8 / s2d2_u8 by channel count (3: identity, 12: one
    level, 48: two levels) -> plain (H, W, 3)."""
    def once(a):
        hh, ww, c4 = a.shape
        a = a.reshape(hh, ww, 2, 2, c4 // 4).transpose(0, 2, 1, 3, 4)
        return a.reshape(2 * hh, 2 * ww, c4 // 4)

    if image.shape[-1] == 48:
        image = once(image)
    if image.shape[-1] == 12:
        image = once(image)
    if image.shape[-1] != 3:
        raise ValueError(f"unexpected channel count {image.shape}")
    return np.ascontiguousarray(image)


def pack(image: np.ndarray, level: int) -> np.ndarray:
    """A plain (H, W, 3) image in the space-to-depth layout of `level`
    (0 plain, 1 s2d, 2 s2d^2)."""
    if level == 2:
        return s2d2_u8(image)
    return s2d_u8(image) if level == 1 else image
