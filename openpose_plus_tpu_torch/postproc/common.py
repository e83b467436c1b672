"""Shared numpy constants of the decoder, copied from the JAX package.

`openpose_plus_tpu.postproc.common` cannot be imported without JAX (its
package `__init__` pulls in the JAX decoder), so the three helpers the port
needs are copied here verbatim. tests/test_torch_weights.py pins each copy
equal to its original.
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Truncated, normalized 1-D Gaussian (radius = ceil(3*sigma))."""
    if sigma <= 0:
        return np.ones((1,), dtype=np.float32)
    radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def line_sample_fracs(n_samples: int) -> np.ndarray:
    """Interpolation fractions t for the PAF line integral: `n` evenly
    spaced points from endpoint A to endpoint B inclusive."""
    return np.linspace(0.0, 1.0, n_samples).astype(np.float32)


def refine_peak_1d(center: np.ndarray, prev: np.ndarray,
                   nxt: np.ndarray) -> np.ndarray:
    """Quadratic subpixel offset in [-0.5, 0.5] from 3 samples along an axis.

    offset = 0.5 * (next - prev) / (2*center - next - prev); zero when the
    parabola is degenerate.
    """
    denom = 2.0 * center - nxt - prev
    off = np.where(np.abs(denom) > 1e-6, 0.5 * (nxt - prev) / denom, 0.0)
    return np.clip(off, -0.5, 0.5)
