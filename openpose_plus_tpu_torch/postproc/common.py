"""Shared numpy constants of the decoder, copied from the JAX package.

`openpose_plus_tpu.postproc.common` cannot be imported without JAX (its
package `__init__` pulls in the JAX decoder), so the helpers the port
needs are copied here verbatim (`limb_score_with_prior` for the oracle,
`postproc/oracle.py`). tests/test_torch_weights.py and
tests/test_torch_oracle.py pin each copy equal to its original.
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


def limb_score_with_prior(mean_dot: float | np.ndarray,
                          dist: float | np.ndarray,
                          map_height: int) -> np.ndarray:
    """Candidate-limb ranking score: mean PAF dot + height prior penalty.

    score = mean_dot + min(0.5 * H / dist - 1, 0) — penalizes limbs longer
    than half the map height.
    """
    dist = np.maximum(dist, 1e-4)
    prior = np.minimum(0.5 * map_height / dist - 1.0, 0.0)
    return mean_dot + prior


def refine_peak_1d(center: np.ndarray, prev: np.ndarray,
                   nxt: np.ndarray) -> np.ndarray:
    """Quadratic subpixel offset in [-0.5, 0.5] from 3 samples along an axis.

    offset = 0.5 * (next - prev) / (2*center - next - prev); zero when the
    parabola is degenerate.
    """
    denom = 2.0 * center - nxt - prev
    off = np.where(np.abs(denom) > 1e-6, 0.5 * (nxt - prev) / denom, 0.0)
    return np.clip(off, -0.5, 0.5)
