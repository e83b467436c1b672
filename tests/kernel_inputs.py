"""Random inputs for the decoder's two serial kernels (greedy assignment and
subset merge), numpy only.

Shared by the port's CPU tests, its `cuda`-marked tests and chip_smoke.py,
which loads this file by path.
"""

from __future__ import annotations

import numpy as np

N_LIMBS = 19
N_PARTS = 18


def limb_scores(rng: np.random.Generator, b: int, k: int,
                density: float = 0.3, ties: bool = True) -> np.ndarray:
    """(b, 19, k, k) float32 candidate scores, -inf where no candidate.

    With `ties`, the cases the tie order decides (lowest row-major index
    wins): an empty limb, a limb whose candidates all tie, exact ties
    between two corners and between two cells of one row."""
    s = rng.uniform(0.01, 1.0, (b, N_LIMBS, k, k)).astype(np.float32)
    s = np.where(rng.random(s.shape) < density, s, -np.inf)
    if ties:
        s[:, 1] = -np.inf
        s[:, 2] = np.where(np.isfinite(s[:, 2]), 0.5, -np.inf)
        s[:, 3, -1, -1] = s[:, 3, 0, 0] = 2.0
        s[:, 4, k // 2, -1] = s[:, 4, k // 2, 0] = 0.7
    return s.astype(np.float32)


def connections(rng: np.random.Generator, b: int, k: int
                ) -> tuple[np.ndarray, ...]:
    """Connection sets shaped like greedy output, (b, 19, k) each: distinct
    slots per limb and a valid prefix of random length. Returns slot_a,
    slot_b (int32), score (float32, 0 where invalid), valid (bool)."""
    slots = np.tile(np.arange(k, dtype=np.int32), (b, N_LIMBS, 1))
    slot_a = rng.permuted(slots, axis=-1)
    slot_b = rng.permuted(slots, axis=-1)
    valid = np.arange(k) < rng.integers(0, k + 1, (b, N_LIMBS, 1))
    score = (rng.uniform(0.1, 1.0, (b, N_LIMBS, k)) * valid).astype(
        np.float32)
    return slot_a, slot_b, score, valid


def peak_scores(rng: np.random.Generator, b: int, k: int) -> np.ndarray:
    """(b, 18, k) float32 peak scores."""
    return rng.uniform(0.1, 1.0, (b, N_PARTS, k)).astype(np.float32)
