"""Seeded multi-person scenes: a textured background, a few distractor
strokes, and stick figures of the 18-part OpenPose body at varied scale,
rotation and overlap, drawn with cv2. The same seed gives the same
pixels; every seed gives the same sizes."""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Optional

import numpy as np

THREADS = 8

# an 18-part figure in unit coordinates around the pelvis
_FIGURE = np.array([
    (0.0, -10.0), (0.0, -7.0), (-3.0, -7.0), (-4.0, -3.0), (-5.0, 1.0),
    (3.0, -7.0), (4.0, -3.0), (5.0, 1.0), (-2.0, 0.0), (-2.0, 5.0),
    (-2.0, 9.0), (2.0, 0.0), (2.0, 5.0), (2.0, 9.0), (-1.0, -10.5),
    (1.0, -10.5), (-2.0, -10.0), (2.0, -10.0)])
_LIMBS = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
          (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
          (0, 15), (15, 17))


def render(rng: np.random.Generator, h: int, w: int,
           people: tuple[int, int]) -> np.ndarray:
    """One (h, w, 3) uint8 RGB scene with people[0]..people[1] figures."""
    import cv2

    # low-frequency colour field, upsampled, plus sensor-like noise
    coarse = rng.uniform(20, 200, (max(h // 64, 2), max(w // 64, 2), 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0.0, 6.0, (h, w, 1)).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)
    side = min(h, w)
    for _ in range(int(rng.integers(2, 8))):
        p0 = tuple(int(v) for v in rng.integers(0, (w, h)))
        p1 = tuple(int(v) for v in rng.integers(0, (w, h)))
        cv2.line(img, p0, p1, tuple(int(c) for c in rng.integers(0, 255, 3)),
                 int(rng.integers(1, max(side // 200, 2) + 1)))
    for _ in range(int(rng.integers(people[0], people[1] + 1))):
        s = float(np.exp(rng.uniform(np.log(side / 40), np.log(side / 14))))
        cx, cy = rng.uniform(0.05 * w, 0.95 * w), rng.uniform(0.2 * h, h)
        theta = np.deg2rad(rng.uniform(-30, 30))
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        pts = (_FIGURE + rng.normal(0, 0.5, _FIGURE.shape)) @ rot.T * s
        pts = (pts + (cx, cy)).astype(np.int64)
        color = tuple(int(c) for c in rng.integers(80, 255, 3))
        thick = max(int(s * 0.8), 1)
        for a, b in _LIMBS:
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, thick)
        for p in pts:
            cv2.circle(img, tuple(p), max(int(s * 0.6), 1),
                       tuple(int(c) for c in rng.integers(0, 255, 3)), -1)
    return img


def render_many(seed: int, n: int, h: int, w: int, people: tuple[int, int],
                then: Optional[Callable] = None) -> list:
    """n scenes, scene i drawn from the i-th child of the seed's sequence
    on THREADS threads (the same pixels whatever the threads do); `then`
    maps (i, scene) to the value kept for scene i."""
    children = np.random.SeedSequence(seed).spawn(n)

    def one(i: int):
        img = render(np.random.default_rng(children[i]), h, w, people)
        return then(i, img) if then is not None else img

    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(one, range(n)))
