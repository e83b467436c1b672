"""Heatmap peaks: upsample -> smooth -> 3x3 NMS -> top-K -> subpixel refine.

Port of `openpose_plus_tpu/postproc/nms.py` with the batch dimension written
out: maps are (B, H, W, C), peak fields (B, n_parts, K). Static shapes as in
the reference: each part keeps its top `max_peaks` peaks and invalid slots
are masked.

The linear resize/blur operators are contracted in float64 and rounded once
to float32, so no process-global TF32 setting can reach them (the reference
contracts at Precision.HIGHEST); the results agree with it to ~1 ulp.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from openpose_plus_tpu import skeleton
from openpose_plus_tpu_torch.postproc import common


@dataclasses.dataclass
class PeakSet:
    """Top-K peaks per part (map-resolution coordinates), (B, n_parts, K)."""

    y: torch.Tensor          # int32 row coord
    x: torch.Tensor          # int32 col coord
    score: torch.Tensor      # float32 heatmap value at the peak (0 if absent)
    valid: torch.Tensor      # bool
    refined_y: torch.Tensor  # float32 subpixel row coord
    refined_x: torch.Tensor  # float32 subpixel col coord


@functools.lru_cache(maxsize=None)
def _upsample_smooth_matrix(n_in: int, factor: int, sigma: float
                            ) -> np.ndarray:
    """(n_in*factor, n_in) combined operator: bilinear resize (half-pixel
    centers, jax.image.resize weight convention incl. edge renormalization)
    followed by zero-padded Gaussian blur — composed in float64.

    A copy of `openpose_plus_tpu.postproc.nms._upsample_smooth_matrix`
    (pinned equal by tests/test_torch_weights.py)."""
    n_out = n_in * factor
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / factor - 0.5
    i0 = np.floor(src).astype(np.int64)
    d = src - i0
    r = np.zeros((n_out, n_in), dtype=np.float64)
    for tap, wt in ((i0, 1.0 - d), (i0 + 1, d)):
        ok = (tap >= 0) & (tap < n_in)
        r[np.arange(n_out)[ok], tap[ok]] += wt[ok]
    r /= r.sum(axis=1, keepdims=True)  # edge single-tap renormalization
    k = common.gaussian_kernel_1d(sigma).astype(np.float64)
    if k.size > 1:
        rad = k.size // 2
        g = np.zeros((n_out, n_out), dtype=np.float64)
        for j, kv in enumerate(k):
            off = j - rad
            idx = np.arange(max(0, -off), min(n_out, n_out - off))
            g[idx, idx + off] = kv
        r = g @ r
    return r.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _operator(n_in: int, factor: int, sigma: float, device: torch.device
              ) -> torch.Tensor:
    """`_upsample_smooth_matrix` as a float64 tensor, cached per device (a
    pageable host-to-device copy per call would stall the stream)."""
    return torch.from_numpy(_upsample_smooth_matrix(n_in, factor, sigma)).to(
        device, torch.float64)


def _separable(maps: torch.Tensor, factor: int, sigma: float
               ) -> torch.Tensor:
    """out[b, Y, X, c] = sum_hw ay[Y, h] ax[X, w] maps[b, h, w, c]."""
    ay = _operator(maps.shape[1], factor, sigma, maps.device)
    ax = _operator(maps.shape[2], factor, sigma, maps.device)
    t = torch.einsum("Yh,bhwc->bYwc", ay, maps.to(torch.float64))
    return torch.einsum("Xw,bYwc->bYXc", ax, t).to(torch.float32)


def upsample(maps: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsample (B, H, W, C) by an integer factor (half-pixel
    centers; the reference's jax.image.resize 'linear')."""
    if factor == 1:
        return maps
    return _separable(maps, factor, 0.0)


def upsample_smooth(maps: torch.Tensor, factor: int, sigma: float
                    ) -> torch.Tensor:
    """Fused bilinear-upsample + Gaussian-smooth of (B, H, W, C) maps as one
    pair of per-axis contractions."""
    return _separable(maps, factor, sigma)


def _pool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool of (B, H, W, C) with -inf padding."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)


def _subpixel_refine(parts: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadratic 3-tap refinement; zero offset at borders.

    parts (B, h, w, P); y, x (B, P, K) int. The taps are exact gathers."""
    b, h, w, p = parts.shape
    flat = parts.permute(0, 3, 1, 2).reshape(b, p, h * w)

    def tap(dy: int, dx: int) -> torch.Tensor:
        ry = (y + dy).clamp(0, h - 1)
        rx = (x + dx).clamp(0, w - 1)
        return flat.gather(2, (ry * w + rx).long())

    def axis_offset(center, prev, nxt):
        denom = 2.0 * center - nxt - prev
        off = torch.where(denom.abs() > 1e-6, 0.5 * (nxt - prev) / denom,
                          torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    c = tap(0, 0)
    ox = axis_offset(c, tap(0, -1), tap(0, 1))
    oy = axis_offset(c, tap(-1, 0), tap(1, 0))
    ox = torch.where((x > 0) & (x < w - 1), ox, torch.zeros_like(ox))
    oy = torch.where((y > 0) & (y < h - 1), oy, torch.zeros_like(oy))
    return y.to(torch.float32) + oy, x.to(torch.float32) + ox


def _topk_stable(flat: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis: descending value, ties to the LOWEST
    index (a stable sort; torch.topk's tie order is unspecified)."""
    if flat.shape[-1] < k:
        flat = F.pad(flat, (0, k - flat.shape[-1]), value=-torch.inf)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return scores[..., :k], idx[..., :k]


def find_peaks(smoothed: torch.Tensor, threshold: float, max_peaks: int
               ) -> PeakSet:
    """3x3 local-max NMS + per-part top-K on smoothed (B, H, W, >=18) maps.

    A pixel is a peak iff it equals the 3x3 max (-inf padding), is strictly
    above `threshold`, and has the lowest flat index among equal-valued
    candidate neighbours (the plateau tie-break of the reference). Order:
    descending score, ties by ascending flat index; exhausted slots get
    index 0 and valid=False."""
    b, h, w = smoothed.shape[:3]
    n = skeleton.N_PARTS
    parts = smoothed[..., :n]
    cand = (parts >= _pool3x3(parts)) & (parts > threshold)
    idx_f = torch.arange(h * w, dtype=torch.float32,
                         device=smoothed.device).reshape(1, h, w, 1)
    u = torch.where(cand, -idx_f, torch.full_like(parts, -torch.inf))
    is_peak = cand & (u >= _pool3x3(u))
    flat = torch.where(is_peak, parts, torch.full_like(parts, -torch.inf))
    flat = flat.reshape(b, h * w, n).transpose(1, 2)       # (B, P, H*W)
    score, idx = _topk_stable(flat, max_peaks)
    valid = score > threshold
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    y = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    x = (idx % w).to(torch.int32)
    ry, rx = _subpixel_refine(parts, y, x)
    return PeakSet(y=y, x=x,
                   score=torch.where(valid, score, torch.zeros_like(score)),
                   valid=valid, refined_y=ry, refined_x=rx)
