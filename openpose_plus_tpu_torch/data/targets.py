"""Ground-truth heatmap + PAF synthesis on the keypoints' device
(`openpose_plus_tpu/data/targets.py::make_targets`, the batch written out
instead of vmapped), in plain PyTorch ops.

Conventions (the JAX package's):
  * keypoints are (x, y, valid) in INPUT pixel coordinates
  * output grids are (hout, wout) at stride s; cell (i, j)'s center sits at
    input coords (j*s + s/2 - 0.5, i*s + s/2 - 0.5)
  * heatmap channel p = max over people of exp(-d^2 / (2 sigma^2)),
    background channel = 1 - max over parts
  * PAF limb l = average over people of the unit limb direction over a band
    of half-width `limb_width` around the segment (count-normalized where
    people overlap)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openpose_plus_tpu_torch import skeleton


def _grid_centers(hout: int, wout: int, stride: int):
    ys = np.arange(hout, dtype=np.float32) * stride + stride / 2 - 0.5
    xs = np.arange(wout, dtype=np.float32) * stride + stride / 2 - 0.5
    return ys, xs


@functools.lru_cache(maxsize=None)
def _constants(hout: int, wout: int, stride: int, sigma: float,
               device: torch.device) -> tuple[torch.Tensor, ...]:
    """The grid centers (gy (hout, 1), gx (1, wout)), 2 sigma^2, the limbs'
    endpoint parts and PAF channels, on `device`, cached: a call copies
    nothing from the host. 2 sigma^2 is a tensor, so the division by it is
    a true division, as in JAX (a Python scalar divisor may become a
    multiply by its reciprocal)."""
    ys, xs = _grid_centers(hout, wout, stride)
    pairs = torch.as_tensor(skeleton.pairs_array(), device=device).long()
    chans = torch.as_tensor(skeleton.paf_channels_array(),
                            device=device).long()
    return (torch.as_tensor(ys, device=device)[:, None],
            torch.as_tensor(xs, device=device)[None, :],
            torch.tensor(2.0 * sigma * sigma, device=device),
            pairs[:, 0], pairs[:, 1], chans[:, 0], chans[:, 1])


def make_targets(keypoints: torch.Tensor, hout: int, wout: int, stride: int,
                 sigma: float, limb_width: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """GT maps for a batch from padded keypoints (B, P, 18, 3).

    Returns (conf (B, hout, wout, 19), paf (B, hout, wout, 38)) float32 on
    the keypoints' device. Invalid keypoints (valid <= 0) contribute
    nothing."""
    kp = keypoints.to(torch.float32)
    gy, gx, two_sigma2, ia, ib, cx, cy = _constants(
        hout, wout, stride, float(sigma), kp.device)
    kx, ky, kv = kp[..., 0], kp[..., 1], kp[..., 2] > 0   # (B, P, 18)

    def grid(t: torch.Tensor) -> torch.Tensor:             # (..., 1, 1)
        return t[..., None, None]

    # ---- heatmaps: max of Gaussians (B, P, 18, hout, wout) -> max over P
    d2 = (gx - grid(kx)) ** 2 + (gy - grid(ky)) ** 2
    g = torch.where(grid(kv), torch.exp(-d2 / two_sigma2), 0.0)
    heat = g.amax(dim=1).permute(0, 2, 3, 1)               # (B, h, w, 18)
    background = 1.0 - heat.amax(dim=-1, keepdim=True)
    conf = torch.cat([heat, background], dim=-1)

    # ---- PAFs: count-averaged unit vectors in limb bands (B, P, L, h, w)
    ax, ay = kx[..., ia], ky[..., ia]                      # (B, P, L)
    bx, by = kx[..., ib], ky[..., ib]
    lv = kv[..., ia] & kv[..., ib]
    dx, dy = bx - ax, by - ay
    norm = torch.sqrt(dx * dx + dy * dy).clamp_min(1e-4)
    ux, uy = dx / norm, dy / norm
    relx, rely = gx - grid(ax), gy - grid(ay)
    along = relx * grid(ux) + rely * grid(uy)
    perp = torch.abs(-relx * grid(uy) + rely * grid(ux))
    band = ((along >= 0) & (along <= grid(norm)) & (perp <= limb_width)
            & grid(lv))
    vec_x = torch.where(band, grid(ux), 0.0).sum(dim=1)    # (B, L, h, w)
    vec_y = torch.where(band, grid(uy), 0.0).sum(dim=1)
    denom = band.sum(dim=1).to(torch.float32).clamp_min(1.0)
    vec_x, vec_y = vec_x / denom, vec_y / denom

    b = kp.shape[0]
    paf = torch.zeros((b, hout, wout, skeleton.N_PAF_CHANNELS),
                      dtype=torch.float32, device=kp.device)
    paf[..., cx] = vec_x.permute(0, 2, 3, 1)
    paf[..., cy] = vec_y.permute(0, 2, 3, 1)
    return conf, paf
