"""Horizontal-flip map mirroring for test-time augmentation.

Port of `openpose_plus_tpu/postproc/flip.py`. Mirroring the maps of a
horizontally flipped input back into the original orientation reverses the
W axis and, besides:

  * permutes the confidence channels left <-> right (FLIP_SWAP_PAIRS);
  * moves each limb's PAF channel pair to its mirrored limb;
  * negates the PAF x components.

`mirror_maps` is an involution, exactly. The permutation tables are numpy
copies of the JAX module's (it imports JAX); tests/test_torch_tta.py pins
each equal to its original.
"""

from __future__ import annotations

import numpy as np
import torch

from openpose_plus_tpu_torch import skeleton
from openpose_plus_tpu_torch.ops import device_cache


def _part_swap() -> np.ndarray:
    swap = np.arange(skeleton.N_HEATMAPS)
    for a, b in skeleton.FLIP_SWAP_PAIRS:
        swap[a], swap[b] = b, a
    return swap


def _limb_mirror() -> np.ndarray:
    """mirror[l] = limb index whose endpoints are the part-swapped
    endpoints of limb l (order-sensitive match, then orderless)."""
    swap = _part_swap()
    pairs = list(skeleton.COCO_PAIRS)
    mirror = np.zeros(skeleton.N_LIMBS, np.int64)
    for l, (a, b) in enumerate(pairs):
        sa, sb = int(swap[a]), int(swap[b])
        if (sa, sb) in pairs:
            mirror[l] = pairs.index((sa, sb))
        elif (sb, sa) in pairs:
            raise AssertionError(
                f"limb {l} mirrors to reversed pair; COCO_PAIRS should be "
                "closed under L/R swap with preserved orientation")
        else:
            raise AssertionError(f"no mirror limb for {l}")
    return mirror


_PART_SWAP = _part_swap()
_LIMB_MIRROR = _limb_mirror()


def paf_channel_permutation() -> tuple[np.ndarray, np.ndarray]:
    """(perm, sign): mirrored paf channel c comes from channel perm[c]
    scaled by sign[c]."""
    chans = skeleton.paf_channels_array()
    perm = np.zeros(skeleton.N_PAF_CHANNELS, np.int64)
    sign = np.ones(skeleton.N_PAF_CHANNELS, np.float32)
    for l in range(skeleton.N_LIMBS):
        ml = _LIMB_MIRROR[l]
        cx, cy = chans[l]
        mx, my = chans[ml]
        perm[cx] = mx
        perm[cy] = my
        sign[cx] = -1.0  # x component flips direction
    return perm, sign


_PAF_PERM, _PAF_SIGN = paf_channel_permutation()


@device_cache
def _tables(device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The part swap, PAF permutation and PAF sign on `device`, cached (no
    host copy per call)."""
    return (torch.as_tensor(_PART_SWAP, device=device),
            torch.as_tensor(_PAF_PERM, device=device),
            torch.as_tensor(_PAF_SIGN, device=device))


def mirror_maps(conf: torch.Tensor, paf: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mirror (..., H, W, C) maps produced from a horizontally flipped
    input back into original-image orientation (COCO's maps: the tables
    are the 18-part skeleton's)."""
    if (conf.shape[-1], paf.shape[-1]) != (skeleton.N_HEATMAPS,
                                           skeleton.N_PAF_CHANNELS):
        raise ValueError(f"mirror_maps holds COCO's flip tables, not maps of "
                         f"{conf.shape[-1]} and {paf.shape[-1]} channels")
    swap, perm, sign = _tables(conf.device)
    conf_m = torch.flip(conf, dims=(-2,))[..., swap]
    paf_m = torch.flip(paf, dims=(-2,))[..., perm] * sign
    return conf_m, paf_m
