"""MobileNet-thin in PyTorch (`openpose_plus_tpu/models/mobilenet_thin.py`,
plain lowering).

MobileNet v1 at width 0.75: a 3x3 stride-2 stem, nine depthwise-separable
blocks (stride 8 overall), the stride-4 tap max-pooled onto the stride-8
grid and concatenated in front, then the separable multi-stage head. The
JAX model lowers the stem region through space-to-depth on mod-4 inputs;
that is the same math (exactly so in float32) and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openpose_plus_tpu.config import ModelConfig
from openpose_plus_tpu_torch.models import common


def _w(width: float, c: int) -> int:
    """Width-multiplied channel count, rounded to a multiple of 8 (TPU lane
    friendliness; the reference rounds to arbitrary ints)."""
    return max(8, int(round(c * width / 8)) * 8)


class MobileNetThinPose(nn.Module):
    """NHWC float images in; dict(conf=[per-stage (B, H/8, W/8, 19)],
    paf=[per-stage (B, H/8, W/8, 38)], feature=(B, H/8, W/8, C)) out —
    the JAX model's output convention."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        w = cfg.width_multiplier
        d = cfg.compute_dtype
        self.dtype = common.compute_dtype(d)
        c32, c64, c128, c256, c512 = (_w(w, c) for c in (32, 64, 128, 256,
                                                        512))
        self.conv1 = common.ConvRelu(3, c32, stride=2, dtype=d)
        self.dw1 = common.SepConvRelu(c32, c64, dtype=d)
        self.dw2 = common.SepConvRelu(c64, c128, stride=2, dtype=d)
        self.dw3 = common.SepConvRelu(c128, c128, dtype=d)
        self.dw4 = common.SepConvRelu(c128, c256, stride=2, dtype=d)
        self.dw5 = common.SepConvRelu(c256, c256, dtype=d)
        self.dw6 = common.SepConvRelu(c256, c512, dtype=d)
        self.dw7 = common.SepConvRelu(c512, c512, dtype=d)
        self.dw8 = common.SepConvRelu(c512, c512, dtype=d)
        self.dw9 = common.SepConvRelu(c512, c512, dtype=d)
        self.stages = common.MultiStageHead(
            c128 + c512, n_heatmaps=cfg.n_heatmaps, n_pafs=cfg.n_pafs,
            n_stages=cfg.n_stages, stage1_convs=3, stage1_kernel=3,
            stage1_proj=256, refine_convs=3, refine_kernel=3, refine_mid=128,
            dtype=d)

    def forward(self, x: torch.Tensor) -> dict:
        if x.shape[-1] != 3:
            raise NotImplementedError(
                "space-to-depth input layouts (12/48 channels) are ROADMAP.md "
                "item 'Engine main path'; feed plain (B, H, W, 3) images")
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # NCHW, channels-last
        x = self.conv1(x)                              # stride 2
        x = self.dw1(x)
        x = self.dw2(x)                                # stride 4
        feat_s4 = self.dw3(x)
        x = self.dw4(feat_s4)                          # stride 8
        for block in (self.dw5, self.dw6, self.dw7, self.dw8, self.dw9):
            x = block(x)
        pooled = F.max_pool2d(feat_s4, 2, 2)
        feature = torch.cat([pooled, x], dim=1)
        confs, pafs = self.stages(feature)

        def nhwc(t: torch.Tensor) -> torch.Tensor:
            return t.permute(0, 2, 3, 1)

        return dict(conf=[nhwc(c) for c in confs],
                    paf=[nhwc(p) for p in pafs], feature=nhwc(feature))
