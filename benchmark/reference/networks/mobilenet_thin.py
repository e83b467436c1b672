"""MobileNet-thin (openpose-plus's at width 0.75, as the repo reconstructs
it): a 3x3 stride-2 stem, nine depthwise-separable blocks (dw2, dw4 stride
2), the stride-4 block (dw3) max-pooled 2x2 and put in front of dw9's
output, then six two-branch stages of three separable 3x3 layers, a 1x1
projection (256 in stage 1, 128 after) and a 1x1 prediction; stage t > 1
reads concat(feature, conf, paf) of stage t - 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import models
from reference.families import paf

FAMILY = "paf"
SKELETON = "coco18"
CPU_CUT = {"n_stages": 2}         # it runs with any stage count
STRIDES = {"dw2": 2, "dw4": 2}


def forward(x, sd: dict, model: dict, r):
    x = models.conv(x, sd["conv1.weight"], sd["conv1.bias"], r, stride=2)
    feat_s4 = None
    for i in range(1, 10):
        x = models.sep(x, sd, f"dw{i}", r, STRIDES.get(f"dw{i}", 1))
        if i == 3:
            feat_s4 = x
    feature = torch.cat([F.max_pool2d(feat_s4, 2, 2), x], dim=1)
    return paf.stages(feature, sd, model["n_stages"], r)


heads = paf.stage_heads
predictions = paf.stage_predictions
