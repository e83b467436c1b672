"""VGG19 OpenPose (Cao et al. CVPR 2017, `pose_deploy_linevec.prototxt`):
conv1_1 .. conv4_2 with 2x2 pools after blocks 1-3, two 3x3 CPM convs (256,
128), stage 1 three 3x3 convs of 128, a 1x1 of 512 and the prediction,
stages 2-6 five 7x7 convs of 128, a 1x1 of 128 and the prediction."""

from __future__ import annotations

import torch.nn.functional as F

from reference import models
from reference.families import paf

FAMILY = "paf"
SKELETON = "coco18"
CPU_CUT = {"n_stages": 2}         # it runs with any stage count
BLOCKS = (("conv1", 2, True), ("conv2", 2, True), ("conv3", 4, True),
          ("conv4", 2, False))


def forward(x, sd: dict, model: dict, r):
    for prefix, n, pool in BLOCKS:
        for i in range(1, n + 1):
            x = models.conv(x, sd[f"{prefix}_{i}.weight"],
                            sd[f"{prefix}_{i}.bias"], r)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    for name in ("conv4_3_cpm", "conv4_4_cpm"):
        x = models.conv(x, sd[f"{name}.weight"], sd[f"{name}.bias"], r)
    return paf.stages(x, sd, model["n_stages"], r)


heads = paf.stage_heads
predictions = paf.stage_predictions
