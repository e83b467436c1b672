"""hao28-experimental in PyTorch (`openpose_plus_tpu/models/hao28.py`,
plain lowering): a compact plain-conv backbone and lighter dense stage
heads (stage 1 projects to 256; three 3x3 refine convs of 128).
"""

from __future__ import annotations

from openpose_plus_tpu_torch.models.common import VGGFamilyPose


class Hao28Pose(VGGFamilyPose):
    BLOCKS = (("conv1", (32, 32), True), ("conv2", (64, 64), True),
              ("conv3", (128, 128, 128, 128), True),
              ("conv4", (256, 128), False))
    HEAD = dict(stage1_convs=3, stage1_kernel=3, stage1_proj=256,
                refine_convs=3, refine_kernel=3, refine_mid=128)
