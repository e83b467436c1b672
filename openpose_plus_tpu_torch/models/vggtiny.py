"""VGG-tiny in PyTorch (`openpose_plus_tpu/models/vggtiny.py`, plain
lowering): a slimmed VGG backbone (about half the channels and depth of
VGG19, no CPM convs) and the dense head with 3x3 refine convs.
"""

from __future__ import annotations

from openpose_plus_tpu_torch.models.common import VGGFamilyPose


class VGGTinyPose(VGGFamilyPose):
    BLOCKS = (("conv1", (32, 32), True), ("conv2", (64, 64), True),
              ("conv3", (128, 128, 128), True), ("conv4", (256, 128), False))
    HEAD = dict(refine_kernel=3, refine_convs=5)
