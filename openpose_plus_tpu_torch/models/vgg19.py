"""VGG19-backbone OpenPose (the CVPR'17 network) in PyTorch
(`openpose_plus_tpu/models/vgg19.py`, plain lowering).

VGG19 conv1_1 .. conv4_2, two CPM convs giving the stride-8 feature F
(128 channels), then the dense 6-stage two-branch head: stage 1 is three
3x3 convs with a 512-wide projection, the refine stages five 7x7 convs of
128 over concat(F, conf, paf), 185 channels. The JAX model runs the conv1
block on the space-to-depth grid when `stem_s2d` is set; that is the same
math with the same parameters and is not ported.
"""

from __future__ import annotations

from openpose_plus_tpu_torch.models.common import VGGFamilyPose


class VGG19Pose(VGGFamilyPose):
    BLOCKS = (("conv1", (64, 64), True), ("conv2", (128, 128), True),
              ("conv3", (256, 256, 256, 256), True),
              ("conv4", (512, 512), False))
    CPM = (("conv4_3_cpm", 256), ("conv4_4_cpm", 128))
    HEAD = dict(refine_kernel=7)
