"""CMU OpenPose BODY_25 in PyTorch (Cao et al., TPAMI 2019,
arXiv:1812.08008; `models/pose/body_25/pose_deploy.prototxt` of
CMU-Perceptual-Computing-Lab/openpose), OpenPose's default body model. The
JAX package has no counterpart.

Front: VGG19's conv1_1 .. conv4_1 with ReLU (`common.vgg_block`, as
VGGFamilyPose builds them), then conv4_2 (512), conv4_3_CPM (256) and
conv4_4_CPM (128) with PReLU: the stride-8 feature F of 128 channels.
Then four PAF stages and two heatmap stages that read the last PAFs:

  PAF stage 0      reads F                                    128 channels
  PAF stages 1-3   read concat(F, the previous PAFs)          180
  heatmap stage 0  reads concat(F, the last PAFs)             180
  heatmap stage 1  reads concat(F, stage 0's heatmaps, PAFs)  206

A stage (`DenseStage`, the prototxt's Mconv1-7) is five dense blocks
(three chained 3x3 PReLU convs, their outputs concatenated), a 1x1 PReLU
conv and the float32 1x1 prediction: blocks of width 96 (288 out) and a
1x1 of 256 in the first stage of each kind, 128 (384) and 512 in the
others. The predictions are 52 PAF channels (BODY_25's 26 limbs) and 26
heatmaps (25 parts and the background). Convs, biases and PReLUs run in
the compute dtype (bf16 on cuDNN, or float32), the predictions in float32
on the upcast input, as the other models' heads.

Inference only, at the published six stages: another stage count, int8,
the fused separable path and training raise.
"""

from __future__ import annotations

import torch
from torch import nn

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.models.common import (
    Conv1x1F32, DenseBlock, PReLUConv, compute_dtype, run_vgg_block,
    vgg_block, vgg_input)
from openpose_plus_tpu_torch.utils.tracer import scope

N_PAF_STAGES = 4
N_CONF_STAGES = 2
N_BLOCKS = 5
FEATURES = 128
INFERENCE_ONLY = "BODY_25 serves bf16/float32 inference only"


class DenseStage(nn.Module):
    """Five DenseBlocks of `width` (Mconv1-5), a 1x1 PReLUConv of `proj`
    (Mconv6), the float32 1x1 prediction of `out` channels (Mconv7)."""

    def __init__(self, in_features: int, width: int, proj: int, out: int,
                 dtype: str):
        super().__init__()
        c = in_features
        for i in range(1, N_BLOCKS + 1):
            self.add_module(f"Mconv{i}", DenseBlock(c, width, dtype))
            c = 3 * width
        self.Mconv6 = PReLUConv(c, proj, kernel=1, dtype=dtype)
        self.Mconv7 = Conv1x1F32(proj, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class PafFirstStages(nn.Module):
    """BODY_25's stage stack: `stage{s}_L2` (s < 4) the PAF stages,
    `stage{s}_L1` (s < 2) the heatmap stages (the prototxt's names). Spans
    `models.paf_stages` and `models.conf_stages` time each kind."""

    def __init__(self, n_heatmaps: int, n_pafs: int, dtype: str):
        super().__init__()
        f = FEATURES
        for s in range(N_PAF_STAGES):
            self.add_module(f"stage{s}_L2", DenseStage(
                f if s == 0 else f + n_pafs, 96 if s == 0 else 128,
                256 if s == 0 else 512, n_pafs, dtype))
        for s in range(N_CONF_STAGES):
            self.add_module(f"stage{s}_L1", DenseStage(
                f + n_pafs + (0 if s == 0 else n_heatmaps),
                96 if s == 0 else 128, 256 if s == 0 else 512, n_heatmaps,
                dtype))

    def forward(self, feature: torch.Tensor
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        dt = feature.dtype
        pafs: list[torch.Tensor] = []
        with scope("models.paf_stages", device=feature.device):
            x = feature
            for s in range(N_PAF_STAGES):
                if s > 0:
                    x = torch.cat([feature, pafs[-1].to(dt)], dim=1)
                pafs.append(getattr(self, f"stage{s}_L2")(x))
        confs: list[torch.Tensor] = []
        with scope("models.conf_stages", device=feature.device):
            paf = pafs[-1].to(dt)
            for s in range(N_CONF_STAGES):
                x = torch.cat([feature, *(c.to(dt) for c in confs[-1:]),
                               paf], dim=1)
                confs.append(getattr(self, f"stage{s}_L1")(x))
        return confs, pafs


class Body25Pose(nn.Module):
    """BODY_25 (module docstring): NHWC float images in (plain, or the s2d
    layout when the config keeps `stem_s2d`, turned back into the plain
    image first); the output dict of the other models, `conf` the two
    heatmap stages' (B, H/8, W/8, 26), `paf` the four PAF stages' (.., 52).
    The span `models.front` times the front."""

    BLOCKS = (("conv1", (64, 64), True), ("conv2", (128, 128), True),
              ("conv3", (256, 256, 256, 256), True), ("conv4", (512,), False))
    PRELU = (("conv4_2", 512), ("conv4_3_cpm", 256),
             ("conv4_4_cpm", FEATURES))

    def __init__(self, cfg):
        super().__init__()
        skel = skeletons.BODY25
        if cfg.n_stages != N_PAF_STAGES + N_CONF_STAGES:
            raise ValueError(f"BODY_25 has {N_PAF_STAGES} PAF and "
                             f"{N_CONF_STAGES} heatmap stages (n_stages 6), "
                             f"not n_stages {cfg.n_stages}")
        if cfg.compute_dtype == "int8" or cfg.fused_inference:
            raise ValueError(f"{INFERENCE_ONLY}: no int8 path and no fused "
                             "separable layers")
        if (cfg.n_heatmaps, cfg.n_pafs) != (skel.n_heatmaps, skel.n_pafs):
            raise ValueError(f"BODY_25 predicts {skel.n_heatmaps} heatmaps "
                             f"and {skel.n_pafs} PAF channels, not "
                             f"{cfg.n_heatmaps} and {cfg.n_pafs}")
        d = cfg.compute_dtype
        self.dtype = compute_dtype(d)
        self.stem_s2d = cfg.stem_s2d
        self.blocks = []
        c = 3
        for prefix, features, pool in self.BLOCKS:
            self.blocks.append((vgg_block(self, prefix, c, features, d),
                                pool))
            c = features[-1]
        for name, f in self.PRELU:
            self.add_module(name, PReLUConv(c, f, dtype=d))
            c = f
        self.stages = PafFirstStages(cfg.n_heatmaps, cfg.n_pafs, d)
        self.eval()

    def train(self, mode: bool = True) -> "Body25Pose":
        if mode:
            raise ValueError(f"{INFERENCE_ONLY}: it does not train")
        return super().train(False)

    def forward(self, x: torch.Tensor) -> dict:
        if torch.is_grad_enabled():
            raise ValueError(f"{INFERENCE_ONLY}: run it under "
                             "torch.no_grad() or torch.inference_mode()")
        with scope("models.front", device=x.device):
            x = vgg_input(x, self.stem_s2d, self.dtype)
            for names, pool in self.blocks:
                x = run_vgg_block(self, x, names, pool)
            for name, _ in self.PRELU:
                x = getattr(self, name)(x)
        confs, pafs = self.stages(x)

        def nhwc(t: torch.Tensor) -> torch.Tensor:
            return t.permute(0, 2, 3, 1)

        return dict(conf=[nhwc(c) for c in confs],
                    paf=[nhwc(p) for p in pafs], feature=nhwc(x))
