"""OpenPose BODY_25 as plain float32 torch operations on a state_dict: the
reference the port's `models/body25.py` is held to. It imports nothing of
the port and nothing of JAX, and turns TF32 off, so its convolutions are
float32 products wherever it runs.

The network, after `models/pose/body_25/pose_deploy.prototxt` of
CMU-Perceptual-Computing-Lab/openpose (Cao et al., TPAMI 2019):

  conv1_1 .. conv4_1   3x3, ReLU, 2x2 max pools after conv1_2, conv2_2 and
                       conv3_4 (64, 64 | 128, 128 | 256 x 4 | 512)
  conv4_2              3x3, 512, PReLU
  conv4_3_CPM          3x3, 256, PReLU
  conv4_4_CPM          3x3, 128, PReLU: the feature F
  PAF stage s (L2)     reads F (s = 0) or concat(F, PAF_{s-1}), s = 0..3
  heatmap stage 0 (L1) reads concat(F, PAF_3)
  heatmap stage 1 (L1) reads concat(F, heatmaps_0, PAF_3)

each stage five dense blocks (three chained 3x3 convs with PReLU, the
three outputs concatenated in order), a 1x1 conv with PReLU and a 1x1
prediction without activation: widths 96 / 256 in stage 0 of each kind,
128 / 512 after; 52 PAF channels and 26 heatmaps.

Departures, each stated:
- Parameters carry the port's names (`conv4_3_cpm`, `stages.stage0_L2.
  Mconv1.conv0`, a PReLU's slope `<conv>.slope`), not Caffe's blob names.
- Every conv pads as TensorFlow's SAME; at stride 1 and odd kernels, as
  here, that is Caffe's pad (k - 1) / 2.
- The input is the port's: NHWC float images in [-0.5, 0.5] (OpenPose
  feeds x / 256 - 0.5 in BGR order; with random weights the channel order
  and scale are only a relabelling of the same computation).
- `bf16=True` keeps the arithmetic in float32 but rounds to bfloat16 what
  a bf16 network stores: each conv's input and weights, its output, the
  bias and the sum, the slopes and the PReLU's output; the predictions take
  their input in float32, as the port's float32 heads do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FRONT = (("conv1", 2, True), ("conv2", 2, True), ("conv3", 4, True),
         ("conv4", 1, False))
PRELU_FRONT = ("conv4_2", "conv4_3_cpm", "conv4_4_cpm")
N_PAF_STAGES, N_CONF_STAGES, N_BLOCKS = 4, 2, 5


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def conv(x: torch.Tensor, sd: dict, name: str, r) -> torch.Tensor:
    """The conv `name` and its bias, SAME padding, stride 1."""
    w = sd[f"{name}.weight"].float()
    pad = w.shape[-1] // 2
    y = F.conv2d(r(x), r(w), None, padding=pad)
    return r(r(y) + r(sd[f"{name}.bias"].float()).view(1, -1, 1, 1))


def relu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y > 0, y, torch.zeros_like(y))


def prelu(y: torch.Tensor, slope: torch.Tensor, r) -> torch.Tensor:
    """max(y, 0) + slope * min(y, 0), a slope a channel."""
    return r(torch.where(y >= 0, y, r(slope.float()).view(1, -1, 1, 1) * y))


def conv_prelu(x: torch.Tensor, sd: dict, name: str, r) -> torch.Tensor:
    return prelu(conv(x, sd, name, r), sd[f"{name}.slope"], r)


def predict(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    """A float32 1x1 prediction (no activation) of the float32 input."""
    return F.conv2d(x.float(), sd[f"{name}.weight"].float(),
                    sd[f"{name}.bias"].float())


def dense_stage(x: torch.Tensor, sd: dict, name: str, r) -> torch.Tensor:
    for i in range(1, N_BLOCKS + 1):
        a = conv_prelu(x, sd, f"{name}.Mconv{i}.conv0", r)
        b = conv_prelu(a, sd, f"{name}.Mconv{i}.conv1", r)
        c = conv_prelu(b, sd, f"{name}.Mconv{i}.conv2", r)
        x = torch.cat([a, b, c], dim=1)
    x = conv_prelu(x, sd, f"{name}.Mconv6", r)
    return predict(x, sd, f"{name}.Mconv7")


@torch.no_grad()
def forward(images: torch.Tensor, sd: dict, bf16: bool = False
            ) -> dict:
    """images (B, H, W, 3) float -> {"conf": [2 x (B, H/8, W/8, 26)],
    "paf": [4 x (B, H/8, W/8, 52)], "feature": (B, H/8, W/8, 128)}, float32
    NHWC as the port's model returns them."""
    r = _bf16 if bf16 else _keep
    x = images.float().permute(0, 3, 1, 2)
    for prefix, n, pool in FRONT:
        for i in range(1, n + 1):
            x = relu(conv(x, sd, f"{prefix}_{i}", r))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    for name in PRELU_FRONT:
        x = conv_prelu(x, sd, name, r)
    feature = x
    pafs = []
    for s in range(N_PAF_STAGES):
        inp = feature if s == 0 else torch.cat([feature, r(pafs[-1])], 1)
        pafs.append(dense_stage(inp, sd, f"stages.stage{s}_L2", r))
    confs = []
    for s in range(N_CONF_STAGES):
        inp = torch.cat([feature, *(r(c) for c in confs[-1:]),
                         r(pafs[-1])], 1)
        confs.append(dense_stage(inp, sd, f"stages.stage{s}_L1", r))

    def nhwc(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 2, 3, 1)

    return dict(conf=[nhwc(c) for c in confs], paf=[nhwc(p) for p in pafs],
                feature=nhwc(feature))
