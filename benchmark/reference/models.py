"""The two pose networks as plain float32 PyTorch functions of a state_dict
(the parameter names of the served program's modules, which the benchmark
makes from the seed and hands to both sides), with TF32 off.

MobileNet-thin (openpose-plus's at width 0.75, as the repo reconstructs
it): a 3x3 stride-2 stem, nine depthwise-separable blocks (dw2, dw4 stride
2), the
stride-4 block (dw3) max-pooled 2x2 and put in front of dw9's output, then
six two-branch stages of three separable 3x3 layers, a 1x1 projection
(256 in stage 1, 128 after) and a 1x1 prediction; stage t > 1 reads
concat(feature, conf, paf) of stage t - 1.

VGG19 OpenPose (Cao et al. CVPR 2017, `pose_deploy_linevec.prototxt`):
conv1_1 .. conv4_2 with 2x2 pools after blocks 1-3, two 3x3 CPM convs (256,
128), stage 1 three 3x3 convs of 128, a 1x1 of 512 and the prediction,
stages 2-6 five 7x7 convs of 128, a 1x1 of 128 and the prediction.

Every conv pads as TensorFlow's SAME (an odd total puts the extra row or
column at the end), adds its bias, then ReLU; the predictions have no
ReLU. Inputs are uint8 RGB (B, H, W, 3) mapped to x / 255 - 0.5.

`forward(..., bf16=True)` keeps the arithmetic in float32 but rounds what a
bf16 network stores to bf16: each conv's input and weights, its output,
the bias and the sum, every layer but the predictions, which take their
input in float32 as a bf16 network's float32 heads do. It measures how far
bf16 storage alone moves a given network's maps.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

VGG19_BLOCKS = (("conv1", 2, True), ("conv2", 2, True), ("conv3", 4, True),
                ("conv4", 2, False))
MOBILENET_STRIDES = {"dw2": 2, "dw4": 2}


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and products in float32, not TF32; the
    process's settings come back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, r=_keep,
         stride: int = 1, groups: int = 1, relu: bool = True
         ) -> torch.Tensor:
    """A SAME conv, its bias and ReLU (none for a prediction); `r` rounds
    what the network stores."""
    top, bottom = _same(x.shape[2], w.shape[2], stride)
    left, right = _same(x.shape[3], w.shape[3], stride)
    if not relu:                               # a prediction: float32
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w.float(),
                        b.float(), stride=stride, groups=groups)
    y = F.conv2d(F.pad(r(x), (left, right, top, bottom)), r(w.float()),
                 None, stride=stride, groups=groups)
    return F.relu(r(r(y) + r(b.float()).view(1, -1, 1, 1)))


def sep(x: torch.Tensor, sd: dict, name: str, r, stride: int = 1
        ) -> torch.Tensor:
    x = conv(x, sd[f"{name}.dw_weight"], sd[f"{name}.dw_bias"], r, stride,
             groups=x.shape[1])
    return conv(x, sd[f"{name}.pw_weight"], sd[f"{name}.pw_bias"], r)


def branch(x: torch.Tensor, sd: dict, name: str, r) -> torch.Tensor:
    """One stage branch: its mid layers in order, the projection, the
    prediction (names of the served modules: `SepConvRelu_i` or
    `ConvRelu_i`; the last `ConvRelu_*` is the 1x1 projection)."""
    layers = sorted({k[len(name) + 1:].split(".")[0] for k in sd
                     if k.startswith(name + ".")} - {"Conv_0"},
                    key=lambda s: (not s.startswith("SepConvRelu"),
                                   int(s.rsplit("_", 1)[1])))
    for layer in layers:
        full = f"{name}.{layer}"
        if layer.startswith("SepConvRelu"):
            x = sep(x, sd, full, r)
        else:
            x = conv(x, sd[f"{full}.weight"], sd[f"{full}.bias"], r)
    return conv(x, sd[f"{name}.Conv_0.weight"], sd[f"{name}.Conv_0.bias"],
                relu=False)


def stages(feature: torch.Tensor, sd: dict, n_stages: int, r
           ) -> tuple[torch.Tensor, torch.Tensor]:
    x = feature
    for s in range(1, n_stages + 1):
        if s > 1:
            x = torch.cat([feature, r(conf), r(paf)], dim=1)
        conf = branch(x, sd, f"stages.stage{s}_conf", r)
        paf = branch(x, sd, f"stages.stage{s}_paf", r)
    return conf, paf


def mobilenet_thin(x: torch.Tensor, sd: dict, n_stages: int, r=_keep):
    x = conv(x, sd["conv1.weight"], sd["conv1.bias"], r, stride=2)
    feat_s4 = None
    for i in range(1, 10):
        x = sep(x, sd, f"dw{i}", r, MOBILENET_STRIDES.get(f"dw{i}", 1))
        if i == 3:
            feat_s4 = x
    feature = torch.cat([F.max_pool2d(feat_s4, 2, 2), x], dim=1)
    return stages(feature, sd, n_stages, r)


def vgg19(x: torch.Tensor, sd: dict, n_stages: int, r=_keep):
    for prefix, n, pool in VGG19_BLOCKS:
        for i in range(1, n + 1):
            x = conv(x, sd[f"{prefix}_{i}.weight"], sd[f"{prefix}_{i}.bias"],
                     r)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    for name in ("conv4_3_cpm", "conv4_4_cpm"):
        x = conv(x, sd[f"{name}.weight"], sd[f"{name}.bias"], r)
    return stages(x, sd, n_stages, r)


NETWORKS = {"mobilenet_thin": mobilenet_thin, "vgg19": vgg19}


@torch.no_grad()
def forward(arch: str, sd: dict, images: torch.Tensor, n_stages: int,
            bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) -> the last stage's (conf, paf), (B, H/8, W/8,
    19 / 38) float32, on the images' device; `bf16` rounds what a bf16
    network stores (module docstring)."""
    x = images.permute(0, 3, 1, 2).float() / 255.0 - 0.5
    with no_tf32():
        conf, paf = NETWORKS[arch](x, sd, n_stages, _bf16 if bf16 else _keep)
    return conf.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)
