"""Shared building blocks of the pose models, in PyTorch.

Port of `openpose_plus_tpu/models/common.py` (the plain lowering only: no
space-to-depth rearrangements, no fused Pallas branch, no int8). Submodules
and parameters carry the Flax scope names so the weight bridge
(`openpose_plus_tpu_torch.checkpoint`) is a rename plus a transpose.

Numerics follow the reference layer by layer: every conv runs in the compute
dtype, its bias is added in the compute dtype AFTER the conv, then ReLU; the
last 1x1 of each branch runs in float32 on the upcast input. Tensors are
NCHW inside the model; parameters are float32 and cast per call, as the
Flax modules cast their float32 params.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype {name!r} is not ported (int8 is ROADMAP.md item "
            "'Calibrated int8'); use 'bfloat16' or 'float32'")
    return _DTYPES[name]


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of TF/XLA "SAME" along one axis.

    out = ceil(size / stride); the total pad puts the extra pixel at the
    HIGH end — a 3x3 stride-2 conv on an even size pads (0, 1), where
    torch's symmetric `padding=1` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW conv with "SAME" padding, no bias."""
    top, bottom = same_padding(x.shape[-2], weight.shape[-2], stride)
    left, right = same_padding(x.shape[-1], weight.shape[-1], stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, None, stride, (top, left), 1, groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, None, stride, 0, 1, groups)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal in [-2, 2] sigma, with
    variance 1/fan_in after the truncation's 0.8796 correction."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _bias_add(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


class ConvRelu(nn.Module):
    """kxk conv + ReLU (`models/common.py::ConvRelu`, float path)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: str = "bfloat16"):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv2d_same(x.to(dt), self.weight.to(dt), self.stride)
        return F.relu(_bias_add(y, self.bias))


class SepConvRelu(nn.Module):
    """Depthwise kxk + ReLU, pointwise 1x1 + ReLU
    (`models/common.py::SepConvRelu`, plain branch)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: str = "bfloat16"):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.dw_weight = nn.Parameter(
            torch.empty(in_features, 1, kernel, kernel))
        self.dw_bias = nn.Parameter(torch.zeros(in_features))
        self.pw_weight = nn.Parameter(
            torch.empty(features, in_features, 1, 1))
        self.pw_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv2d_same(x.to(dt), self.dw_weight.to(dt), self.stride,
                        groups=self.dw_weight.shape[0])
        y = F.relu(_bias_add(y, self.dw_bias))
        y = F.conv2d(y, self.pw_weight.to(dt))
        return F.relu(_bias_add(y, self.pw_bias))


class Conv1x1F32(nn.Module):
    """The final prediction 1x1 (Flax `nn.Conv(dtype=float32)`): float32
    conv of the upcast input, then the float32 bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bias_add(F.conv2d(x.float(), self.weight), self.bias)


class StageBranch(nn.Module):
    """One branch (conf or paf) of one stage, separable form:
    n x SepConvRelu(mid) + ConvRelu 1x1 (proj) + float32 1x1 (out)."""

    def __init__(self, in_features: int, out_features: int,
                 n_convs: int, kernel: int, proj_features: int,
                 mid_features: int = 128, dtype: str = "bfloat16"):
        super().__init__()
        c = in_features
        for i in range(n_convs):
            self.add_module(f"SepConvRelu_{i}", SepConvRelu(
                c, mid_features, kernel=kernel, dtype=dtype))
            c = mid_features
        self.ConvRelu_0 = ConvRelu(c, proj_features, kernel=1, dtype=dtype)
        self.Conv_0 = Conv1x1F32(proj_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class MultiStageHead(nn.Module):
    """The stage stack (`models/common.py::MultiStageHead`, separable
    heads): stage 1 reads the feature map; stage t > 1 reads
    concat(feature, conf_{t-1}, paf_{t-1}) in the compute dtype."""

    def __init__(self, in_features: int, n_heatmaps: int = 19,
                 n_pafs: int = 38, n_stages: int = 6, stage1_convs: int = 3,
                 stage1_kernel: int = 3, stage1_proj: int = 512,
                 refine_convs: int = 5, refine_kernel: int = 7,
                 refine_mid: int = 128, dtype: str = "bfloat16"):
        super().__init__()
        self.n_stages = n_stages
        for s in range(n_stages):
            if s == 0:
                kw = dict(in_features=in_features, n_convs=stage1_convs,
                          kernel=stage1_kernel, proj_features=stage1_proj)
            else:
                kw = dict(in_features=in_features + n_heatmaps + n_pafs,
                          mid_features=refine_mid, n_convs=refine_convs,
                          kernel=refine_kernel, proj_features=refine_mid)
            self.add_module(f"stage{s + 1}_conf",
                            StageBranch(out_features=n_heatmaps, dtype=dtype,
                                        **kw))
            self.add_module(f"stage{s + 1}_paf",
                            StageBranch(out_features=n_pafs, dtype=dtype,
                                        **kw))

    def forward(self, feature: torch.Tensor
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        confs: list[torch.Tensor] = []
        pafs: list[torch.Tensor] = []
        x = feature
        for s in range(self.n_stages):
            if s > 0:
                x = torch.cat([feature, confs[-1].to(feature.dtype),
                               pafs[-1].to(feature.dtype)], dim=1)
            confs.append(getattr(self, f"stage{s + 1}_conf")(x))
            pafs.append(getattr(self, f"stage{s + 1}_paf")(x))
        return confs, pafs


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax-equivalent random init: lecun-normal kernels, zero biases."""
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            lecun_normal_(p, generator)
        else:
            with torch.no_grad():
                p.zero_()
