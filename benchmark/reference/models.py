"""The pose networks as plain float32 PyTorch functions of a state_dict
(the parameter names of the served program's modules, which the benchmark
makes from the seed and hands to both sides), with TF32 off.

Each network is a file of its own, `reference/networks/<model name>.py`,
found by the configuration's `model.name`. It gives

    forward(x, sd, n_stages, r) -> (conf, paf)   NCHW float32, `r` the
                                  rounding of what the network stores
    heads(n_stages)        the module prefixes of the last heatmap and the
                           last PAF prediction (the heads `weights` scales)
    predictions(n_stages)  the module prefixes of every prediction conv
                           (their biases start at zero)
    SKELETON               the name of its skeleton,
                           `reference/skeletons/<name>.json`
    OTHER_STD              optional: the standard deviation of parameters
                           that are neither conv kernels nor biases (a
                           PReLU slope); without it they take the biases'

and builds on the pieces here: `conv`, `sep`, `branch`, `stages`.

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
import importlib.util
import os
import types

import torch
import torch.nn.functional as F

NETWORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "networks")


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


def stage_heads(n_stages: int) -> tuple[str, str]:
    """The (conf, paf) prediction prefixes of stage `n_stages` of
    `stages`."""
    return (f"stages.stage{n_stages}_conf.Conv_0",
            f"stages.stage{n_stages}_paf.Conv_0")


def stage_predictions(n_stages: int) -> list[str]:
    """Every prediction prefix of `stages`."""
    return [p for s in range(1, n_stages + 1) for p in stage_heads(s)]


def network(name: str) -> types.ModuleType:
    """The network file `reference/networks/<name>.py`, loaded."""
    path = os.path.join(NETWORK_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reference network {name!r}: {path} "
                                "does not exist")
    spec = importlib.util.spec_from_file_location(
        f"reference_network_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@torch.no_grad()
def forward(arch: str, sd: dict, images: torch.Tensor, n_stages: int,
            bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) -> the network `arch`'s last (conf, paf), (B,
    H/8, W/8, heatmaps / PAF channels) float32, on the images' device;
    `bf16` rounds what a bf16 network stores (module docstring)."""
    x = images.permute(0, 3, 1, 2).float() / 255.0 - 0.5
    with no_tf32():
        conf, paf = network(arch).forward(x, sd, n_stages,
                                          _bf16 if bf16 else _keep)
    return conf.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)
