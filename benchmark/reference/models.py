"""The pose networks as plain float32 PyTorch functions of a state_dict
(the parameter names of the served program's modules, which the benchmark
makes from the seed and hands to both sides), with TF32 off.

Each network is a file of its own, `reference/networks/<model name>.py`,
found by the configuration's `model.name`. It gives

    FAMILY                 the name of its decode family,
                           `reference/families/<name>.py` (no default),
                           which reads its maps, scales its heads and
                           groups people
    forward(x, sd, model, r) -> tuple of maps, NCHW float32, as its family
                           reads them; `model` the configuration's model
                           section, `r` the rounding of what the network
                           stores
    heads(model)           the module prefixes of the prediction convs
                           whose outputs its family's head rule scales
    predictions(model)     the module prefixes of every prediction conv
                           (their biases start at zero)
    SKELETON               the name of the skeleton file its family reads,
                           `reference/skeletons/<name>.json`
    OTHER_STD              optional: the standard deviation of parameters
                           that are neither conv kernels nor biases (a
                           PReLU slope); without it they take the biases'
    CPU_CUT                optional: model keys, beside the input size,
                           that a CPU test may cut to a value the network
                           accepts

and builds on the pieces here: `conv`, `sep`, `branch`.

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
import importlib
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


def family(net: types.ModuleType) -> types.ModuleType:
    """The decode family `reference/families/<net.FAMILY>.py` of a loaded
    network file."""
    name = getattr(net, "FAMILY", None)
    if name is None:
        raise AttributeError(f"{net.__file__} names no FAMILY")
    return importlib.import_module(f"reference.families.{name}")


@torch.no_grad()
def forward(model: dict, sd: dict, images: torch.Tensor, bf16: bool = False,
            r=None) -> tuple:
    """uint8 (B, H, W, 3) -> the maps of the network `model["name"]` (its
    family's outputs, each (B, h, w, channels) float32) on the images'
    device; `bf16` rounds what a bf16 network stores (module docstring),
    `r`, where given, rounds it another way."""
    x = images.permute(0, 3, 1, 2).float() / 255.0 - 0.5
    if r is None:
        r = _bf16 if bf16 else _keep
    with no_tf32():
        maps = network(model["name"]).forward(x, sd, model, r)
    return tuple(m.permute(0, 2, 3, 1) for m in maps)
