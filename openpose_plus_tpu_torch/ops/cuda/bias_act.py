"""A conv's epilogue (bias, then ReLU or Caffe's per-channel PReLU, and an
optional second store at a channel offset of a wider buffer): CUDA kernel
beside the plain PyTorch version.

Replaces no Pallas kernel: in the JAX package a conv's bias and activation
are elementwise consumers that XLA fuses into the conv. The port runs each
bf16 conv through cuDNN without bias; after it, the bias add, the ReLU or
PReLU and a BODY_25 dense block's concat were separate PyTorch passes, each
reading and writing the whole activation (the bias add's (1, C, 1, 1)
broadcast and PReLU's per-channel slope over a channels-last tensor in
PyTorch's non-vectorised elementwise kernel). Kernel source
`openpose_plus_tpu_torch/csrc/bias_act.cu`: one pass, bound on the H100 by
its bytes (the conv output read once, the result written once, and once
more into a dense block's buffer), computing `bias_act_plain` bit for bit.

`bias_act` calls the op `openpose_plus_tpu_torch::bias_act` (torch.library),
which dispatches on the device of `y`: a CPU tensor takes `bias_act_plain`,
a CUDA tensor launches the kernel or raises. Each launch adds one to the
module-level `launches` count; each call adds one to the tracer's
`ops.bias_act` counter. The kernel has no backward: the models call the op
with grad disabled and `bias_act_plain` with grad enabled
(`models.common.conv_epilogue`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openpose_plus_tpu_torch.ops import NAMESPACE, check_device
from openpose_plus_tpu_torch.utils.tracer import count

DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # the launcher's codes

launches = 0   # kernel launches in this process (see module docstring)


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor,
                   slope: torch.Tensor | None = None,
                   into: torch.Tensor | None = None,
                   offset: int = 0) -> torch.Tensor:
    """y (B, C, H, W) in its compute dtype, bias (C,) and slope (C,)
    float32 -> relu(y + bias) (slope None) or prelu(y + bias, slope), the
    bias and slope cast to y's dtype and the sum rounded to it first; also
    copied to channels [offset, offset + C) of `into` when given."""
    t = y + bias.to(y.dtype).view(1, -1, 1, 1)
    out = F.relu(t) if slope is None else F.prelu(t, slope.to(y.dtype))
    if into is not None:
        into[:, offset:offset + y.shape[1]] = out
    return out


@torch.library.custom_op(
    f"{NAMESPACE}::bias_act", mutates_args=("into",), device_types="cpu",
    schema="(Tensor y, Tensor bias, Tensor? slope, Tensor(a!)? into, "
           "int offset) -> Tensor")
def _bias_act_op(y: torch.Tensor, bias: torch.Tensor,
                 slope: torch.Tensor | None, into: torch.Tensor | None,
                 offset: int) -> torch.Tensor:
    return bias_act_plain(y, bias, slope, into, offset)


@_bias_act_op.register_fake
def _(y, bias, slope, into, offset):
    return torch.empty_like(y)


def _check_cuda(y, bias, slope, into, offset) -> None:
    tensors = [t for t in (bias, slope, into) if t is not None]
    if any(t.device != y.device for t in tensors):
        raise ValueError("bias_act: all tensors must be on one device")
    if y.dim() != 4 or y.dtype not in DTYPES:
        raise ValueError(f"bias_act kernel takes a 4-D bf16 or float32 y, "
                         f"got {tuple(y.shape)} {y.dtype}")
    c = y.shape[1]
    for name, t in (("bias", bias), ("slope", slope)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (
                c,) or not t.is_contiguous()):
            raise ValueError(f"bias_act kernel takes a contiguous float32 "
                             f"{name} of ({c},), got {tuple(t.shape)} "
                             f"{t.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bias_act kernel takes a channels-last y")
    if into is not None and (
            into.dim() != 4 or into.dtype != y.dtype
            or not into.is_contiguous(memory_format=torch.channels_last)
            or into.shape[0] != y.shape[0] or into.shape[2:] != y.shape[2:]
            or not 0 <= offset <= into.shape[1] - c):
        raise ValueError(
            f"bias_act: into {tuple(into.shape)} {into.dtype} is not a "
            f"channels-last {y.dtype} buffer of y's {tuple(y.shape)} pixels "
            f"with channels [{offset}, {offset + c})")


@_bias_act_op.register_kernel("cuda")
def _bias_act_cuda(y: torch.Tensor, bias: torch.Tensor,
                   slope: torch.Tensor | None, into: torch.Tensor | None,
                   offset: int) -> torch.Tensor:
    _check_cuda(y, bias, slope, into, offset)
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    out = torch.empty_like(y)
    b, c, h, w = y.shape
    if y.numel() == 0:
        return out
    lib = build.load()
    err = lib.bias_act_launch(
        y.data_ptr(), bias.data_ptr(),
        None if slope is None else slope.data_ptr(),
        out.data_ptr(), None if into is None else into.data_ptr(),
        b * h * w, c, 0 if into is None else into.shape[1], offset,
        DTYPES[y.dtype], y.device.index, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(lib, err, "bias_act_launch")
    launches += 1
    return out


def bias_act(y: torch.Tensor, bias: torch.Tensor,
             slope: torch.Tensor | None = None,
             into: torch.Tensor | None = None,
             offset: int = 0) -> torch.Tensor:
    """Dispatching wrapper (the op): `bias_act_plain(y, bias, slope, into,
    offset)`. On the card y and `into` are channels-last, of one dtype
    (bf16 or float32), bias and slope contiguous float32."""
    check_device("bias_act", y)
    count("ops.bias_act")
    return _bias_act_op(y, bias, slope, into, offset)
