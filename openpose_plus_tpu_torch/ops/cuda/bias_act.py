"""A conv's epilogue (bias, then ReLU or Caffe's per-channel PReLU, and an
optional second store at a channel offset of a wider buffer or an optional
2x2 stride-2 max pool): CUDA kernel beside the plain PyTorch version.

Replaces no Pallas kernel: in the JAX package a conv's bias and activation
are elementwise consumers that XLA fuses into the conv. The port runs each
bf16 conv through cuDNN without bias; after it, the bias add, the ReLU or
PReLU and a BODY_25 dense block's concat were separate PyTorch passes, each
reading and writing the whole activation (the bias add's (1, C, 1, 1)
broadcast and PReLU's per-channel slope over a channels-last tensor in
PyTorch's non-vectorised elementwise kernel), and a VGG block's max pool
read the full-size activation once more. Kernel source
`openpose_plus_tpu_torch/csrc/bias_act.cu`: one pass, bound on the H100 by
its bytes (the conv output read once, the result written once, and once
more into a dense block's buffer; pooled, only the pooled plane written),
computing `bias_act_plain` bit for bit.

`bias_act` calls the op `openpose_plus_tpu_torch::bias_act` (torch.library),
which dispatches on the device of `y`: a CPU tensor takes `bias_act_plain`,
a CUDA tensor launches the kernel or raises. Each launch adds one to the
module-level `launches` count; each call adds one to the tracer's
`ops.bias_act` counter, and a pooled call one to `ops.bias_act_pool` as
well. The kernel has no backward: the models call the op
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


def _check_pool(y: torch.Tensor, into: torch.Tensor | None,
                pool: bool) -> None:
    if not pool:
        return
    if into is not None:
        raise ValueError("bias_act: a pooled epilogue takes no buffer "
                         "(`into`)")
    if y.dim() != 4 or min(y.shape[2:]) < 2:
        raise ValueError(f"bias_act: a 2x2 pool takes a 4-D y of at least "
                         f"2 rows and columns, got {tuple(y.shape)}")


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor,
                   slope: torch.Tensor | None = None,
                   into: torch.Tensor | None = None,
                   offset: int = 0, pool: bool = False) -> torch.Tensor:
    """y (B, C, H, W) in its compute dtype, bias (C,) and slope (C,)
    float32 -> relu(y + bias) (slope None) or prelu(y + bias, slope), the
    bias and slope cast to y's dtype and the sum rounded to it first; also
    copied to channels [offset, offset + C) of `into` when given. With
    `pool` (no `into`), that result's 2x2 stride-2 max pool, (B, C, H // 2,
    W // 2): `F.max_pool2d(.., 2, 2)`."""
    _check_pool(y, into, pool)
    t = y + bias.to(y.dtype).view(1, -1, 1, 1)
    out = F.relu(t) if slope is None else F.prelu(t, slope.to(y.dtype))
    if into is not None:
        into[:, offset:offset + y.shape[1]] = out
    return F.max_pool2d(out, 2, 2) if pool else out


def _pooled(y: torch.Tensor) -> torch.Tensor:
    """The pooled op's output: (B, C, H // 2, W // 2) channels-last."""
    b, c, h, w = y.shape
    return torch.empty((b, c, h // 2, w // 2), dtype=y.dtype,
                       device=y.device, memory_format=torch.channels_last)


@torch.library.custom_op(
    f"{NAMESPACE}::bias_act", mutates_args=("into",), device_types="cpu",
    schema="(Tensor y, Tensor bias, Tensor? slope, Tensor(a!)? into, "
           "int offset, bool pool=False) -> Tensor")
def _bias_act_op(y: torch.Tensor, bias: torch.Tensor,
                 slope: torch.Tensor | None, into: torch.Tensor | None,
                 offset: int, pool: bool = False) -> torch.Tensor:
    out = bias_act_plain(y, bias, slope, into, offset, pool)
    return _pooled(y).copy_(out) if pool else out


@_bias_act_op.register_fake
def _(y, bias, slope, into, offset, pool=False):
    _check_pool(y, into, pool)
    return _pooled(y) if pool else torch.empty_like(y)


def _check_cuda(y, bias, slope, into, offset, pool) -> None:
    _check_pool(y, into, pool)
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
                   offset: int, pool: bool = False) -> torch.Tensor:
    _check_cuda(y, bias, slope, into, offset, pool)
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    out = _pooled(y) if pool else torch.empty_like(y)
    b, c, h, w = y.shape
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.bias_act_launch(
        y.data_ptr(), bias.data_ptr(),
        None if slope is None else slope.data_ptr(),
        out.data_ptr(), None if into is None else into.data_ptr(),
        b * h * w, c, 0 if into is None else into.shape[1], offset, h, w,
        int(pool), DTYPES[y.dtype], y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    build.check(lib, err, "bias_act_launch")
    launches += 1
    return out


def bias_act(y: torch.Tensor, bias: torch.Tensor,
             slope: torch.Tensor | None = None,
             into: torch.Tensor | None = None,
             offset: int = 0, pool: bool = False) -> torch.Tensor:
    """Dispatching wrapper (the op): `bias_act_plain(y, bias, slope, into,
    offset, pool)`, pooled channels-last. On the card y and `into` are
    channels-last, of one dtype (bf16 or float32), bias and slope
    contiguous float32."""
    check_device("bias_act", y)
    count("ops.bias_act")
    if pool:
        count("ops.bias_act_pool")
    return _bias_act_op(y, bias, slope, into, offset, pool)
