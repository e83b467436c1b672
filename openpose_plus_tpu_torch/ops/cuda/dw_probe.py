"""The depthwise probe: two CUDA kernels + their plain PyTorch versions.

Replaces the TPU probe `scripts/profile_pallas_dw.py :: run` and its two
bodies; kernel source `openpose_plus_tpu_torch/csrc/sepconv.cu`. The DW
body runs the fused separable conv's loader and depthwise stage (the bf16
haloed tile by double-buffered TMA loads, or cp.async where C % 8 != 0; f32
taps; 16-byte stores), so its time is that stage's own on the card.

- `dw3x3_relu` (`dw_kernel`): the 9-tap depthwise of (B, H, W, C) bf16 x
  with SAME zero padding, f32 taps, f32 ReLU, one bf16 rounding, no bias.
- `copy_bias` (`copy_kernel`): `x + dwk[0, :]` per channel, in bf16; the
  same I/O with no compute, so its time is the traffic floor the DW-only
  kernel is held against.

dwk is (9, C) bf16. Each wrapper calls its op (`openpose_plus_tpu_torch::
dw3x3_relu`, `::copy_bias`, torch.library): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises; each launch adds one
to the wrapper's module-level count (`dw3x3_relu_launches`,
`copy_bias_launches`).
"""

from __future__ import annotations

import torch

from openpose_plus_tpu_torch.ops import NAMESPACE, check_device
from openpose_plus_tpu_torch.ops.cuda.sepconv import _aligned, dw_taps

dw3x3_relu_launches = 0   # kernel launches in this process
copy_bias_launches = 0


def dw3x3_relu_plain(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return torch.relu(dw_taps(x, dwk)).to(torch.bfloat16)


def copy_bias_plain(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16) + dwk[0].to(torch.bfloat16)


def _check(name: str, x: torch.Tensor, dwk: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(dwk.shape) != (9, x.shape[-1]):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dwk "
                         f"{tuple(dwk.shape)} are not (B, H, W, C), (9, C)")
    if dwk.device != x.device:
        raise ValueError(f"{name}: x and dwk must be on one device")
    if (x.dtype, dwk.dtype) != (torch.bfloat16,) * 2 or not (
            x.is_contiguous() and dwk.is_contiguous()):
        raise ValueError(f"{name}: x and dwk must be contiguous bf16")


def _launch(name: str, x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    from openpose_plus_tpu_torch.ops.cuda import build

    _check(name, x, dwk)
    y = torch.empty_like(x)
    if not y.numel():
        return y
    lib = build.load()
    b, h, w, c = x.shape
    x, dwk = _aligned(x, 16), _aligned(dwk, 16)
    err = getattr(lib, f"{name}_launch")(
        x.data_ptr(), dwk.data_ptr(), y.data_ptr(), b, h, w, c,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, f"{name}_launch")
    return y


def _fake(x, dwk):
    return x.new_empty(x.shape, dtype=torch.bfloat16)


@torch.library.custom_op(f"{NAMESPACE}::dw3x3_relu", mutates_args=(),
                         device_types="cpu",
                         schema="(Tensor x, Tensor dwk) -> Tensor")
def _dw3x3_relu_op(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return dw3x3_relu_plain(x, dwk)


@_dw3x3_relu_op.register_kernel("cuda")
def _(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    global dw3x3_relu_launches
    y = _launch("dw3x3_relu", x, dwk)
    dw3x3_relu_launches += bool(y.numel())
    return y


@torch.library.custom_op(f"{NAMESPACE}::copy_bias", mutates_args=(),
                         device_types="cpu",
                         schema="(Tensor x, Tensor dwk) -> Tensor")
def _copy_bias_op(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return copy_bias_plain(x, dwk)


@_copy_bias_op.register_kernel("cuda")
def _(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    global copy_bias_launches
    y = _launch("copy_bias", x, dwk)
    copy_bias_launches += bool(y.numel())
    return y


_dw3x3_relu_op.register_fake(_fake)
_copy_bias_op.register_fake(_fake)


def dw3x3_relu(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Dispatching wrapper (the op); same contract as `dw3x3_relu_plain`."""
    check_device("dw3x3_relu", x)
    return _dw3x3_relu_op(x, dwk)


def copy_bias(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Dispatching wrapper (the op); same contract as `copy_bias_plain`."""
    check_device("copy_bias", x)
    return _copy_bias_op(x, dwk)
