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

dwk is (9, C) bf16. A CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises; each launch adds one to the wrapper's
module-level count (`dw3x3_relu_launches`, `copy_bias_launches`).
"""

from __future__ import annotations

import torch

from openpose_plus_tpu_torch.ops.cuda.sepconv import _aligned, dw_taps

dw3x3_relu_launches = 0   # kernel launches in this process
copy_bias_launches = 0


def dw3x3_relu_plain(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return torch.relu(dw_taps(x, dwk)).to(torch.bfloat16)


def copy_bias_plain(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16) + dwk[0].to(torch.bfloat16)


def _check(name: str, x: torch.Tensor, dwk: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or tuple(dwk.shape) != (9, x.shape[-1]):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dwk "
                         f"{tuple(dwk.shape)} are not (B, H, W, C), (9, C)")
    if dwk.device != x.device:
        raise ValueError(f"{name}: x and dwk must be on one device")
    if (x.dtype, dwk.dtype) != (torch.bfloat16,) * 2 or not (
            x.is_contiguous() and dwk.is_contiguous()):
        raise ValueError(f"{name}: x and dwk must be contiguous bf16")


def _launch(name: str, x: torch.Tensor, dwk: torch.Tensor,
            y: torch.Tensor) -> None:
    from openpose_plus_tpu_torch.ops.cuda import build

    lib = build.load()
    b, h, w, c = x.shape
    x, dwk = _aligned(x, 16), _aligned(dwk, 16)
    err = getattr(lib, f"{name}_launch")(
        x.data_ptr(), dwk.data_ptr(), y.data_ptr(), b, h, w, c,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, f"{name}_launch")


def dw3x3_relu(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Dispatching wrapper; same contract as `dw3x3_relu_plain`."""
    global dw3x3_relu_launches
    if x.device.type == "cpu":
        return dw3x3_relu_plain(x, dwk)
    _check("dw3x3_relu", x, dwk)
    y = torch.empty_like(x)
    if y.numel():
        _launch("dw3x3_relu", x, dwk, y)
        dw3x3_relu_launches += 1
    return y


def copy_bias(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Dispatching wrapper; same contract as `copy_bias_plain`."""
    global copy_bias_launches
    if x.device.type == "cpu":
        return copy_bias_plain(x, dwk)
    _check("copy_bias", x, dwk)
    y = torch.empty_like(x)
    if y.numel():
        _launch("copy_bias", x, dwk, y)
        copy_bias_launches += 1
    return y
