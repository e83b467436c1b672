"""Fused depthwise-separable conv: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `openpose_plus_tpu/ops/pallas/sepconv.py ::
fused_sepconv` (body `_sepconv_kernel`); kernel source
`openpose_plus_tpu_torch/csrc/sepconv.cu`. The kernel keeps the depthwise
result in shared memory instead of a round trip through device memory. A
block owns an 8x8 pixel tile and all of F up to 192 (F = 384: three
128-wide tiles on 128-pixel tiles); it streams the input channels in chunks
of 32 through an asynchronous pipeline (TMA boxes for the haloed tile, the
taps and the weight rows; where C % 8 != 0 the tile comes by 16-byte
cp.async and each pixel's span is shifted into place; the tile stays bf16
in shared memory), runs the depthwise taps in f32 on the CUDA cores and the
pointwise product on the tensor cores (mma.sync bf16 -> f32), and stores 16
bytes a thread. Design notes and H100 numbers in the source and PERF.md.

    y = relu(bf16(pw1x1(relu(bf16(dw3x3(x)) + b_dw))) + b_pw)

stride 1, SAME padding, bf16 in and out, f32 accumulation. The JAX
package's layouts: x (B, H, W, C), dw_kernel (3, 3, 1, C), pw_kernel
(1, 1, C, F); weights of any float type are cast to bf16 per call.

`fused_sepconv` calls the op `openpose_plus_tpu_torch::fused_sepconv`
(torch.library), which dispatches on the device of `x`: a CPU tensor takes
`fused_sepconv_plain`, a CUDA tensor launches the kernel or raises. Each
launch adds one to the module-level `launches` count. There is no backward
(the TPU kernel has no VJP either): the wrapper raises when grad mode is on
and an input requires grad, so training keeps the unfused layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openpose_plus_tpu_torch.ops import NAMESPACE, check_device

launches = 0   # kernel launches in this process (see module docstring)


def _bf16_weights(x: torch.Tensor, dw_kernel: torch.Tensor,
                  dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                  pw_bias: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Checks the shapes; returns dwk (9, C), dwb (C,), pwk (C, F), pwb (F,)
    as contiguous bf16 (no copy for weights that already are)."""
    if x.dim() != 4:
        raise ValueError(f"fused_sepconv: x {tuple(x.shape)} is not "
                         "(B, H, W, C)")
    c = x.shape[-1]
    f = pw_kernel.shape[-1]
    if tuple(dw_kernel.shape) != (3, 3, 1, c):
        raise ValueError(f"fused_sepconv: dw_kernel {tuple(dw_kernel.shape)}"
                         f" is not (3, 3, 1, {c}) (3x3 depthwise only)")
    if (tuple(pw_kernel.shape) != (1, 1, c, f)
            or tuple(dw_bias.shape) != (c,) or tuple(pw_bias.shape) != (f,)):
        raise ValueError(
            f"fused_sepconv: pw_kernel {tuple(pw_kernel.shape)}, dw_bias "
            f"{tuple(dw_bias.shape)}, pw_bias {tuple(pw_bias.shape)} do not "
            f"fit (1, 1, {c}, F), ({c},), (F,)")
    bf = torch.bfloat16
    return (dw_kernel.reshape(9, c).to(bf).contiguous(),
            dw_bias.to(bf).contiguous(),
            pw_kernel.reshape(c, f).to(bf).contiguous(),
            pw_bias.to(bf).contiguous())


def dw_taps(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """f32 sum of the 9 depthwise taps of (B, H, W, C) x with SAME zero
    padding, dy-major, as `acc + tap * w` (each product rounded before its
    add). dwk is (9, C)."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    wk = dwk.to(torch.bfloat16).float()
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * wk[dy * 3 + dx]
    return acc


def fused_sepconv_plain(x: torch.Tensor, dw_kernel: torch.Tensor,
                        dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                        pw_bias: torch.Tensor) -> torch.Tensor:
    """The reference body's order: the f32 tap sum rounded to bf16, the
    bias as a bf16 add, ReLU; the PW contraction in float64 (no TF32 flag
    reaches it), rounded once to f32 and then to bf16, the bias as a bf16
    add, ReLU. Returns (B, H, W, F) bf16."""
    dwk, dwb, pwk, pwb = _bf16_weights(x, dw_kernel, dw_bias, pw_kernel,
                                       pw_bias)
    b, h, w, c = x.shape
    dw = torch.relu(dw_taps(x, dwk).to(torch.bfloat16) + dwb)
    y = (dw.reshape(-1, c).double() @ pwk.double()).float()
    y = torch.relu(y.to(torch.bfloat16) + pwb)
    return y.reshape(b, h, w, pwk.shape[1])


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """t, or a copy of it where its data does not start on an `nbytes`
    boundary (a view at an odd offset): the kernels' copies need it."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


@torch.library.custom_op(
    f"{NAMESPACE}::fused_sepconv", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor dw_kernel, Tensor dw_bias, Tensor pw_kernel, "
           "Tensor pw_bias) -> Tensor")
def _fused_sepconv_op(x: torch.Tensor, dw_kernel: torch.Tensor,
                      dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                      pw_bias: torch.Tensor) -> torch.Tensor:
    return fused_sepconv_plain(x, dw_kernel, dw_bias, pw_kernel, pw_bias)


@_fused_sepconv_op.register_fake
def _(x, dw_kernel, dw_bias, pw_kernel, pw_bias):
    _bf16_weights(x, dw_kernel, dw_bias, pw_kernel, pw_bias)   # the checks
    return x.new_empty((*x.shape[:3], pw_kernel.shape[-1]),
                       dtype=torch.bfloat16)


@_fused_sepconv_op.register_kernel("cuda")
def _fused_sepconv_cuda(x: torch.Tensor, dw_kernel: torch.Tensor,
                        dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                        pw_bias: torch.Tensor) -> torch.Tensor:
    args = (x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    if any(t.device != x.device for t in args):
        raise ValueError("fused_sepconv: all tensors must be on one device")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_sepconv kernel takes bf16 x, got {x.dtype}")
    dwk, dwb, pwk, pwb = (_aligned(t, 16) for t in _bf16_weights(*args))
    if not x.is_contiguous():
        raise ValueError("fused_sepconv: x must be contiguous (B, H, W, C); "
                         "an NCHW activation must be channels-last")
    x = _aligned(x, 16)
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    b, h, w, c = x.shape
    f = pwk.shape[1]
    y = torch.empty((b, h, w, f), dtype=torch.bfloat16, device=x.device)
    if b * h * w * f == 0:       # nothing to compute: no launch
        return y
    lib = build.load()
    err = lib.fused_sepconv_launch(
        x.data_ptr(), dwk.data_ptr(), dwb.data_ptr(), pwk.data_ptr(),
        pwb.data_ptr(), y.data_ptr(), b, h, w, c, f, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "fused_sepconv_launch")
    launches += 1
    return y


def fused_sepconv(x: torch.Tensor, dw_kernel: torch.Tensor,
                  dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                  pw_bias: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Dispatching wrapper (the op); same contract as `fused_sepconv_plain`.
    On the card x must be bf16 and NHWC-contiguous (the NCHW channels-last
    activations of the port's model, permuted to NHWC, are)."""
    args = (x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "fused_sepconv has no backward (nor has the TPU kernel): call it "
            "under torch.no_grad() or inference_mode; train with "
            "fused_inference=False")
    if stride != 1:
        raise ValueError(f"fused_sepconv is stride 1 only, got {stride}; "
                         "strided layers run the unfused pair")
    check_device("fused_sepconv", x)
    return _fused_sepconv_op(*args)
