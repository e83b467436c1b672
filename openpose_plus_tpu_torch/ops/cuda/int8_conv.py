"""Calibrated int8 convolution: CUDA kernels + plain PyTorch versions.

The quantized mode of `openpose_plus_tpu/models/common.py::_int8_conv`,
which the JAX package leaves to XLA (`jax.lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`, `common.py:129`); no Pallas kernel.
Kernel source `openpose_plus_tpu_torch/csrc/int8_conv.cu`, two kernels:

- `int8_conv`: one conv layer in one launch, NHWC. An implicit GEMM on the
  int8 tensor cores (`wgmma` m64nNk32 s8 x s8 -> s32, both operands brought
  to shared memory by TMA: the input through an im2col tensor map, whose
  zero fill is the SAME padding): M = B*Ho*Wo pixels, N = Cout, K =
  kh*kw*Cin_p (Cin padded to a multiple of 64 per tap: zero channels in
  the input, written by `quantize_act` or else appended by the wrapper,
  zeros in the packed weights), in tiles of `tile_plan(...)`; then the
  float32 epilogue

      y = relu(fl(fl(float(acc) * rescale[c]) + bias[c]))

  (two roundings, no FMA) and either `y` rounded to bf16, or y
  requantized at s_out: rint(clip(y / s_out, -1, 1) * 127) as int8, a
  true division. `rescale = s_in / (127 * 127) * wmax`, per output
  channel, comes from `rescale` below in the reference's op order.
- `quantize_act`: a bf16 tensor to int8 at a calibrated scale,
  rint(clip(x / s, -1, 1) * 127); the float inputs of the int8 convs
  input) go through it once, as in the reference. It writes the last axis
  (channels) padded with zeros to `padded(C)`, the layout the conv reads,
  so no layer copies its input to pad it.

Both are bit-equal to their plain versions: the int32 sums are exact, and
the epilogues are the same correctly rounded float32 operations. The plain
conv takes the products in float64 (exact: |acc| <= 127^2 * 7*7*576 <
2^53), rounds to int32 and runs the same epilogue as separate PyTorch ops.

`int8_conv` and `quantize_act` call the ops `openpose_plus_tpu_torch::
int8_conv` and `::quantize_act` (torch.library), which dispatch on the
device of their input: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. Each launch adds one to `launches` (the conv) or
`quantize_launches`. The scales stay on the device (0-d float32 tensors
read by the kernels): no host synchronisation, and no division by a host
scalar, which PyTorch on the card would turn into a multiply by the
reciprocal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openpose_plus_tpu_torch.ops import NAMESPACE, check_device, device_cache

launches = 0            # int8_conv kernel launches in this process
quantize_launches = 0   # quantize_act kernel launches in this process

K_STEP = 64             # Cin is padded to a multiple of this, per tap
SCALE_FLOOR = 1e-6      # max(scale, 1e-6), as the reference
WEIGHT_FLOOR = 1e-12

# (pixels, channels) a block: csrc/int8_conv.cu `launch_plan`'s instances
PLANS = ((192, 128), (128, 64))
CORNER = 128            # a 4-D im2col map's corners lie in [-128, 127]
MAX_BLOCKS = 2 ** 31 - 1


@device_cache
def device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor on `device` (dividing by it is a true division
    everywhere), made once per device: a forward then copies nothing from
    the host and can be captured in a CUDA graph."""
    with torch.inference_mode(False):      # a normal tensor, reused anywhere
        return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_weight(weight: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel weights (`common.py::quantize_weight`):
    (Cout, Cin, kh, kw) float -> (int8 of the same shape, wmax (Cout,)
    float32); wmax = max(max |k| over (Cin, kh, kw), 1e-12), qw =
    round(k / wmax * 127)."""
    k = weight.float()
    wmax = k.abs().amax(dim=(1, 2, 3)).clamp_min(WEIGHT_FLOOR)
    qw = torch.round(k / wmax.view(-1, 1, 1, 1) * 127.0)
    return qw.to(torch.int8), wmax


def padded(channels: int) -> int:
    """`channels` rounded up to a multiple of K_STEP: the channel count
    of the conv's input rows and packed weights."""
    return -(-channels // K_STEP) * K_STEP


def pack_weight(qw: torch.Tensor) -> torch.Tensor:
    """int8 (Cout, Cin, kh, kw) -> the kernels' (Cout, kh * kw * Cin_p)
    layout: tap-major, channels innermost, Cin zero-padded to a multiple
    of K_STEP."""
    cout, cin, kh, kw = qw.shape
    cin_p = padded(cin)
    packed = torch.zeros((cout, kh, kw, cin_p), dtype=torch.int8,
                         device=qw.device)
    packed[..., :cin] = qw.permute(0, 2, 3, 1)
    return packed.reshape(cout, kh * kw * cin_p)


def rescale(s_in: torch.Tensor, wmax: torch.Tensor) -> torch.Tensor:
    """`s_in / (127 * 127) * wmax` in float32, the reference's order;
    s_in is the (already floored) 0-d input scale."""
    return s_in.float() / device_scalar(127.0 * 127.0, wmax.device) * wmax


def quantize_act_plain(x: torch.Tensor, scale: torch.Tensor
                       ) -> torch.Tensor:
    """`common.py::quantize_act`: round(clip(x / s, -1, 1) * 127) as int8,
    s = max(scale, 1e-6); round half to even; the last axis (C) then
    extended to `padded(C)` with zeros."""
    s = scale.float().clamp_min(SCALE_FLOOR)
    q = torch.round(torch.clamp(x.float() / s, -1.0, 1.0)
                    * 127.0).to(torch.int8)
    if x.dim() > 0 and padded(x.shape[-1]) != x.shape[-1]:
        q = F.pad(q, (0, padded(x.shape[-1]) - x.shape[-1]))
    return q


def _geometry(q: torch.Tensor, w_packed: torch.Tensor, kernel: int,
              stride: int, pads: tuple[int, int], where: str) -> tuple:
    """Checks the shapes; returns (B, H, W, Cin, Cout, Ho, Wo)."""
    if q.dim() != 4:
        raise ValueError(f"{where}: q {tuple(q.shape)} is not (B, H, W, C)")
    b, h, w, cin = q.shape
    cin_p = padded(cin)
    if w_packed.dim() != 2 or w_packed.shape[1] != kernel * kernel * cin_p:
        raise ValueError(f"{where}: packed weights {tuple(w_packed.shape)} "
                         f"are not (Cout, {kernel * kernel * cin_p}) for a "
                         f"{kernel}x{kernel} conv over {cin} channels")
    if stride not in (1, 2) or kernel not in (1, 3, 5, 7):
        raise ValueError(f"{where}: stride {stride}, kernel {kernel}: the "
                         "kernel takes stride 1 or 2, kernel 1, 3, 5 or 7")
    top, left = pads
    if not (0 <= top < kernel and 0 <= left < kernel):
        raise ValueError(f"{where}: pads {pads} for a {kernel}x{kernel} "
                         "conv")
    return b, h, w, cin, w_packed.shape[0], -(-h // stride), -(-w // stride)


def tile_plan(batch: int, h: int, w: int, cin_p: int, cout: int,
              kernel: int, stride: int, pads: tuple[int, int]
              ) -> tuple[int, int]:
    """The int8 conv kernel's tile for one layer shape: (block_m, block_n),
    the output pixels and channels a block owns. Cin_p is the padded input
    channel count the kernel reads. Raises ValueError on a shape the kernel's
    launcher refuses.

    Up to Cout 64: 128 x 64 blocks, two resident on an SM, so one block's
    loads and epilogue overlap the other's products. Above: 192 x 128
    blocks alone on an SM, 128-wide channel tiles (the wgmma's N) and three
    consumer warpgroups, which keep the tensor cores busier than two. At M
    = 8 * 46 * 54 and Cout 128 (VGG19's 7x7 layers) that is 104 blocks, one
    wave of the H100's 132 SMs."""
    top, left = pads
    ho, wo = -(-h // stride), -(-w // stride)
    upper = ((ho - 1) * stride - top - (h - 1),
             (wo - 1) * stride - left - (w - 1))
    if (batch < 0 or h < 1 or w < 1 or cin_p < K_STEP or cin_p % K_STEP
            or cout < 1 or not 1 <= kernel <= 7 or stride not in (1, 2)
            or not (0 <= top < kernel and 0 <= left < kernel)
            or not all(-CORNER <= u < CORNER for u in upper)):
        raise ValueError(
            f"int8_conv: no tile plan for batch {batch}, {h}x{w}x{cin_p} -> "
            f"{cout}, kernel {kernel}, stride {stride}, pads {pads} (the "
            f"kernel takes Cin a multiple of {K_STEP}, kernel 1..7, stride 1 "
            "or 2, pads below the kernel)")
    bm, bn = plan = (128, 64) if cout <= 64 else (192, 128)
    blocks = -(-batch * ho * wo // bm) * -(-cout // bn)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"int8_conv: {blocks} blocks exceed the grid")
    return plan


def int8_conv_plain(q: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                    rescale: torch.Tensor, bias: torch.Tensor, stride: int,
                    pads: tuple[int, int],
                    s_out: torch.Tensor | None = None) -> torch.Tensor:
    """The quantized conv of `_int8_conv`, plain: q (B, H, W, Cin) int8,
    w_packed (Cout, kernel^2 * Cin_p) int8 (`pack_weight`), rescale and
    bias (Cout,) float32, SAME pads (top, left) -> (B, Ho, Wo, Cout): int8
    requantized at max(s_out, 1e-6) (s_out a 0-d float32 on q's device),
    or bf16 without it."""
    b, h, w, cin, cout, ho, wo = _geometry(q, w_packed, kernel, stride,
                                           pads, "int8_conv_plain")
    top, left = pads
    wk = w_packed.view(cout, kernel, kernel, -1)[..., :cin].double()
    bottom = max((ho - 1) * stride + kernel - h - top, 0)
    right = max((wo - 1) * stride + kernel - w - left, 0)
    xp = F.pad(q.double(), (0, 0, left, right, top, bottom))
    acc = torch.zeros((b, ho, wo, cout), dtype=torch.float64,
                      device=q.device)
    for ky in range(kernel):
        for kx in range(kernel):
            tap = xp[:, ky:ky + (ho - 1) * stride + 1:stride,
                     kx:kx + (wo - 1) * stride + 1:stride, :]
            acc += tap @ wk[:, ky, kx, :].t()
    y = acc.to(torch.int32).float() * rescale.float()
    y = torch.relu(y + bias.float())
    if s_out is None:
        return y.to(torch.bfloat16)
    s = s_out.float().clamp_min(SCALE_FLOOR)
    return torch.round(torch.clamp(y / s, -1.0, 1.0) * 127.0).to(torch.int8)


def _aligned(t: torch.Tensor, nbytes: int = 16) -> torch.Tensor:
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _scalar_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{what} must be one float32 on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


@torch.library.custom_op(
    f"{NAMESPACE}::int8_conv", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor w_packed, int kernel, Tensor rescale, Tensor "
           "bias, int stride, int[] pads, Tensor? s_out) -> Tensor")
def _int8_conv_op(q: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                  rescale: torch.Tensor, bias: torch.Tensor, stride: int,
                  pads: list[int], s_out: torch.Tensor | None
                  ) -> torch.Tensor:
    return int8_conv_plain(q, w_packed, kernel, rescale, bias, stride,
                           tuple(pads), s_out)


@_int8_conv_op.register_fake
def _(q, w_packed, kernel, rescale, bias, stride, pads, s_out):
    b, _, _, _, cout, ho, wo = _geometry(q, w_packed, kernel, stride,
                                         tuple(pads), "int8_conv")
    return q.new_empty((b, ho, wo, cout), dtype=torch.bfloat16
                       if s_out is None else torch.int8)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(q: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                    rescale: torch.Tensor, bias: torch.Tensor, stride: int,
                    pads: list[int], s_out: torch.Tensor | None
                    ) -> torch.Tensor:
    pads = tuple(pads)
    b, h, w, cin, cout, ho, wo = _geometry(q, w_packed, kernel, stride,
                                           pads, "int8_conv")
    if q.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise ValueError(f"int8_conv kernel takes int8 q and weights, got "
                         f"{q.dtype}, {w_packed.dtype}")
    for t, what in ((rescale, "rescale"), (bias, "bias")):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (cout,)):
            raise ValueError(f"int8_conv: {what} must be ({cout},) float32 "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if s_out is not None:
        _scalar_on(s_out, q.device, "int8_conv: s_out")
    if w_packed.device != q.device:
        raise ValueError("int8_conv: all tensors must be on one device")
    if not all(t.is_contiguous() for t in (q, w_packed, rescale, bias)):
        raise ValueError("int8_conv: inputs must be contiguous (an NCHW "
                         "activation must be channels-last)")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    out_dtype = torch.bfloat16 if s_out is None else torch.int8
    y = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=q.device)
    if y.numel() == 0:           # nothing to compute: no launch
        return y
    cin_p = padded(cin)
    if cin_p != cin:      # zero channels, as the packed weights hold there
        # (a quantize pass writes them itself; of the zoo's int8 chains only
        # the 32-channel second stem conv of VGG-tiny and hao28 pads here)
        q = F.pad(q, (0, cin_p - cin))
    plan = tile_plan(b, h, w, cin_p, cout, kernel, stride, pads)
    q, w_packed = _aligned(q), _aligned(w_packed)
    lib = build.load()
    err = lib.int8_conv_launch(
        q.data_ptr(), w_packed.data_ptr(), rescale.data_ptr(),
        bias.data_ptr(), None if s_out is None else s_out.data_ptr(),
        y.data_ptr(), b, h, w, cin_p, cout, ho, wo, kernel, stride,
        pads[0], pads[1], *plan, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "int8_conv_launch")
    launches += 1
    return y


def _quantized_shape(x: torch.Tensor) -> tuple[int, ...]:
    """quantize_act's output shape: the last axis padded to `padded(C)`."""
    return (*x.shape[:-1], padded(x.shape[-1])) if x.dim() > 0 else ()


@torch.library.custom_op(
    f"{NAMESPACE}::quantize_act", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor scale) -> Tensor")
def _quantize_act_op(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return quantize_act_plain(x, scale)


@_quantize_act_op.register_fake
def _(x, scale):
    return x.new_empty(_quantized_shape(x), dtype=torch.int8)


@_quantize_act_op.register_kernel("cuda")
def _quantize_act_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"quantize_act kernel takes contiguous bf16, got "
                         f"{x.dtype} (contiguous: {x.is_contiguous()})")
    _scalar_on(scale, x.device, "quantize_act: scale")
    from openpose_plus_tpu_torch.ops.cuda import build

    global quantize_launches
    c = x.shape[-1] if x.dim() > 0 else 1
    cp = padded(c) if x.dim() > 0 else c
    out = torch.empty(_quantized_shape(x), dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    if cp == c:                 # one flat pass
        rows, c = 1, x.numel()
        cp = c
    else:
        rows = x.numel() // c
    x = _aligned(x)
    lib = build.load()
    err = lib.quantize_act_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, c, cp,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "quantize_act_launch")
    quantize_launches += 1
    return out


def int8_conv(q: torch.Tensor, w_packed: torch.Tensor, kernel: int,
              rescale: torch.Tensor, bias: torch.Tensor, stride: int,
              pads: tuple[int, int],
              s_out: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatching wrapper (the op); same contract as `int8_conv_plain`. On
    the card every tensor must be contiguous and on q's device."""
    check_device("int8_conv", q)
    return _int8_conv_op(q, w_packed, kernel, rescale, bias, stride,
                         list(pads), s_out)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dispatching wrapper (the op) of `quantize_act_plain`; on the card x
    must be contiguous bf16 and scale one float32 on its device."""
    check_device("quantize_act", x)
    return _quantize_act_op(x, scale)
