"""Shared building blocks of the pose models, in PyTorch.

Port of `openpose_plus_tpu/models/common.py` (the plain lowering, the dense
and separable stage branches, the fused separable branch, the VGG blocks,
the space-to-depth data movement of the input layouts, and the calibrated
int8 mode; no block-grid conv rearrangements), and the port's own PReLU
conv and dense block (OpenPose BODY_25, `models/body25.py`). Submodules
and parameters carry the Flax scope names so the weight bridge
(`openpose_plus_tpu_torch.checkpoint`) is a rename plus a transpose.

Numerics follow the reference layer by layer: every conv runs in the compute
dtype, its bias is added in the compute dtype AFTER the conv, then ReLU; the
last 1x1 of each branch runs in float32 on the upcast input. Tensors are
NCHW inside the model; parameters are float32 and cast per call, as the
Flax modules cast their float32 params. With grad disabled, a conv's bias
and activation are one `ops.cuda.bias_act` pass over its output (the same
numbers; `conv_epilogue`); a dense block's epilogues write its
concatenation in place, and a VGG block's last epilogue takes the block's
2x2 max pool in the same pass (`run_vgg_block`).

int8 (`compute_dtype="int8"`) is an inference mode, not an activation
dtype: the dense and pointwise convs run on the int8 tensor cores
(`ops.cuda.int8_conv`) with per-channel weight scales derived from the
float params, per-tensor activation scales recorded by calibration, and
everything else in bf16. A `ConvRelu` emits its output as a `QAct` (int8
values + their scale), which the next dense conv and the max pool take as
they are. The scales are buffers named as the Flax `calib` leaves
(`act_scale`, `out_scale`, `stage{n}_in_scale`), registered only in int8
models; `set_calibrating(model, True)` makes every int8 layer run its
bf16 float path and grow the scales instead (`Engine.calibrate`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from openpose_plus_tpu_torch.ops.cuda import bias_act, int8_conv, sepconv
from openpose_plus_tpu_torch.parallel import spatial
from openpose_plus_tpu_torch.utils.tracer import count

# "int8" carries bf16 between the convs (`common.py::_dtype`)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.bfloat16}
CALIB_LEAVES = ("act_scale", "out_scale")   # + "stage{n}_in_scale"
PRELU_INIT = 0.25     # Caffe's PReLU filler


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


class QAct(NamedTuple):
    """An int8-resident activation (`common.py::QAct`): q, int8 NCHW
    channels-last (NHWC in memory), and the 0-d float32 scale its values
    span ([-scale, scale]). A dense stage input carries zero channels past
    its own up to `int8_conv.padded(C)` (the quantize pass writes the
    layout the int8 conv reads); only int8 convs read it."""

    q: torch.Tensor
    scale: torch.Tensor


def dequant(x):
    """QAct -> bf16, (q * (max(scale, 1e-6) / 127)); float tensors pass."""
    if isinstance(x, QAct):
        s = (x.scale.clamp_min(int8_conv.SCALE_FLOOR)
             / int8_conv.device_scalar(127.0, x.scale.device))
        return (x.q.float() * s).to(torch.bfloat16)
    return x


def is_calib_leaf(name: str) -> bool:
    """A buffer / Flax leaf name of the int8 calibration scales."""
    return name in CALIB_LEAVES or (name.startswith("stage")
                                    and name.endswith("_in_scale"))


def set_calibrating(model: nn.Module, on: bool) -> None:
    """Calibration mode on every int8 layer of `model` (the reference's
    mutable `calib` collection)."""
    for m in model.modules():
        if hasattr(m, "calibrating"):
            m.calibrating = on


def _grow(scale: torch.Tensor, x: torch.Tensor) -> None:
    """scale = max(scale, max |x|), in place (a running max: only grows)."""
    scale.copy_(torch.maximum(scale, x.abs().amax().float()))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW activation's NHWC view, contiguous (no copy when it is
    channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class _Int8Layer(nn.Module):
    """The int8 state of a quantized layer: the calib buffers, the
    calibration flag, and the int8 weights cached per float weight (the
    inference weights do not change; an in-place update or a
    `load_state_dict` bumps the weight's version and drops the cache).
    `int8_weight_name` names the float weight the int8 conv runs on."""

    def _init_int8(self, dtype: str, weight_name: str) -> None:
        self.int8 = dtype == "int8"
        self.int8_weight_name = weight_name
        if self.int8:
            self.calibrating = False
            self.register_buffer("act_scale", torch.zeros(()))
            self.register_buffer("out_scale", torch.zeros(()))
        self._qcache: tuple | None = None

    def _int8_weights(self, weight: torch.Tensor) -> tuple:
        if torch.compiler.is_compiling():   # traced: no cache
            if "packed_weight" in self._buffers:     # frozen_int8_weights
                return self.packed_weight, self.weight_max
            qw, wmax = int8_conv.quantize_weight(weight)
            return int8_conv.pack_weight(qw), wmax
        key = (weight.data_ptr(), weight._version, weight.device)
        if self._qcache is None or self._qcache[0] != key:
            with torch.no_grad():
                qw, wmax = int8_conv.quantize_weight(weight)
                self._qcache = (key, int8_conv.pack_weight(qw), wmax)
        return self._qcache[1:]

    def _int8_conv(self, x, weight: torch.Tensor, bias: torch.Tensor,
                   stride: int, emit_q: bool = True):
        """`common.py::_int8_conv` (ReLU always): calibrating, the bf16
        conv recording max |input| and max |output|; else the int8 conv of
        a QAct (its own scale) or of a float input quantized at
        act_scale, returning a QAct at out_scale (emit_q) or bf16."""
        if self.calibrating:
            xf = dequant(x)
            _grow(self.act_scale, xf)
            y = conv_epilogue(conv2d_same(xf.to(torch.bfloat16),
                                          weight.to(torch.bfloat16), stride),
                              bias)
            _grow(self.out_scale, y)
            return y
        floor = int8_conv.SCALE_FLOOR
        if isinstance(x, QAct):
            q, s_in = _nhwc(x.q), x.scale.clamp_min(floor)
        else:
            s_in = self.act_scale.clamp_min(floor)
            q = int8_conv.quantize_act(_nhwc(x.to(torch.bfloat16)), s_in)
        w_packed, wmax = self._int8_weights(weight)
        k = weight.shape[-1]
        pads = (same_padding(q.shape[1], k, stride)[0],
                same_padding(q.shape[2], k, stride)[0])
        s_out = self.out_scale.clamp_min(floor) if emit_q else None
        y = int8_conv.int8_conv(q, w_packed, k,
                                int8_conv.rescale(s_in, wmax),
                                bias.detach().float().contiguous(),
                                stride, pads,
                                s_out).permute(0, 3, 1, 2)
        return QAct(y, s_out) if emit_q else y


@contextlib.contextmanager
def frozen_int8_weights(model: nn.Module) -> Iterator[None]:
    """While `model` is traced (`torch.export`): each int8 layer's packed
    weights and weight maximum as non-persistent buffers, which the traced
    layer reads as they are, so the program holds them as constants
    instead of quantizing and packing the float weights at every call."""
    layers = [m for m in model.modules()
              if isinstance(m, _Int8Layer) and m.int8]
    for layer in layers:
        packed, wmax = layer._int8_weights(getattr(layer,
                                                   layer.int8_weight_name))
        layer.register_buffer("packed_weight", packed, persistent=False)
        layer.register_buffer("weight_max", wmax, persistent=False)
    try:
        yield
    finally:
        for layer in layers:
            del layer._buffers["packed_weight"], layer._buffers["weight_max"]


def _check_band_pool(x: torch.Tensor) -> None:
    """Under a spatial band a 2x2 pool pools the rank's rows: the bands
    above the output grid start and end on even rows."""
    band = spatial.active()
    if band is not None:
        spatial.check_pool(band, x)


def maxpool2x2(x):
    """2x2 stride-2 max pool (VALID: an odd last row or column is
    dropped); a QAct pools its int8 plane (max commutes with the positive
    scale), exactly. Under a spatial band it pools the rank's rows
    (`_check_band_pool`). A float VGG block pools in its last conv's
    epilogue instead (`conv_epilogue`)."""
    _check_band_pool(x.q if isinstance(x, QAct) else x)
    if isinstance(x, QAct):
        q = _nhwc(x.q)
        b, h, w, c = q.shape
        q = q[:, :h // 2 * 2, :w // 2 * 2].reshape(
            b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
        return QAct(q.permute(0, 3, 1, 2), x.scale)
    return F.max_pool2d(x, 2, 2)


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
    """NCHW conv with "SAME" padding, no bias. Under a spatial band
    (`parallel.spatial.use`) x is the rank's band of rows: the padding is
    that of the global tensor, and the rows the band's outputs read come
    from the neighbouring ranks (`spatial.conv_rows`)."""
    band = spatial.active()
    k = weight.shape[-2]
    if band is None:
        top, bottom = same_padding(x.shape[-2], k, stride)
    else:
        height = band.hout * band.scale(x.shape[-2])
        x = spatial.conv_rows(band, x, k, stride,
                              same_padding(height, k, stride)[0])
        top = bottom = 0
    left, right = same_padding(x.shape[-1], weight.shape[-1], stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, None, stride, (top, left), 1, groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, None, stride, 0, 1, groups)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H/2, W/2, 4C); channel = (wy*2+wx)*C + c.
    Applied twice it gives the s2d^2 layout (nested position-major
    channels, as `openpose_plus_tpu.native.s2d2_u8` emits it)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of space_to_depth: (B, H, W, 4C) -> (B, 2H, 2W, C),
    contiguous."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c).contiguous()


def to_plain(x: torch.Tensor) -> torch.Tensor:
    """An s2d (12-channel) or s2d^2 (48-channel) NHWC image -> the plain
    (B, H, W, 3) one, laid out as a plain input (exact data movement);
    a 3-channel image is returned as it is."""
    if x.shape[-1] == 48:
        x = depth_to_space(x, 12)
    if x.shape[-1] == 12:
        x = depth_to_space(x, 3)
    return x


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal in [-2, 2] sigma, with
    variance 1/fan_in after the truncation's 0.8796 correction."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  slope: torch.Tensor | None = None,
                  into: torch.Tensor | None = None,
                  offset: int = 0, pool: bool = False) -> torch.Tensor:
    """A conv output's bias, then ReLU (`slope` None) or PReLU, in its
    dtype, also stored at channels [offset, offset + C) of `into` when
    given, or (`pool`) 2x2 max-pooled as `maxpool2x2` pools
    (`ops.cuda.bias_act`). With grad disabled it is the `bias_act` op, one
    pass over the output (channels-last); with grad enabled (the kernel
    has no backward) the plain expressions, then `F.max_pool2d`."""
    if pool:
        _check_band_pool(y)
    if torch.is_grad_enabled():
        return bias_act.bias_act_plain(y, bias, slope, into, offset, pool)
    return bias_act.bias_act(y.contiguous(memory_format=torch.channels_last),
                             bias, slope, into, offset, pool)


class ConvRelu(_Int8Layer):
    """kxk conv + ReLU (`models/common.py::ConvRelu`), then, with `pool`,
    the 2x2 max pool (in the float epilogue's pass; in int8 `maxpool2x2`
    of the output); in int8, float or QAct in, QAct out."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: str = "bfloat16"):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self._init_int8(dtype, "weight")

    def forward(self, x, pool: bool = False):
        if self.int8:
            y = self._int8_conv(x, self.weight, self.bias, self.stride)
            return maxpool2x2(y) if pool else y
        dt = self.dtype
        y = conv2d_same(x.to(dt), self.weight.to(dt), self.stride)
        return conv_epilogue(y, self.bias, pool=pool)


class SepConvRelu(_Int8Layer):
    """Depthwise kxk + ReLU, pointwise 1x1 + ReLU
    (`models/common.py::SepConvRelu`, plain and fused branches).

    With `fused` and a stride-1 3x3 bf16 layer (the shape/dtype part of the
    JAX gate) the block runs as one `ops.cuda.sepconv.fused_sepconv` call;
    the JAX gate's TPU VMEM budget (`fused_sepconv_fits`) is not ported, so
    every such layer fuses. Inference only: the fused call has no
    backward. In int8 it never fuses (the reference's gate asks for
    bfloat16): a QAct input is dequantized, the depthwise runs in bf16 and
    the pointwise as an int8 conv with a bf16 output."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: str = "bfloat16",
                 fused: bool = False):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.fused = (fused and stride == 1 and kernel == 3
                      and dtype == "bfloat16")
        self.dw_weight = nn.Parameter(
            torch.empty(in_features, 1, kernel, kernel))
        self.dw_bias = nn.Parameter(torch.zeros(in_features))
        self.pw_weight = nn.Parameter(
            torch.empty(features, in_features, 1, 1))
        self.pw_bias = nn.Parameter(torch.zeros(features))
        self._init_int8(dtype, "pw_weight")

    def forward(self, x):
        x = dequant(x)
        dt = self.dtype
        if self.fused:   # NCHW channels-last in, so NHWC-contiguous views
            return sepconv.fused_sepconv(
                x.to(dt).permute(0, 2, 3, 1),
                self.dw_weight.permute(2, 3, 1, 0), self.dw_bias,
                self.pw_weight.permute(2, 3, 1, 0), self.pw_bias,
            ).permute(0, 3, 1, 2)
        y = conv2d_same(x.to(dt), self.dw_weight.to(dt), self.stride,
                        groups=self.dw_weight.shape[0])
        y = conv_epilogue(y, self.dw_bias)
        if self.int8:
            return self._int8_conv(y, self.pw_weight, self.pw_bias, 1,
                                   emit_q=False)
        return conv_epilogue(F.conv2d(y, self.pw_weight.to(dt)),
                             self.pw_bias)


class PReLUConv(nn.Module):
    """kxk conv + PReLU (Caffe's: a learned slope a channel for the
    negative side), as OpenPose's BODY_25 uses it: the conv, its bias and
    the PReLU in the compute dtype, as ConvRelu's conv, bias and ReLU. The
    slope is named `slope`, not `bias` or `weight`, so a rule that draws
    parameters by those names leaves it to its own."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: str = "bfloat16"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.slope = nn.Parameter(torch.full((features,), PRELU_INIT))

    def forward(self, x: torch.Tensor, into: torch.Tensor | None = None,
                offset: int = 0) -> torch.Tensor:
        """`conv_epilogue`'s `into` and `offset` pass through."""
        dt = self.dtype
        y = conv2d_same(x.to(dt), self.weight.to(dt))
        return conv_epilogue(y, self.bias, self.slope, into, offset)


class DenseBlock(nn.Module):
    """Three chained 3x3 PReLUConv of `features` channels (`conv0` reads
    the input, `conv1` conv0's output, `conv2` conv1's) and their outputs
    concatenated in that order: 3 * features channels (a BODY_25 stage's
    `Mconv` block). Each conv's epilogue writes its channels of the
    block's channels-last output itself, beside its own output (the next
    conv reads that one contiguous), so no concat copies them again. Each
    forward adds one to the tracer's `models.dense_blocks` counter."""

    def __init__(self, in_features: int, features: int,
                 dtype: str = "bfloat16"):
        super().__init__()
        self.conv0 = PReLUConv(in_features, features, dtype=dtype)
        self.conv1 = PReLUConv(features, features, dtype=dtype)
        self.conv2 = PReLUConv(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("models.dense_blocks")
        w = self.conv0.weight.shape[0]
        out = torch.empty((x.shape[0], 3 * w, *x.shape[2:]),
                          dtype=self.conv0.dtype, device=x.device,
                          memory_format=torch.channels_last)
        a = self.conv0(x, out, 0)
        b = self.conv1(a, out, w)
        self.conv2(b, out, 2 * w)
        return out


class Conv1x1F32(nn.Module):
    """The final prediction 1x1 (Flax `nn.Conv(dtype=float32)`): float32
    conv of the upcast input (a QAct dequantized first: the int8 chain
    ends here), then the float32 bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x) -> torch.Tensor:
        return (F.conv2d(dequant(x).float(), self.weight)
                + self.bias.view(1, -1, 1, 1))


class StageBranch(nn.Module):
    """One branch (conf or paf) of one stage (`models/common.py::
    StageBranch`): n kxk convs (mid), a 1x1 ConvRelu (proj), the float32
    1x1 (out). Dense form: n ConvRelu, so Flax names the projection
    `ConvRelu_{n}`; separable form: n SepConvRelu and `ConvRelu_0`."""

    def __init__(self, in_features: int, out_features: int,
                 n_convs: int, kernel: int, proj_features: int,
                 mid_features: int = 128, separable: bool = False,
                 dtype: str = "bfloat16", fused: bool = False):
        super().__init__()
        c = in_features
        for i in range(n_convs):
            if separable:
                self.add_module(f"SepConvRelu_{i}", SepConvRelu(
                    c, mid_features, kernel=kernel, dtype=dtype, fused=fused))
            else:
                self.add_module(f"ConvRelu_{i}", ConvRelu(
                    c, mid_features, kernel=kernel, dtype=dtype))
            c = mid_features
        proj = ConvRelu(c, proj_features, kernel=1, dtype=dtype)
        self.add_module(f"ConvRelu_{0 if separable else n_convs}", proj)
        self.Conv_0 = Conv1x1F32(proj_features, out_features)

    def forward(self, x) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class MultiStageHead(nn.Module):
    """The stage stack (`models/common.py::MultiStageHead`): stage 1 reads
    the feature map; stage t > 1 reads concat(feature, conf_{t-1},
    paf_{t-1}) in the compute dtype. Dense branches unless `separable`.
    With `remat`, each branch recomputes its activations in the backward
    pass instead of keeping them (`nn.remat(StageBranch)`). An int8 dense
    head quantizes each later stage's input once, at its calibrated
    `stage{n}_in_scale`, and hands the QAct to both branches."""

    def __init__(self, in_features: int, n_heatmaps: int = 19,
                 n_pafs: int = 38, n_stages: int = 6, stage1_convs: int = 3,
                 stage1_kernel: int = 3, stage1_proj: int = 512,
                 refine_convs: int = 5, refine_kernel: int = 7,
                 refine_mid: int = 128, separable: bool = False,
                 dtype: str = "bfloat16", fused: bool = False,
                 remat: bool = False):
        super().__init__()
        self.n_stages = n_stages
        self.remat = remat
        self.int8 = dtype == "int8" and not separable
        if self.int8:
            self.calibrating = False
            for s in range(1, n_stages):
                self.register_buffer(f"stage{s + 1}_in_scale",
                                     torch.zeros(()))
        for s in range(n_stages):
            if s == 0:
                kw = dict(in_features=in_features, n_convs=stage1_convs,
                          kernel=stage1_kernel, proj_features=stage1_proj)
            else:
                kw = dict(in_features=in_features + n_heatmaps + n_pafs,
                          mid_features=refine_mid, n_convs=refine_convs,
                          kernel=refine_kernel, proj_features=refine_mid)
            for name, out in (("conf", n_heatmaps), ("paf", n_pafs)):
                self.add_module(f"stage{s + 1}_{name}", StageBranch(
                    out_features=out, separable=separable, dtype=dtype,
                    fused=fused, **kw))

    def forward(self, feature
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        confs: list[torch.Tensor] = []
        pafs: list[torch.Tensor] = []
        f_float = dequant(feature)
        x = feature
        for s in range(self.n_stages):
            if s > 0:
                x = torch.cat([f_float, confs[-1].to(f_float.dtype),
                               pafs[-1].to(f_float.dtype)], dim=1)
                if self.int8:
                    x = self._stage_input(s, x)
            confs.append(self._branch(f"stage{s + 1}_conf", x))
            pafs.append(self._branch(f"stage{s + 1}_paf", x))
        return confs, pafs

    def _stage_input(self, s: int, x: torch.Tensor):
        scale = getattr(self, f"stage{s + 1}_in_scale")
        if self.calibrating:
            _grow(scale, x)
            return x
        scale = scale.clamp_min(int8_conv.SCALE_FLOOR)
        q = int8_conv.quantize_act(_nhwc(x), scale)
        return QAct(q.permute(0, 3, 1, 2), scale)

    def _branch(self, name: str, x) -> torch.Tensor:
        branch = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # the recompute runs in the backward pass, under the band of
            # the forward (its halo exchanges in the same order on every
            # rank); the branches draw no random numbers, so no RNG state
            # is stashed (reading it is not allowed in a CUDA-graph capture)
            return torch.utils.checkpoint.checkpoint(
                spatial.keep_band(branch), x, use_reentrant=False,
                preserve_rng_state=False)
        return branch(x)


def vgg_block(model: nn.Module, prefix: str, in_features: int,
              features: tuple[int, ...], dtype: str) -> list[str]:
    """Registers a VGG block's stacked 3x3 ConvRelu on `model` under the
    Flax names `{prefix}_{i + 1}` (`models/common.py::vgg_block`, plain
    lowering; the s2d block-grid stem is the same math, in int8 the same
    integer sums, and is not ported) and returns their names, for
    `run_vgg_block`."""
    names = []
    for i, f in enumerate(features):
        names.append(f"{prefix}_{i + 1}")
        model.add_module(names[-1], ConvRelu(in_features, f, dtype=dtype))
        in_features = f
    return names


def vgg_input(x: torch.Tensor, stem_s2d: bool, dtype: torch.dtype
              ) -> torch.Tensor:
    """A VGG-style backbone's input: an NHWC float image, plain or (with
    `stem_s2d`) in the 12-channel s2d layout, as the plain image in
    `dtype`, NCHW channels-last."""
    if x.shape[-1] == 12 and not stem_s2d:
        raise ValueError("s2d input layout needs stem_s2d")
    if x.shape[-1] not in (3, 12):
        raise ValueError(f"expected a 3-channel image or its s2d (12) "
                         f"layout, got {tuple(x.shape)}")
    x = to_plain(x)               # s2d layout: exact data movement
    return x.to(dtype).permute(0, 3, 1, 2)     # NCHW, channels-last


def run_vgg_block(model: nn.Module, x, names: list[str], pool: bool):
    """The block's convs in order, the last one taking the optional 2x2 max
    pool (`ConvRelu`'s `pool`: the float epilogue pools in its own pass, so
    the full-size activation is never stored; int8 pools the QAct's
    plane)."""
    *first, last = names
    for name in first:
        x = getattr(model, name)(x)
    return getattr(model, last)(x, pool=pool)


class VGGFamilyPose(nn.Module):
    """The VGG-style backbones of the zoo (VGG19, VGG-tiny, hao28): VGG
    blocks, optional 3x3 CPM convs, then the dense multi-stage head. NHWC
    float images in (plain, or the 12-channel s2d layout when the config
    keeps `stem_s2d`, turned back into the plain image first); the same
    output dict as MobileNetThinPose.

    BLOCKS: (prefix, features, pool) per VGG block; CPM: (name, features)
    per CPM conv; HEAD: the MultiStageHead arguments."""

    BLOCKS: tuple = ()
    CPM: tuple = ()
    HEAD: dict = {}

    def __init__(self, cfg):
        super().__init__()
        d = cfg.compute_dtype
        self.dtype = compute_dtype(d)
        self.stem_s2d = cfg.stem_s2d
        self.blocks = []
        c = 3
        for prefix, features, pool in self.BLOCKS:
            self.blocks.append((vgg_block(self, prefix, c, features, d),
                                pool))
            c = features[-1]
        for name, f in self.CPM:
            self.add_module(name, ConvRelu(c, f, dtype=d))
            c = f
        self.stages = MultiStageHead(
            c, n_heatmaps=cfg.n_heatmaps, n_pafs=cfg.n_pafs,
            n_stages=cfg.n_stages, dtype=d, remat=cfg.remat_stages,
            **self.HEAD)

    def forward(self, x: torch.Tensor) -> dict:
        x = vgg_input(x, self.stem_s2d, self.dtype)
        for names, pool in self.blocks:
            x = run_vgg_block(self, x, names, pool)
        for name, _ in self.CPM:
            x = getattr(self, name)(x)
        confs, pafs = self.stages(x)

        def nhwc(t: torch.Tensor) -> torch.Tensor:
            return t.permute(0, 2, 3, 1)

        return dict(conf=[nhwc(c) for c in confs],
                    paf=[nhwc(p) for p in pafs], feature=nhwc(dequant(x)))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax-equivalent random init: lecun-normal kernels, zero biases;
    PReLU slopes at Caffe's default, PRELU_INIT."""
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            lecun_normal_(p, generator)
        else:
            with torch.no_grad():
                p.fill_(PRELU_INIT if name.endswith("slope") else 0.0)
