"""The conv epilogue `ops.cuda.bias_act` on the CPU: its op (the plain
version) against the expressions the layers computed before it, bit for
bit, with and without the second store into a dense block's buffer, and
pooled against `F.max_pool2d` of them; the dense block written in place
against `torch.cat` of its three convs; the calls an inference forward
makes (pooled ones too), none with grad enabled, and int8's own pool. The
kernel against the plain version on the card: tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kernel_inputs
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.ops.cuda import bias_act
from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

torch.set_num_threads(2)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (signed zeros and NaN compared too)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _case(dtype, b=2, h=5, w=7, c=24, seed=0):
    """y NCHW channels-last in `dtype`, bias and slope float32."""
    y, bias, slope = kernel_inputs.epilogue_inputs(
        np.random.default_rng(seed), b, h, w, c)
    y = torch.from_numpy(y).to(dtype).permute(0, 3, 1, 2)
    return y, torch.from_numpy(bias), torch.from_numpy(slope)


def _expression(y, bias, slope):
    """What ConvRelu and PReLUConv computed after the conv before the
    epilogue op."""
    t = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return F.relu(t) if slope is None else F.prelu(t, slope.to(y.dtype))


@pytest.mark.parametrize("store", [None, 0, 1, 2])
@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_op_equals_the_layers_expressions(dtype, act, store):
    """The op's result, and its second store at channels [store * w,
    (store + 1) * w) of a 3w-wide channels-last buffer (the rest left
    as it was), equal the expressions bit for bit."""
    y, bias, slope = _case(DTYPES[dtype])
    slope = slope if act == "prelu" else None
    ref = _expression(y, bias, slope)
    if store is None:
        out = bias_act.bias_act(y, bias, slope)
    else:
        c = y.shape[1]
        into = torch.full((y.shape[0], 3 * c, *y.shape[2:]), 7.0,
                          dtype=y.dtype).contiguous(
                              memory_format=torch.channels_last)
        out = bias_act.bias_act(y, bias, slope, into, store * c)
        assert torch.equal(_bits(into[:, store * c:(store + 1) * c]),
                           _bits(ref))
        rest = torch.cat([into[:, :store * c], into[:, (store + 1) * c:]],
                         dim=1)
        assert bool((rest == 7.0).all())
    assert out.dtype == y.dtype and torch.equal(_bits(out), _bits(ref))
    assert bool(ref.isnan().any()) and bool((ref == 0).any())


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_op_output_and_buffer_are_separate_tensors(act):
    """The result is a tensor of its own beside the buffer's copy (a dense
    block's conv reads it while the block's buffer keeps its channels): a
    change to one leaves the other, and y is left as it was."""
    y, bias, slope = _case(torch.bfloat16, seed=1)
    slope = slope if act == "prelu" else None
    y0 = y.clone()
    into = torch.zeros((y.shape[0], 2 * y.shape[1], *y.shape[2:]),
                       dtype=y.dtype)
    out = bias_act.bias_act(y, bias, slope, into, y.shape[1])
    ref = _expression(y, bias, slope)
    assert torch.equal(_bits(out), _bits(ref))
    out.fill_(3.0)
    assert torch.equal(_bits(into[:, y.shape[1]:]), _bits(ref))
    assert torch.equal(_bits(y), _bits(y0))


def test_op_refuses_meta_tensors():
    """Like every op of the port, the wrapper takes CPU and CUDA tensors
    only; a shape-only forward runs on fake tensors instead (the op's fake
    implementation)."""
    y, bias, slope = _case(torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        bias_act.bias_act(y.to("meta"), bias.to("meta"), slope.to("meta"))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_block_in_place_equals_the_concat(dtype):
    """The block's epilogues write its output in place; it equals
    torch.cat of the three convs' outputs, with grad disabled (the op) and
    enabled (the plain expressions)."""
    block = common.DenseBlock(20, 16, dtype={"bf16": "bfloat16",
                                             "f32": "float32"}[dtype])
    g = torch.Generator().manual_seed(3)
    common.init_params(block, g)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if not name.endswith("weight"):
                p.normal_(0.0, 0.5, generator=g)
    x = torch.randn(2, 9, 11, 20, generator=g).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = block(x)
        a = block.conv0(x)
        b = block.conv1(a)
        ref = torch.cat([a, b, block.conv2(b)], dim=1)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(block(x).detach()), _bits(ref))


def _model(name, **model):
    cfg = tconfig.default_config(name)
    mc = dataclasses.replace(cfg.model, hin=32, win=48, **model)
    model = get_model(mc)
    common.init_params(model, torch.Generator().manual_seed(0))
    return model.eval()


_COUNTS = [("body25", {}, 108, 3), ("vgg19", {}, 80, 3),
           ("mobilenet_thin", {"fused_inference": True}, 21, 0),
           ("mobilenet_thin", {}, 103, 0)]


def _epilogue_counters(rec) -> dict:
    return {k: v for k, v in rec.counters.items()
            if k.startswith("ops.bias_act")}


@pytest.mark.parametrize("name,model,calls,pooled", _COUNTS,
                         ids=["body25", "vgg19", "mobilenet_thin-fused",
                              "mobilenet_thin"])
def test_inference_forward_counts_its_epilogues(name, model, calls, pooled):
    """An eager inference forward calls the op once a conv with bias and
    activation: BODY_25 108 (9 ReLU and 3 PReLU front convs, 6 stages of
    16), VGG19 80, MobileNet-thin 21 fused (its stem, dw1-dw4's two halves,
    12 stage projections) and 103 unfused; of them pooled (`ops.bias_act_
    pool`) the last conv of each of the VGG front's three pooled blocks,
    and none of MobileNet-thin's (its pool reads a layer that dw4 reads
    too); the counts read off the module tree agree."""
    m = _model(name, **model)
    x = torch.rand(1, 32, 48, 3)
    with torch.no_grad(), GLOBAL_TRACER.recording() as rec:
        m(x)
    want = {"ops.bias_act": calls, "ops.bias_act_pool": pooled}
    want = {k: v for k, v in want.items() if v}
    assert _epilogue_counters(rec) == want
    assert kernel_inputs.bias_act_calls(m) == want


@pytest.mark.parametrize("name", ["vgg19", "mobilenet_thin"])
def test_grad_path_calls_no_epilogue_op(name):
    """With grad enabled the layers run the plain expressions (the kernel
    has no backward): the counter stays 0, the maps equal the inference
    forward's, and a second store goes to the buffer as the op's does."""
    m = _model(name)
    x = torch.rand(1, 32, 48, 3)
    with GLOBAL_TRACER.recording() as rec:
        out = m(x)
    assert not _epilogue_counters(rec)
    with torch.no_grad():
        ref = m(x)
    for key in ("conf", "paf"):
        for a, b in zip(out[key], ref[key], strict=True):
            assert torch.equal(a.detach(), b)
    y, bias, slope = _case(torch.float32, seed=4)
    into = torch.zeros((y.shape[0], 2 * y.shape[1], *y.shape[2:]))
    with GLOBAL_TRACER.recording() as rec:
        out = common.conv_epilogue(y, bias, slope, into, y.shape[1])
    assert not rec.counters
    ref = _expression(y, bias, slope)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(into[:, y.shape[1]:]), _bits(ref))


@pytest.mark.parametrize("store", [None, 0, 1])
def test_op_passes_opcheck(store):
    """The op's schema (the buffer it stores into declared mutated), fake
    version and dispatch, by torch.library.opcheck (on finite values: it
    compares outputs with NaN unequal to NaN)."""
    y, bias, slope = _case(torch.bfloat16, seed=2)
    y = torch.nan_to_num(y, nan=0.0, posinf=1.0, neginf=-1.0)
    into = None if store is None else torch.zeros(
        (y.shape[0], 3 * y.shape[1], *y.shape[2:]), dtype=y.dtype
    ).contiguous(memory_format=torch.channels_last)
    op = torch.ops.openpose_plus_tpu_torch.bias_act.default
    result = torch.library.opcheck(
        op, (y, bias, slope, into, (store or 0) * y.shape[1]))
    assert set(result.values()) == {"SUCCESS"}, result


# ------------------------------------------------------------ pooled ---

@pytest.mark.parametrize("hw", [(6, 8), (5, 7), (7, 6)],
                         ids=["even", "odd", "odd-h"])
@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pooled_op_equals_the_expressions_then_the_pool(dtype, act, hw):
    """Pooled, the op gives `F.max_pool2d` of the expressions bit for bit
    (NaN, infinities and signed zeros among the inputs; an odd last row or
    column dropped), (B, C, H // 2, W // 2) channels-last; the plain
    version pooled is the same."""
    y, bias, slope = _case(DTYPES[dtype], h=hw[0], w=hw[1], seed=5)
    slope = slope if act == "prelu" else None
    ref = F.max_pool2d(_expression(y, bias, slope), 2, 2)
    out = bias_act.bias_act(y, bias, slope, pool=True)
    b, c, h, w = y.shape
    assert tuple(out.shape) == (b, c, h // 2, w // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.dtype == y.dtype and torch.equal(_bits(out), _bits(ref))
    plain = bias_act.bias_act_plain(y, bias, slope, pool=True)
    assert torch.equal(_bits(plain), _bits(ref))
    assert bool(ref.isnan().any()) and bool(ref.isinf().any())


def test_pooled_op_keeps_pytorchs_nan_and_zero_rule():
    """A window's NaN wins over any number, the last of two NaNs wins,
    and of 0 and -0 the first: PyTorch's pooling rule, so the fused pool
    is the separate pool's bits."""
    nan_a = torch.tensor(float("nan"))
    nan_b = -nan_a                                  # another bit pattern
    windows = [[1.0, nan_a, 5.0, 2.0], [nan_a, 3.0, nan_b, 4.0],
               [0.0, -0.0, -1.0, -2.0], [-0.0, 0.0, -1.0, -2.0],
               [-float("inf"), -3.0, -2.0, -1.0]]
    y = torch.tensor(windows).view(5, 1, 2, 2).permute(1, 0, 2, 3)
    y = y.reshape(1, 5, 2, 2).contiguous(memory_format=torch.channels_last)
    bias = torch.full((5,), -0.0)       # x + -0 is x, signed zeros too
    slope = torch.ones(5)               # PReLU with slope 1: the identity
    out = bias_act.bias_act(y, bias, slope, pool=True)
    ref = F.max_pool2d(_expression(y, bias, slope), 2, 2)
    assert torch.equal(_bits(out), _bits(ref))
    got = _bits(out).view(-1)
    assert got[0] == _bits(nan_a.view(1))[0]
    assert got[1] == _bits(nan_b.view(1))[0]
    assert got[2] == 0 and got[3] == _bits(torch.tensor([-0.0]))[0]
    assert float(out.view(-1)[4]) == -1.0


def test_pooled_op_shape_and_refusals():
    """The fake version gives the pooled shape channels-last (what a
    traced program plans with); a pooled call with a buffer is refused by
    the wrapper, the plain version and the fake version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    y, bias, slope = _case(torch.bfloat16, h=9, w=12)
    op = torch.ops.openpose_plus_tpu_torch.bias_act.default
    with FakeTensorMode() as mode:
        fy, fb, fs = (mode.from_tensor(t) for t in (y, bias, slope))
        out = op(fy, fb, fs, None, 0, True)
        assert tuple(out.shape) == (2, 24, 4, 6) and out.dtype == y.dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert tuple(op(fy, fb, fs, None, 0, False).shape) == tuple(y.shape)
        with pytest.raises(ValueError, match="takes no buffer"):
            op(fy, fb, fs, torch.empty_like(fy), 0, True)
    into = torch.zeros_like(y)
    with pytest.raises(ValueError, match="takes no buffer"):
        bias_act.bias_act(y, bias, slope, into, 0, pool=True)
    with pytest.raises(ValueError, match="takes no buffer"):
        bias_act.bias_act_plain(y, bias, slope, into, pool=True)
    with pytest.raises(ValueError, match="at least 2 rows and columns"):
        bias_act.bias_act(y[:, :, :1], bias, slope, pool=True)


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_pooled_op_passes_opcheck(act):
    y, bias, slope = _case(torch.bfloat16, h=6, w=9, seed=6)
    y = torch.nan_to_num(y, nan=0.0, posinf=1.0, neginf=-1.0)
    op = torch.ops.openpose_plus_tpu_torch.bias_act.default
    result = torch.library.opcheck(
        op, (y, bias, slope if act == "prelu" else None, None, 0, True))
    assert set(result.values()) == {"SUCCESS"}, result


def test_grad_path_pools_after_the_plain_expressions(monkeypatch):
    """With grad enabled VGG19's three pooled blocks take the plain
    expressions, then `F.max_pool2d` (no op call), and a pooled epilogue
    under grad is that."""
    seen = []
    plain = bias_act.bias_act_plain

    def record(*args):
        seen.append(args[5] if len(args) > 5 else False)
        return plain(*args)

    monkeypatch.setattr(bias_act, "bias_act_plain", record)
    m = _model("vgg19")
    with GLOBAL_TRACER.recording() as rec:
        m(torch.rand(1, 32, 48, 3))
    assert not _epilogue_counters(rec)
    assert len(seen) == 80 and sum(seen) == 3
    y, bias, slope = _case(torch.float32, seed=7)
    y.requires_grad_(True)
    out = common.conv_epilogue(y, bias, slope, pool=True)
    ref = F.max_pool2d(_expression(y, bias, slope), 2, 2)
    assert torch.equal(_bits(out.detach()), _bits(ref.detach()))
    out.nan_to_num().sum().backward()
    assert y.grad is not None


def test_int8_forward_pools_its_int8_plane(monkeypatch):
    """An int8 VGG19 forward pools each of its three pooled blocks'
    QAct planes (`maxpool2x2`), not in an epilogue: no pooled op call."""
    seen = []
    pool = common.maxpool2x2

    def record(x):
        seen.append(type(x).__name__)
        return pool(x)

    monkeypatch.setattr(common, "maxpool2x2", record)
    m = _model("vgg19", compute_dtype="int8")
    with torch.no_grad(), GLOBAL_TRACER.recording() as rec:
        m(torch.rand(1, 32, 48, 3))
    assert seen == ["QAct"] * 3
    assert "ops.bias_act_pool" not in rec.counters
    assert kernel_inputs.bias_act_calls(m) == _epilogue_counters(rec)


def test_pooled_epilogue_keeps_the_band_rule():
    """Under a spatial band a pooled epilogue on the output grid is
    refused, as `maxpool2x2` refuses it."""
    from openpose_plus_tpu_torch.parallel import spatial

    y, bias, slope = _case(torch.float32, h=3, w=4)
    band = spatial.Band(1, 4, None, 10, 8)
    with spatial.use(band), torch.no_grad():
        with pytest.raises(ValueError, match="a 2x2 pool on the output"):
            common.conv_epilogue(y, bias, slope, pool=True)
        with pytest.raises(ValueError, match="a 2x2 pool on the output"):
            common.maxpool2x2(y)
