"""The conv epilogue `ops.cuda.bias_act` on the CPU: its op (the plain
version) against the expressions the layers computed before it, bit for
bit, with and without the second store into a dense block's buffer; the
dense block written in place against `torch.cat` of its three convs; the
calls an inference forward makes, and none with grad enabled. The kernel
against the plain version on the card: tests/test_torch_cuda.py."""

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


_COUNTS = [("body25", {}, 108), ("vgg19", {}, 80),
           ("mobilenet_thin", {"fused_inference": True}, 21),
           ("mobilenet_thin", {}, 103)]


@pytest.mark.parametrize("name,model,calls", _COUNTS,
                         ids=["body25", "vgg19", "mobilenet_thin-fused",
                              "mobilenet_thin"])
def test_inference_forward_counts_its_epilogues(name, model, calls):
    """An eager inference forward calls the op once a conv with bias and
    activation: BODY_25 108 (9 ReLU and 3 PReLU front convs, 6 stages of
    16), VGG19 80, MobileNet-thin 21 fused (its stem, dw1-dw4's two halves,
    12 stage projections) and 103 unfused; the count read off the module
    tree agrees."""
    m = _model(name, **model)
    x = torch.rand(1, 32, 48, 3)
    with torch.no_grad(), GLOBAL_TRACER.recording() as rec:
        m(x)
    assert rec.counters["ops.bias_act"] == calls
    assert kernel_inputs.bias_act_calls(m) == calls


@pytest.mark.parametrize("name", ["vgg19", "mobilenet_thin"])
def test_grad_path_calls_no_epilogue_op(name):
    """With grad enabled the layers run the plain expressions (the kernel
    has no backward): the counter stays 0, the maps equal the inference
    forward's, and a second store goes to the buffer as the op's does."""
    m = _model(name)
    x = torch.rand(1, 32, 48, 3)
    with GLOBAL_TRACER.recording() as rec:
        out = m(x)
    assert "ops.bias_act" not in rec.counters
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
