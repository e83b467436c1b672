"""The int8 conv kernel's tile plan (`ops/cuda/int8_conv.py::tile_plan`),
on the CPU.

The plan is shape in, tile out: (block_m, block_n), the output pixels and
channels a block of `csrc/int8_conv.cu` owns. Every int8 conv of the zoo's
full-width int8 forwards must get one of the plans the kernel's launcher
has an instance of (`launch_plan`, read from the source here), and the
plan must refuse the shapes the launcher refuses
(`kernel_inputs.INT8_REFUSED`; tests/test_torch_cuda.py holds the launcher
itself to them on the card).
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.models import get_model
from openpose_plus_tpu_torch.ops.cuda import build, int8_conv
from tests import kernel_inputs

torch.set_num_threads(2)

BATCH = 8          # the served batch: the plan reads M = B * Ho * Wo
ZOO = ("mobilenet_thin", "vgg19", "vggtiny", "hao28")


def _launcher_plans() -> set:
    """(block_m, block_n) of each `launch_conv<consumer warpgroups, BN,
    ...>` instance that csrc/int8_conv.cu's `launch_plan` dispatches to:
    64 pixels a consumer warpgroup."""
    src = Path(build.CSRC, "int8_conv.cu").read_text()
    body = src[src.index("int launch_plan("):]
    body = body[:body.index("\n}\n")]
    return {(64 * int(wg), int(bn)) for wg, bn in re.findall(
        r"launch_conv<(\d+), (\d+), kQuant, \d+>", body)}


def _int8_calls(name: str) -> set:
    """(q shape, Cout, kernel, stride, pads) of every int8_conv call of one
    full-width int8 forward of `name` at batch 1, the convs stubbed (zeros
    of each output's shape and type)."""
    mc = dataclasses.replace(tconfig.default_config(name).model,
                             compute_dtype="int8")
    model = get_model(mc).eval()
    calls = set()

    def stub(q, w_packed, kernel, rescale, bias, stride, pads, s_out=None):
        b, h, w, _ = q.shape
        cout = w_packed.shape[0]
        calls.add((tuple(q.shape), cout, kernel, stride, tuple(pads)))
        return torch.zeros((b, -(-h // stride), -(-w // stride), cout),
                           dtype=torch.bfloat16 if s_out is None
                           else torch.int8)

    original = int8_conv.int8_conv
    int8_conv.int8_conv = stub
    try:
        with torch.inference_mode():
            model(torch.zeros((1, mc.hin, mc.win, 3)))
    finally:
        int8_conv.int8_conv = original
    return calls


def test_plans_are_the_launchers_instances():
    assert set(int8_conv.PLANS) == _launcher_plans()
    assert len(int8_conv.PLANS) == 2


@pytest.mark.parametrize("name", ZOO)
def test_tile_plan_covers_the_zoos_int8_forwards(name):
    calls = _int8_calls(name)
    assert len(calls) >= 5
    for shape, cout, k, stride, pads in calls:
        _, h, w, c = shape
        args = (BATCH, h, w, int8_conv.padded(c), cout, k, stride, pads)
        plan = int8_conv.tile_plan(*args)
        assert plan in int8_conv.PLANS
        assert plan[1] == (64 if cout <= 64 else 128)
        # the SAME padding's im2col corners, which the launcher holds to
        # [-128, 127]
        ho, wo = -(-h // stride), -(-w // stride)
        assert all(-128 <= (o - 1) * stride - p - (n - 1) <= 127
                   for o, p, n in ((ho, pads[0], h), (wo, pads[1], w)))


@pytest.mark.parametrize("args,plan", [
    # VGG19's 7x7 stage layers and 1x1s at 46x54: 104 blocks of 192
    # pixels, one wave of the 132 SMs
    ((8, 46, 54, 128, 128, 7, 1, (3, 3)), (192, 128)),
    ((8, 46, 54, 192, 128, 7, 1, (3, 3)), (192, 128)),
    ((8, 46, 54, 128, 128, 1, 1, (0, 0)), (192, 128)),
    # many waves: three consumer warpgroups a block
    ((8, 46, 54, 512, 512, 3, 1, (1, 1)), (192, 128)),
    ((8, 184, 216, 64, 128, 3, 1, (1, 1)), (192, 128)),
    # up to 64 channels: 128 x 64, two an SM
    ((8, 368, 432, 64, 64, 3, 1, (1, 1)), (128, 64)),
    ((1, 10, 12, 64, 24, 1, 2, (0, 0)), (128, 64)),
    # less than a wave: the same 192 x 128 blocks
    ((1, 8, 16, 64, 128, 3, 1, (1, 1)), (192, 128)),
    ((2, 46, 54, 128, 256, 3, 1, (1, 1)), (192, 128)),
])
def test_tile_plan_fills_the_card(args, plan):
    assert int8_conv.tile_plan(*args) == plan


@pytest.mark.parametrize("args", kernel_inputs.INT8_REFUSED)
def test_tile_plan_refuses_what_the_launcher_refuses(args):
    with pytest.raises(ValueError, match="tile plan"):
        int8_conv.tile_plan(*args)
