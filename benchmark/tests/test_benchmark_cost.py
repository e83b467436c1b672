"""The work counted from shapes against hand arithmetic, and the readers
that hold it against the card's peaks."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from conftest import BENCH
from harness import cost, profile


def _shapes(arch: str, **model) -> dict:
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.models import get_model

    cfg = default_config(arch)
    with torch.device("meta"):
        m = get_model(dataclasses.replace(cfg.model, **model))
        return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def _conv(h, w, cin, cout, k):
    return 2 * h * w * cin * cout * k * k


def test_vgg19_served_call_flops_by_hand():
    h, w = 368, 656
    hand = _conv(h, w, 3, 64, 3) + _conv(h, w, 64, 64, 3)
    h, w = h // 2, w // 2
    hand += _conv(h, w, 64, 128, 3) + _conv(h, w, 128, 128, 3)
    h, w = h // 2, w // 2
    hand += _conv(h, w, 128, 256, 3) + 3 * _conv(h, w, 256, 256, 3)
    h, w = h // 2, w // 2
    hand += _conv(h, w, 256, 512, 3) + _conv(h, w, 512, 512, 3)
    hand += _conv(h, w, 512, 256, 3) + _conv(h, w, 256, 128, 3)
    for out in (19, 38):                                   # stage 1
        hand += 3 * _conv(h, w, 128, 128, 3) + _conv(h, w, 128, 512, 1)
        hand += _conv(h, w, 512, out, 1)
        hand += 5 * (_conv(h, w, 185, 128, 7) + 4 * _conv(h, w, 128, 128, 7)
                     + _conv(h, w, 128, 128, 1) + _conv(h, w, 128, out, 1))
    got = cost.cnn_flops({"name": "vgg19", "hin": 368, "win": 656,
                          "n_stages": 6},
                         _shapes("vgg19", hin=368, win=656), 1)
    assert got == hand
    assert 484e9 < got < 486e9           # the port's bench: 484.81 GF


def test_fused_layer_bound_by_hand():
    b, h, w, c, f = 8, 46, 54, 384, 384
    px = b * h * w
    nbytes = 2 * (px * c + px * f + 9 * c + c + c * f + f)
    ops = px * c * 18 / 67e12 + px * c * f * 2 / 989e12
    assert cost.sepconv_bound(b, h, w, c, f) == pytest.approx(
        max(nbytes / 3.35e12, ops), rel=1e-12)
    assert nbytes / 3.35e12 > ops                           # bytes bound it


def test_mobilenet_fused_layers():
    with open(os.path.join(BENCH, "configs",
                           "mobilenet_thin-368x432-fused.json")) as f:
        config = json.load(f)
    layers = cost.fused_layers(_shapes("mobilenet_thin"),
                               config["fused_layers"], (46, 54))
    assert len(layers) == 41
    assert layers[:5] == [(46, 54, 192, 192), (46, 54, 192, 384)] + \
        [(46, 54, 384, 384)] * 3
    assert layers[5] == (46, 54, 480, 128)
    assert layers.count((46, 54, 537, 128)) == 10


class _Run:
    """What the two readers read, without a card."""

    def __init__(self, trace, images=0, window_s=1.0):
        self.trace, self.images, self.window_s = trace, images, window_s
        self.batch = 8
        self.device = torch.device("cuda")
        self.model = {"name": "mobilenet_thin", "hin": 368, "win": 432,
                      "stride": 8, "n_stages": 6}
        self.shapes = _shapes("mobilenet_thin")
        with open(os.path.join(BENCH, "configs",
                               "mobilenet_thin-368x432-fused.json")) as f:
            self.cell = type("C", (), {"config": json.load(f)})()

    def flops_per_image(self):
        return cost.cnn_flops(self.model, self.shapes, 1)


def test_roofline_and_mfu_readers():
    from harness import spec

    layers = cost.fused_layers(_Run(None).shapes,
                               _Run(None).cell.config["fused_layers"],
                               (46, 54))
    bound = sum(cost.sepconv_bound(8, *x) for x in layers)
    trace = profile.Trace(1.0, 0.5, {
        "void fused_sepconv_kernel<2, 8, 64, true>(...)": [4 * bound, 82],
        "cudnn": [0.1, 5]}, {})
    roofline = spec.load_reader(BENCH, "fused_sepconv_roofline")
    assert roofline(_Run(trace)) == pytest.approx(50.0)     # 2 calls
    assert roofline(_Run(profile.Trace(1.0, 0.5, {}, {}))) is None
    mfu = spec.load_reader(BENCH, "mfu.serve")
    run = _Run(None, images=1000, window_s=2.0)
    assert mfu(run) == pytest.approx(
        100 * run.flops_per_image() * 500 / 989e12)
    assert 0 < mfu(run) < 100
