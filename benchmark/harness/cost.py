"""Work from shapes, and the chip's peaks: the yardstick of the rooflines
and of the MFU, counted from the layers and not from whatever implements
them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 on the CUDA cores,
3.35 TB/s of HBM3."""

from __future__ import annotations

import torch

from reference import models

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def cnn_flops(model: dict, shapes: dict, batch: int) -> float:
    """FLOPs of the convolutions of the configuration's network (its model
    section `model`) on a (batch, hin, win) input, 2 a multiply-add, every
    tap of a padded window counted: the reference run on shapes alone
    (meta tensors) under torch's FLOP counter."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    images = torch.empty((batch, model["hin"], model["win"], 3),
                         dtype=torch.uint8, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        models.forward(model, sd, images)
    return float(counter.get_total_flops())


def sepconv_bound(b: int, h: int, w: int, c: int, f: int) -> float:
    """The least seconds one fused separable layer (3x3 depthwise + ReLU,
    1x1 pointwise + ReLU, bf16 in and out) can take: its bytes, each read
    or written once (x, y, the four weight arrays in bf16) over the HBM
    rate, against its operations at peak: the depthwise's 9 products and
    9 adds a channel-pixel in float32 on the CUDA cores, the pointwise's
    2 C F a pixel on the bf16 tensor cores; the larger of the two."""
    px = b * h * w
    nbytes = 2 * (px * (c + f) + 10 * c + c * f + f)
    ops = px * 18 * c / F32_FLOPS + px * 2 * c * f / BF16_FLOPS
    return max(nbytes / HBM_BYTES, ops)


def fused_layers(shapes: dict, prefixes: list, grid: tuple[int, int]
                 ) -> list[tuple[int, int, int, int]]:
    """(h, w, c, f) of every separable layer whose name starts with one of
    `prefixes`, on the stride-8 `grid`."""
    layers = []
    for name, shape in shapes.items():
        if name.endswith(".dw_weight") and name.startswith(tuple(prefixes)):
            pw = shapes[name[:-len("dw_weight")] + "pw_weight"]
            layers.append((*grid, shape[0], pw[0]))
    return layers
