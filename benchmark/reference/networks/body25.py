"""CMU OpenPose BODY_25 (Cao et al. TPAMI 2019, arXiv:1812.08008;
`models/pose/body_25/pose_deploy.prototxt`): conv1_1 .. conv4_1 with ReLU
and 2x2 pools after blocks 1-3, conv4_2 (512), conv4_3_CPM (256) and
conv4_4_CPM (128) with PReLU: the feature F. Then four PAF stages (L2),
stage 0 reading F and stages 1-3 concat(F, the previous PAFs), and two
heatmap stages (L1) reading concat(F, the last PAFs) and concat(F, the
first heatmaps, the last PAFs). A stage: five dense blocks (three chained
3x3 convs with PReLU, their outputs concatenated), a 1x1 conv with PReLU,
the 1x1 prediction; widths 96 and 256 in stage 0 of each kind, 128 and 512
after; 52 PAF channels, 26 heatmaps. Parameters carry the served
program's names; a PReLU's slope is `<conv>.slope`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import models

FAMILY = "paf"
SKELETON = "body25"
OTHER_STD = 0.25                 # the PReLU slopes, drawn about zero
N_PAF, N_CONF, N_BLOCKS = 4, 2, 5
FRONT = (("conv1", 2, True), ("conv2", 2, True), ("conv3", 4, True),
         ("conv4", 1, False))
PRELU_FRONT = ("conv4_2", "conv4_3_cpm", "conv4_4_cpm")


def conv_prelu(x, sd: dict, name: str, r):
    """A SAME conv, its bias, then PReLU (max(y, 0) + slope min(y, 0), a
    slope a channel); `r` rounds what the network stores."""
    w = sd[f"{name}.weight"]
    top, bottom = models._same(x.shape[2], w.shape[2], 1)
    left, right = models._same(x.shape[3], w.shape[3], 1)
    y = F.conv2d(F.pad(r(x), (left, right, top, bottom)), r(w.float()),
                 None)
    y = r(r(y) + r(sd[f"{name}.bias"].float()).view(1, -1, 1, 1))
    slope = r(sd[f"{name}.slope"].float()).view(1, -1, 1, 1)
    return r(torch.where(y >= 0, y, slope * y))


def stage(x, sd: dict, name: str, r):
    for i in range(1, N_BLOCKS + 1):
        a = conv_prelu(x, sd, f"{name}.Mconv{i}.conv0", r)
        b = conv_prelu(a, sd, f"{name}.Mconv{i}.conv1", r)
        x = torch.cat([a, b, conv_prelu(b, sd, f"{name}.Mconv{i}.conv2", r)],
                      dim=1)
    x = conv_prelu(x, sd, f"{name}.Mconv6", r)
    return models.conv(x, sd[f"{name}.Mconv7.weight"],
                       sd[f"{name}.Mconv7.bias"], relu=False)


def _check(model: dict) -> None:
    n_stages = model["n_stages"]
    if n_stages != N_PAF + N_CONF:
        raise ValueError(f"BODY_25 has {N_PAF} PAF and {N_CONF} heatmap "
                         f"stages, not {n_stages}")


def forward(x, sd: dict, model: dict, r):
    _check(model)
    for prefix, n, pool in FRONT:
        for i in range(1, n + 1):
            x = models.conv(x, sd[f"{prefix}_{i}.weight"],
                            sd[f"{prefix}_{i}.bias"], r)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    for name in PRELU_FRONT:
        x = conv_prelu(x, sd, name, r)
    feature, paf = x, None
    for s in range(N_PAF):
        inp = feature if paf is None else torch.cat([feature, r(paf)], 1)
        paf = stage(inp, sd, f"stages.stage{s}_L2", r)
    conf = None
    for s in range(N_CONF):
        inp = torch.cat([feature, r(paf)] if conf is None
                        else [feature, r(conf), r(paf)], 1)
        conf = stage(inp, sd, f"stages.stage{s}_L1", r)
    return conf, paf


def heads(model: dict) -> tuple[str, str]:
    _check(model)
    return (f"stages.stage{N_CONF - 1}_L1.Mconv7",
            f"stages.stage{N_PAF - 1}_L2.Mconv7")


def predictions(model: dict) -> list[str]:
    _check(model)
    return ([f"stages.stage{s}_L2.Mconv7" for s in range(N_PAF)]
            + [f"stages.stage{s}_L1.Mconv7" for s in range(N_CONF)])
