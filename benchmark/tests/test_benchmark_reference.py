"""The plain reference agrees with the program at a small size on the CPU:
the float32 forwards with the program's float32 models on the same
weights, the decode with the program's decoder on the same maps, the
letterbox with the program's loader, plane for plane. Its readings of one
seed are pinned, so that moving its code shows as any change in them."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, BIG_SEED
from harness import cost, scenes, weights
from reference import decode as rdecode
from reference import images as rimages
from reference import models, oracle

HIN, WIN = 96, 112
POSTPROC = {"max_peaks": 16, "max_humans": 32, "peak_threshold": 0.05,
            "paf_n_samples": 10, "paf_sample_threshold": 0.05,
            "paf_inlier_ratio": 0.8, "min_parts_per_human": 3,
            "min_human_score": 0.0, "upsample_factor": 2,
            "smooth_sigma": 1.25}
# What the reference reads at BIG_SEED, HIN x WIN and two stages (the
# CPU build of torch on two threads): sha256 digests (16 hex digits) of
# the seeded state_dict, of it once the heads are scaled, of the float32
# and the bf16-stored (conf, paf), and of the oracle's people of the
# float32 maps; the heads' gains; and the network's FLOPs an image at its
# cell's full shape (configs/<config>.json).
PINNED = {
    "mobilenet_thin": {
        "config": "mobilenet_thin-368x432-fused",
        "state_dict": "97e6c3cfc4de72dc", "scaled": "2c96341385471083",
        "gains": (1.2322673420883672, 7.59334690707143),
        "maps": "4e828fc6566d4e19", "maps_bf16": "1b75f231c00981c7",
        "people": "8cabbc8e9e0bbca8", "n_people": [8, 4],
        "flops": 11164775184},
    "vgg19": {
        "config": "vgg19-368x656",
        "state_dict": "498779b2e753c635", "scaled": "09cbef4d85b3d743",
        "gains": (0.6510787214164714, 3.0583862982557815),
        "maps": "ff1d25a38b95a2f6", "maps_bf16": "7d075dd993e79cf1",
        "people": "aed6ffd8816ec17d", "n_people": [7, 9],
        "flops": 484634285056},
}


PEAKS = {"conf_max": 0.7, "paf_max": 5.0}


def _model(arch: str) -> dict:
    """The model section of a network at HIN x WIN with two stages."""
    return {"name": arch, "hin": HIN, "win": WIN, "n_stages": 2}


def _shapes(arch: str, **model) -> dict:
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.models import get_model

    cfg = default_config(arch)
    with torch.device("meta"):
        m = get_model(dataclasses.replace(cfg.model, **model))
        return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def _seeded(arch: str, seed: int):
    """(shapes, weights from the seed, two scenes) at HIN x WIN."""
    shapes = _shapes(arch, hin=HIN, win=WIN, n_stages=2,
                     compute_dtype="float32")
    sd = weights.make(shapes, seed, torch.device("cpu"), 0.05,
                      _model(arch))
    rng = np.random.default_rng(seed)
    images = np.stack([scenes.render(rng, HIN, WIN, (2, 5))
                       for _ in range(2)])
    return shapes, sd, images


def _setup(arch: str, seed: int):
    from openpose_plus_tpu_torch.config import default_config

    cfg = default_config(arch)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=HIN, win=WIN, n_stages=2, compute_dtype="float32"))
    _, sd, images = _seeded(arch, seed)
    weights.scale_heads(sd, _model(arch), torch.from_numpy(images[:1]),
                        PEAKS)
    return cfg, sd, images


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", sorted(PINNED))
def test_readings_are_pinned(arch):
    pin = PINNED[arch]
    shapes, sd, images = _seeded(arch, BIG_SEED)
    assert _digest(sd[n] for n in shapes) == pin["state_dict"]
    gains = weights.scale_heads(sd, _model(arch),
                                torch.from_numpy(images[:1]), PEAKS)
    assert gains == pin["gains"]
    assert _digest(sd[n] for n in shapes) == pin["scaled"]
    x = torch.from_numpy(images)
    conf, paf = models.forward(_model(arch), sd, x)
    assert _digest([conf, paf]) == pin["maps"]
    assert _digest(models.forward(_model(arch), sd, x, bf16=True)) == \
        pin["maps_bf16"]
    skel = oracle.load_skeleton(models.network(arch).SKELETON)
    people, _ = rdecode.decode(conf, paf, POSTPROC, skel)
    canon = [[[sorted((p, repr(x), repr(y), repr(s))
                      for p, (x, y, s) in h.parts.items()),
               repr(h.score), h.n_parts] for h in img] for img in people]
    assert [len(p) for p in people] == pin["n_people"]
    assert hashlib.sha256(json.dumps(canon).encode()).hexdigest()[:16] == \
        pin["people"]
    with open(os.path.join(BENCH, "configs", f"{pin['config']}.json")) as f:
        m = json.load(f)["model"]
    full = _shapes(arch, **{k: m[k] for k in ("hin", "win", "n_stages")})
    assert cost.cnn_flops(m, full, 1) == pin["flops"]


@pytest.mark.parametrize("arch", ["mobilenet_thin", "vgg19"])
def test_forward_matches_program_float32(arch):
    from openpose_plus_tpu_torch.engine import Engine

    cfg, sd, images = _setup(arch, BIG_SEED)
    conf, paf = Engine(cfg, params=sd, device="cpu").forward(images)
    rconf, rpaf = models.forward(_model(arch), sd,
                                 torch.from_numpy(images))
    for got, want in ((conf, rconf), (paf, rpaf)):
        scale = float(want.abs().max())
        assert scale > 0.1
        assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("fidelity", [False, True])
def test_decode_matches_program_decoder(fidelity):
    from openpose_plus_tpu_torch.config import PostprocConfig
    from openpose_plus_tpu_torch.postproc import decode_maps

    pp = PostprocConfig().fidelity() if fidelity else PostprocConfig()
    _, sd, images = _setup("mobilenet_thin", 7)
    conf, paf = models.forward(_model("mobilenet_thin"), sd,
                               torch.from_numpy(images))
    hb = decode_maps(conf, paf, pp)
    people, smoothed = rdecode.decode(conf, paf, dataclasses.asdict(pp),
                                      oracle.load_skeleton("coco18"))
    assert smoothed.shape[1:3] == (HIN // 8 * pp.upsample_factor,
                                   WIN // 8 * pp.upsample_factor)
    found = 0
    for i, ref in enumerate(people):
        rows = np.nonzero(hb.valid[i].numpy())[0]
        assert len(rows) == len(ref)
        got = sorted([(int(p), float(hb.coords[i, m, p, 0]),
                       float(hb.coords[i, m, p, 1]))
                      for p in np.nonzero(hb.part_valid[i, m].numpy())[0]]
                     for m in rows)
        want = sorted([(p, x, y) for p, (x, y, _) in sorted(h.parts.items())]
                      for h in ref)
        for g, r in zip(got, want):
            assert [p for p, _, _ in g] == [p for p, _, _ in r]
            assert np.allclose(np.array(g)[:, 1:], np.array(r)[:, 1:],
                               atol=1e-5)
        found += len(ref)
    assert found > 0


def test_letterbox_matches_program_loader():
    from openpose_plus_tpu_torch import loader

    rng = np.random.default_rng(3)
    for h, w in ((1080, 1920), (720, 1280), (300, 200)):
        img = scenes.render(rng, h, w, (1, 3))
        frame, fscale, fpads = loader.letterbox(img, 368, 432)
        rframe, rfscale, rfpads = rimages.letterbox_frame(img, 368, 432)
        assert np.array_equal(frame, rframe)
        assert (fscale, tuple(fpads)) == (rfscale, tuple(rfpads))


def test_unknown_network_names_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"networks/no_such_net\.py"):
        models.forward({"name": "no_such_net"}, {},
                       torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
