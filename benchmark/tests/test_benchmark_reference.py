"""The plain reference agrees with the program at a small size on the CPU:
the float32 forwards with the program's float32 models on the same
weights, the decode with the program's decoder on the same maps, the
letterbox with the program's loader, plane for plane."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import BIG_SEED
from harness import scenes, weights
from reference import decode as rdecode
from reference import images as rimages
from reference import models

HIN, WIN = 96, 112


def _setup(arch: str, seed: int):
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.models import get_model

    cfg = default_config(arch)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=HIN, win=WIN, n_stages=2, compute_dtype="float32"))
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in get_model(cfg.model).state_dict().items()}
    sd = weights.make(shapes, seed, torch.device("cpu"), 0.05)
    rng = np.random.default_rng(seed)
    images = np.stack([scenes.render(rng, HIN, WIN, (2, 5))
                       for _ in range(2)])
    weights.scale_heads(sd, arch, 2, torch.from_numpy(images[:1]), 0.7, 5.0)
    return cfg, sd, images


@pytest.mark.parametrize("arch", ["mobilenet_thin", "vgg19"])
def test_forward_matches_program_float32(arch):
    from openpose_plus_tpu_torch.engine import Engine

    cfg, sd, images = _setup(arch, BIG_SEED)
    conf, paf = Engine(cfg, params=sd, device="cpu").forward(images)
    rconf, rpaf = models.forward(arch, sd, torch.from_numpy(images), 2)
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
    conf, paf = models.forward("mobilenet_thin", sd,
                               torch.from_numpy(images), 2)
    hb = decode_maps(conf, paf, pp)
    people, smoothed = rdecode.decode(conf, paf, dataclasses.asdict(pp))
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
