"""The port's numpy grouping oracle (`openpose_plus_tpu_torch/postproc/
oracle.py`) against the JAX package's, and the port's decoder against it.

- Function by function, the port's oracle equals the JAX package's on
  seeded maps exactly (both are numpy): `upsample_maps`, `smooth_maps`,
  `find_peaks`, `score_limb_candidates`, `greedy_assign`, `assemble_humans`,
  `refine_coords` and `decode_oracle`; the copied `limb_score_with_prior`
  equals its original.
- The port's `decode_maps` on the CPU matches the port's oracle on the same
  preprocessed maps (the port's `nms.upsample_smooth` / `nms.upsample`), on
  tests/test_postproc_parity.py's cases and with its criteria: clean scenes
  of 1-3 people, noisy scenes, pure noise, empty maps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openpose_plus_tpu.config import PostprocConfig as JaxPostprocConfig
from openpose_plus_tpu.postproc import common as jcommon
from openpose_plus_tpu.postproc import oracle as joracle
from openpose_plus_tpu_torch import skeleton
from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.postproc import common as tcommon
from openpose_plus_tpu_torch.postproc import decode_maps, nms
from openpose_plus_tpu_torch.postproc import oracle

from tests import kernel_inputs

torch.set_num_threads(2)

# tests/test_postproc_parity.py's configuration
CFG = PostprocConfig(upsample_factor=2, smooth_sigma=1.0, max_peaks=16,
                     max_humans=32)
JCFG = JaxPostprocConfig(upsample_factor=2, smooth_sigma=1.0, max_peaks=16,
                         max_humans=32)
NOISE_CFG = dataclasses.replace(CFG, upsample_factor=1, smooth_sigma=0.0)


def _scene(noise=0.0, seed=0, n_people=2):
    """test_postproc_parity.py's scene: fractional keypoints, 46x54 maps."""
    people = [kernel_inputs.standing_person(12.3 + 14.6 * i, 20.2,
                                            0.9 + 0.11 * i)
              for i in range(n_people)]
    return kernel_inputs.make_maps(people, 46, 54, noise=noise, seed=seed)


def _pure_noise(seed):
    rng = np.random.default_rng(seed + 100)
    conf = rng.uniform(0, 0.4, (46, 54, 19)).astype(np.float32)
    paf = rng.uniform(-1, 1, (46, 54, 38)).astype(np.float32)
    return conf, paf


MAPS = {"clean": lambda: _scene(n_people=3),
        "noisy": lambda: _scene(noise=0.15, seed=2, n_people=3),
        "pure_noise": lambda: _pure_noise(1)}


def _prepared(kind):
    """Both oracles' inputs: maps upsampled and smoothed by the oracle."""
    conf, paf = MAPS[kind]()
    up = oracle.upsample_maps(conf, CFG.upsample_factor)
    return (oracle.smooth_maps(up, CFG.smooth_sigma),
            oracle.upsample_maps(paf, CFG.upsample_factor))


def _assert_peaks_equal(a, b):
    for field in ("ys", "xs", "scores"):
        for part, (x, y) in enumerate(zip(getattr(a, field),
                                          getattr(b, field))):
            np.testing.assert_array_equal(x, y, f"{field}[{part}]")


def _assert_humans_equal(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert (ha.parts, ha.score, ha.n_parts) == (hb.parts, hb.score,
                                                    hb.n_parts)


# ------------------------------------------------- port oracle vs JAX's ---

@pytest.mark.parametrize("factor", [1, 2, 4])
def test_upsample_maps_equals_jax(factor):
    conf, paf = _scene(noise=0.1, seed=7)
    for maps in (conf, paf):
        np.testing.assert_array_equal(oracle.upsample_maps(maps, factor),
                                      joracle.upsample_maps(maps, factor))


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
def test_smooth_maps_equals_jax(sigma):
    conf, _ = _scene(noise=0.1, seed=8)
    np.testing.assert_array_equal(oracle.smooth_maps(conf, sigma),
                                  joracle.smooth_maps(conf, sigma))


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_find_peaks_equals_jax(kind):
    smoothed, _ = _prepared(kind)
    for max_peaks in (None, CFG.max_peaks):
        _assert_peaks_equal(
            oracle.find_peaks(smoothed, CFG.peak_threshold, max_peaks),
            joracle.find_peaks(smoothed, CFG.peak_threshold, max_peaks))


def test_find_peaks_on_plateaus_equals_jax():
    """Integer-grid keypoints: exact plateaus, one peak each."""
    people = [kernel_inputs.standing_person(10, 8),
              kernel_inputs.standing_person(10, 30)]
    conf, _ = kernel_inputs.make_maps(people, 46, 54)
    smoothed = oracle.smooth_maps(oracle.upsample_maps(conf, 2), 1.0)
    peaks = oracle.find_peaks(smoothed, CFG.peak_threshold, CFG.max_peaks)
    _assert_peaks_equal(peaks, joracle.find_peaks(
        smoothed, CFG.peak_threshold, CFG.max_peaks))
    assert sum(len(s) for s in peaks.scores) == 2 * skeleton.N_PARTS


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_score_greedy_and_assemble_equal_jax(kind):
    """The limb stages on the same peaks, limb by limb, then the merge."""
    smoothed, paf_u = _prepared(kind)
    peaks = oracle.find_peaks(smoothed, CFG.peak_threshold, CFG.max_peaks)
    connections, jconnections = [], []
    for limb in range(skeleton.N_LIMBS):
        args = (paf_u, peaks, limb, CFG.paf_n_samples,
                CFG.paf_sample_threshold, CFG.paf_inlier_ratio)
        cands = oracle.score_limb_candidates(*args)
        assert cands == joracle.score_limb_candidates(*args), limb
        ia, ib = skeleton.COCO_PAIRS[limb]
        sizes = (len(peaks.scores[ia]), len(peaks.scores[ib]))
        connections.append(oracle.greedy_assign(cands, *sizes))
        jconnections.append(joracle.greedy_assign(cands, *sizes))
        assert connections[-1] == jconnections[-1], limb
    args = (peaks, CFG.max_peaks, CFG.min_parts_per_human,
            CFG.min_human_score, CFG.max_humans)
    _assert_humans_equal(oracle.assemble_humans(connections, *args),
                         joracle.assemble_humans(jconnections, *args))


def test_refine_coords_equals_jax():
    smoothed, _ = _prepared("noisy")
    rng = np.random.default_rng(4)
    h, w, _ = smoothed.shape
    for _ in range(64):
        x, y = float(rng.integers(0, w)), float(rng.integers(0, h))
        part = int(rng.integers(0, skeleton.N_PARTS))
        assert (oracle.refine_coords(smoothed, x, y, part)
                == joracle.refine_coords(smoothed, x, y, part))


@pytest.mark.parametrize("preprocessed", [False, True])
@pytest.mark.parametrize("kind", sorted(MAPS))
def test_decode_oracle_equals_jax(kind, preprocessed):
    maps = _prepared(kind) if preprocessed else MAPS[kind]()
    humans = oracle.decode_oracle(*maps, CFG, preprocessed=preprocessed)
    _assert_humans_equal(humans, joracle.decode_oracle(
        *maps, JCFG, preprocessed=preprocessed))
    if kind == "clean":
        assert sum(h.n_parts >= 8 for h in humans) >= 3


def test_limb_score_with_prior_equals_jax():
    rng = np.random.default_rng(5)
    mean_dot = rng.uniform(-1, 1, 256).astype(np.float32)
    dist = np.concatenate([[0.0, 1e-5], rng.uniform(0, 200, 254)]).astype(
        np.float32)
    for h in (46, 92, 368):
        np.testing.assert_array_equal(
            tcommon.limb_score_with_prior(mean_dot, dist, h),
            jcommon.limb_score_with_prior(mean_dot, dist, h))


# ---------------------------------------- the port's decoder vs oracle ---

def _decode_both(conf, paf, cfg):
    """The port's decoder on the raw maps, the oracle on the maps the
    decoder preprocesses them to."""
    c, p = torch.from_numpy(conf[None]), torch.from_numpy(paf[None])
    smoothed = nms.upsample_smooth(c, cfg.upsample_factor, cfg.smooth_sigma)
    paf_u = nms.upsample(p, cfg.upsample_factor)
    o_humans = oracle.decode_oracle(smoothed[0].numpy(), paf_u[0].numpy(),
                                    cfg, preprocessed=True)
    return o_humans, decode_maps(c, p, cfg)


def _port_humans(batch):
    out = []
    for m in np.flatnonzero(batch.valid[0].numpy()):
        pv = batch.part_valid[0, m].numpy()
        coords = batch.coords[0, m].numpy()
        scores = batch.part_scores[0, m].numpy()
        parts = {p: (coords[p, 0], coords[p, 1], scores[p])
                 for p in range(skeleton.N_PARTS) if pv[p]}
        out.append((parts, float(batch.score[0, m]),
                    int(batch.n_parts[0, m])))
    return out


def _assert_same_humans(o_humans, t_humans):
    """test_postproc_parity.py's criteria: the same count, and every oracle
    human matched once by part set and count, mean score and every part's
    coordinates and score within 1e-3."""
    assert len(o_humans) == len(t_humans), (
        f"human count: oracle {len(o_humans)} vs port {len(t_humans)}")
    unmatched = list(range(len(t_humans)))
    for oh in o_humans:
        omean = oh.score / oh.n_parts
        hit = None
        for i in unmatched:
            parts, score, cnt = t_humans[i]
            if cnt != oh.n_parts or set(parts) != set(oh.parts):
                continue
            if abs(score - omean) > 1e-3:
                continue
            if all(abs(parts[p][k] - oh.parts[p][k]) < 1e-3
                   for p in oh.parts for k in range(3)):
                hit = i
                break
        assert hit is not None, f"no port match for oracle human {oh}"
        unmatched.remove(hit)


@pytest.mark.parametrize("n_people", [1, 2, 3])
def test_decode_maps_matches_the_oracle_clean(n_people):
    o_humans, batch = _decode_both(*_scene(n_people=n_people), CFG)
    assert sum(1 for h in o_humans if h.n_parts >= 8) >= n_people
    _assert_same_humans(o_humans, _port_humans(batch))


@pytest.mark.parametrize("seed", range(5))
def test_decode_maps_matches_the_oracle_noisy(seed):
    o_humans, batch = _decode_both(
        *_scene(noise=0.15, seed=seed, n_people=3), CFG)
    _assert_same_humans(o_humans, _port_humans(batch))


@pytest.mark.parametrize("seed", range(5))
def test_decode_maps_matches_the_oracle_pure_noise(seed):
    """Spurious peaks everywhere: ties and conflicts."""
    o_humans, batch = _decode_both(*_pure_noise(seed), NOISE_CFG)
    _assert_same_humans(o_humans, _port_humans(batch))


def test_decode_maps_matches_the_oracle_empty():
    conf = np.zeros((46, 54, 19), np.float32)
    paf = np.zeros((46, 54, 38), np.float32)
    o_humans, batch = _decode_both(conf, paf, CFG)
    assert o_humans == [] and int(batch.valid.sum()) == 0
