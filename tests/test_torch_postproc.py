"""Port decoder vs the JAX decoder, stage by stage and end to end.

Each stage is fed the reference's own floats (as test_postproc_parity.py
does for the numpy oracle), so exact stages compare exactly: peak sets,
sample coordinates, PAF samples, greedy order and merge tables bit for bit.
The plain PyTorch versions of the decoder's three CUDA kernels (PAF
sampling, greedy assignment, subset merge) must equal the Pallas kernels in
interpret mode (and the XLA twins, where the reference has them).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu import skeleton
from openpose_plus_tpu.config import PostprocConfig
from openpose_plus_tpu.ops.pallas.greedy import greedy_assign_pallas
from openpose_plus_tpu.ops.pallas.merge import assemble_pallas
from openpose_plus_tpu.postproc import (
    common as jcommon, decode as jdecode, group as jgroup, nms as jnms,
    paf as jpaf)
from openpose_plus_tpu_torch import config as tconfig, skeletons
from openpose_plus_tpu_torch.ops.cuda import greedy as tgreedy
from openpose_plus_tpu_torch.ops.cuda import merge as tmerge
from openpose_plus_tpu_torch.ops.cuda import paf_sample as tpaf_sample
from openpose_plus_tpu_torch.postproc import decode_maps
from openpose_plus_tpu_torch.postproc import nms as tnms, paf as tpaf

from tests import kernel_inputs, maputil

torch.set_num_threads(2)

CFG = PostprocConfig()                   # served default: K=16, M=32, f=2
FIDELITY = PostprocConfig().fidelity()   # K=32, f=8, sigma 5


def _port(cfg):
    """The JAX package's PostprocConfig as the port's own, field for
    field."""
    return tconfig.PostprocConfig(**dataclasses.asdict(cfg))


def _scene(n_people, noise=0.0, seed=0, h=46, w=54):
    # Generic fractional keypoints: no exact plateaus after upsampling
    # (exact plateaus are covered by the integer-grid case below).
    people = [maputil.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                      0.93 + 0.1 * i)
              for i in range(n_people)]
    return maputil.make_maps(people, h, w, noise=noise, seed=seed)


def _maps(kind):
    if kind == "plateau":     # integer-grid keypoints -> exact 2x2 plateaus
        people = [maputil.standing_person(10, 8),
                  maputil.standing_person(10, 30)]
        return maputil.make_maps(people, 46, 54)
    if kind == "pure_noise":
        rng = np.random.default_rng(100)
        return (rng.uniform(0, 0.4, (46, 54, 19)).astype(np.float32),
                rng.uniform(-1, 1, (46, 54, 38)).astype(np.float32))
    n, noise, seed = {"clean": (3, 0.0, 0), "noisy": (3, 0.15, 1),
                      "very_noisy": (2, 0.2, 2)}[kind]
    return _scene(n, noise, seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _peakset(jpeaks):
    """JAX PeakSet of one image -> port PeakSet with B=1."""
    return tnms.PeakSet(**{f.name: _t(getattr(jpeaks, f.name))[None]
                           for f in dataclasses.fields(tnms.PeakSet)})


# --------------------------------------------------------------- maps ---

@pytest.mark.parametrize("factor,sigma", [(2, 1.25), (2, 1.0), (8, 5.0),
                                          (1, 0.0)])
def test_upsample_smooth_matches_jax(factor, sigma):
    """~1 ulp: the port contracts in float64 and rounds once, the reference
    in float32 at HIGHEST (the tolerance the reference grants its own
    oracle parity, test_postproc_parity.py::test_preprocess_numerics)."""
    conf, _ = _maps("noisy")
    ref = np.asarray(jnms.upsample_smooth(jnp.asarray(conf), factor, sigma))
    out = tnms.upsample_smooth(_t(conf)[None], factor, sigma)[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("factor,atol", [
    (1, 0.0), (2, 2e-6), (8, 2e-6),
    # non-dyadic weights (1/6, 1/2 +- 1/3) are rounded to float32 in the
    # operator matrix, and differently inside jax.image.resize
    (3, 2e-5)])
def test_upsample_matches_jax_resize(factor, atol):
    _, paf = _maps("noisy")
    ref = np.asarray(jnms.upsample(jnp.asarray(paf), factor))
    out = tnms.upsample(_t(paf)[None], factor)[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["plateau", "clean", "noisy", "very_noisy",
                                  "pure_noise"])
@pytest.mark.parametrize("cfg", [CFG, FIDELITY], ids=["default", "fidelity"])
def test_find_peaks_exact(kind, cfg):
    """Same smoothed floats in -> the same peak set out, bit for bit:
    plateau tie-break (lowest flat index), top-K ties (lowest index),
    exhausted slots at index 0, border zero-offset refinement."""
    conf, _ = _maps(kind)
    smoothed = np.asarray(jnms.upsample_smooth(
        jnp.asarray(conf), cfg.upsample_factor, cfg.smooth_sigma))
    ref = jnms.find_peaks(jnp.asarray(smoothed), cfg.peak_threshold,
                          cfg.max_peaks)
    out = tnms.find_peaks(_t(smoothed)[None], cfg.peak_threshold,
                          cfg.max_peaks)
    for f in dataclasses.fields(tnms.PeakSet):
        np.testing.assert_array_equal(getattr(out, f.name)[0].numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      f.name)
    if kind == "plateau":     # one peak per plateau, two people
        assert int(out.valid.sum()) == 2 * skeleton.N_PARTS


def test_topk_ties_break_to_lowest_index():
    flat = torch.tensor([[0.5, 0.9, 0.5, 0.9, -torch.inf, 0.5]])
    score, idx = tnms._topk_stable(flat, 5)
    assert idx.tolist() == [[1, 3, 0, 2, 5]]
    assert torch.equal(score, torch.tensor([[0.9, 0.9, 0.5, 0.5, 0.5]]))


# ---------------------------------------------------- candidate scores ---

def _jax_sample_coords(peaks, n_samples):
    """The reference's sample-point expression (paf.py score_candidates)."""
    pairs = jnp.asarray(skeleton.pairs_array())
    fracs = jnp.asarray(jcommon.line_sample_fracs(n_samples))
    ax = peaks.x[pairs[:, 0]].astype(jnp.float32)
    ay = peaks.y[pairs[:, 0]].astype(jnp.float32)
    bx = peaks.x[pairs[:, 1]].astype(jnp.float32)
    by = peaks.y[pairs[:, 1]].astype(jnp.float32)
    dx = bx[:, None, :] - ax[:, :, None]
    dy = by[:, None, :] - ay[:, :, None]
    sx = jnp.round(ax[:, None, :, None]
                   + fracs[None, :, None, None] * dx[:, None])
    sy = jnp.round(ay[:, None, :, None]
                   + fracs[None, :, None, None] * dy[:, None])
    return sy.astype(jnp.int32), sx.astype(jnp.int32)


@pytest.mark.parametrize("kind", ["clean", "noisy", "pure_noise"])
@pytest.mark.parametrize("cfg", [CFG, FIDELITY], ids=["default", "fidelity"])
def test_score_candidates_matches_jax(kind, cfg):
    """Sample coordinates (L, S, K, K) exactly (round half to even on both
    sides); scores to ~1 ulp of the upsampled PAF (the port gathers from a
    float64-contracted upsample, the reference from jax.image.resize), with
    the same -inf pattern."""
    conf, paf = _maps(kind)
    f = cfg.upsample_factor
    smoothed = jnms.upsample_smooth(jnp.asarray(conf), f, cfg.smooth_sigma)
    peaks = jnms.find_peaks(smoothed, cfg.peak_threshold, cfg.max_peaks)
    ref = np.asarray(jax.jit(functools.partial(
        jpaf.score_candidates, n_samples=cfg.paf_n_samples,
        sample_threshold=cfg.paf_sample_threshold,
        inlier_ratio=cfg.paf_inlier_ratio, lowres_factor=f))(
            jnp.asarray(paf), peaks))
    tpeaks = _peakset(peaks)
    out = tpaf.score_candidates(
        _t(paf)[None], tpeaks, cfg.paf_n_samples, cfg.paf_sample_threshold,
        cfg.paf_inlier_ratio, lowres_factor=f)[0].numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=1e-5)

    sy, sx = jax.jit(_jax_sample_coords, static_argnums=1)(
        peaks, cfg.paf_n_samples)
    pairs = torch.as_tensor(skeleton.pairs_array()).long()
    ax = tpeaks.x[:, pairs[:, 0]].float()
    ay = tpeaks.y[:, pairs[:, 0]].float()
    tsy, tsx = tpaf.sample_coords(
        ax, ay, tpeaks.x[:, pairs[:, 1]].float()[:, :, None, :]
        - ax[:, :, :, None],
        tpeaks.y[:, pairs[:, 1]].float()[:, :, None, :] - ay[:, :, :, None],
        torch.from_numpy(jcommon.line_sample_fracs(cfg.paf_n_samples)))
    np.testing.assert_array_equal(tsy[0].numpy(), np.asarray(sy))
    np.testing.assert_array_equal(tsx[0].numpy(), np.asarray(sx))


# ------------------------------------------------- PAF sampler (kernel 4) ---

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,w", [(46, 54), (92, 164)])
def test_plain_sample_paf_matches_pallas(seed, h, w):
    """The plain gather against `sample_paf_pallas` in interpret mode (as
    tests/test_lowering_equiv.py:174-196 runs it): bit-exact."""
    import unittest.mock

    from jax.experimental import pallas as pl

    from openpose_plus_tpu.ops.pallas.paf_sample import sample_paf_pallas

    paf, sy, sx = kernel_inputs.paf_samples(np.random.default_rng(seed), 1,
                                            h, w, 16)
    with unittest.mock.patch.object(
            pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True)):
        ref = sample_paf_pallas(jnp.asarray(paf[0]), jnp.asarray(sy[0]),
                                jnp.asarray(sx[0]))
    chans = tpaf_sample.limb_channels(torch.device("cpu"),
                                       skeletons.COCO18)
    out = tpaf_sample.sample_paf_plain(_t(paf), _t(sy), _t(sx), chans)
    for o, r in zip(out, ref):
        assert o.shape == (1, 19, 10, 16, 16) and o.dtype == torch.float32
        np.testing.assert_array_equal(o[0].numpy(), np.asarray(r))


def test_sample_paf_wrapper_dispatch():
    """score_candidates samples through the wrapper: a CPU tensor takes the
    plain version (no launch); another device is refused."""
    paf, sy, sx = kernel_inputs.paf_samples(np.random.default_rng(2), 2, 9,
                                            11, 4, s=3)
    chans = tpaf_sample.limb_channels(torch.device("cpu"),
                                       skeletons.COCO18)
    args = (_t(paf), _t(sy), _t(sx), chans)
    before = tpaf_sample.launches
    out = tpaf_sample.sample_paf(*args)
    assert tpaf_sample.launches == before
    for o, r in zip(out, tpaf_sample.sample_paf_plain(*args)):
        assert torch.equal(o, r)
    with pytest.raises(ValueError, match="device"):
        tpaf_sample.sample_paf(*[t.to("meta") for t in args])


# ------------------------------------------------------ greedy (kernel 1) ---

# ties: kernel_inputs.limb_scores with or without its injected ties, or
# "signed_zero" (kernel_inputs.signed_zero_scores: -0.0 and +0.0 tie); K = 1,
# 5 and 31 put the index arithmetic off the powers of two
@pytest.mark.parametrize("k,seed,ties", [(8, 0, False), (16, 1, False),
                                         (16, 2, True), (16, 3, True),
                                         (32, 4, True), (1, 5, True),
                                         (5, 6, True), (31, 7, True),
                                         (16, 8, "signed_zero"),
                                         (32, 9, "signed_zero")])
def test_plain_greedy_matches_xla_and_pallas(k, seed, ties):
    rng = np.random.default_rng(seed)
    if ties == "signed_zero":
        scores = kernel_inputs.signed_zero_scores(rng, 3, k)
    else:
        scores = kernel_inputs.limb_scores(rng, 3, k, ties=ties)
    out = tgreedy.greedy_assign_plain(_t(scores), k)
    xla = jax.vmap(functools.partial(jpaf.greedy_assign, max_peaks=k))(
        jnp.asarray(scores))
    pallas = jax.vmap(functools.partial(
        greedy_assign_pallas, max_peaks=k, interpret=True))(
            jnp.asarray(scores))
    names = ("slot_a", "slot_b", "score", "valid")
    for ref in (xla, pallas):
        for name, o in zip(names, out):
            np.testing.assert_array_equal(o.numpy(),
                                          np.asarray(getattr(ref, name)),
                                          name)
    assert out[0].dtype == torch.int32 and out[3].dtype == torch.bool


def test_greedy_wrapper_dispatch():
    """A CPU tensor takes the plain version (no kernel launch); any other
    device is refused, never silently moved to the CPU."""
    scores = _t(kernel_inputs.limb_scores(np.random.default_rng(5), 1,
                                          16, ties=False))
    before = tgreedy.launches
    out = tpaf.greedy_assign(scores, 16)
    ref = tgreedy.greedy_assign_plain(scores, 16)
    assert tgreedy.launches == before
    np.testing.assert_array_equal(out.slot_a.numpy(), ref[0].numpy())
    with pytest.raises(ValueError, match="device"):
        tgreedy.greedy_assign(scores.to("meta"), 16)
    with pytest.raises(ValueError):
        tgreedy.greedy_assign_plain(scores, 8)


# ------------------------------------------------------- merge (kernel 2) ---

# kind: kernel_inputs.connections ("random") or one of the connection
# sets of kernel_inputs.merge_connections, at the table size it is meant
# for (kernel_inputs.MERGE_KINDS)
_MERGE_CASES = [pytest.param(k, m, seed, "random", id=f"{k}-{m}-{seed}")
                for k, m, seed in [(8, 16, 0), (8, 16, 1), (8, 4, 2),
                                   (16, 32, 3), (16, 32, 4), (16, 8, 5),
                                   (32, 32, 6)]]
_MERGE_CASES += [pytest.param(k, m, 10 + i, kind, id=f"{kind}-{k}")
                 for i, (kind, m) in enumerate(
                     kernel_inputs.MERGE_KINDS.items())
                 for k in (16, 32)]


@pytest.mark.parametrize("k,m,seed,kind", _MERGE_CASES)
def test_plain_merge_matches_xla_and_pallas(k, m, seed, kind):
    rng = np.random.default_rng(seed)
    b = 3
    fields = (kernel_inputs.connections(rng, b, k) if kind == "random"
              else kernel_inputs.merge_connections(rng, b, k, kind))
    peak_score = kernel_inputs.peak_scores(rng, b, k)
    parts, score, count = tmerge.assemble_plain(
        *map(_t, fields), _t(peak_score), k, m)
    jconns = jpaf.Connections(*map(jnp.asarray, fields))
    xla = jax.vmap(functools.partial(jgroup.assemble, max_peaks=k,
                                     max_humans=m))(
        jconns, jnp.asarray(peak_score.reshape(b, -1)))
    pallas = jax.vmap(functools.partial(assemble_pallas, max_peaks=k,
                                        max_humans=m, interpret=True))(
        jconns, jnp.asarray(peak_score))
    for ref in (xla, pallas):
        np.testing.assert_array_equal(parts.numpy(), np.asarray(ref.parts))
        np.testing.assert_array_equal(count.numpy(), np.asarray(ref.count))
        # bit-exact: score + (b_ps + cscore) etc., grouped as the reference
        np.testing.assert_array_equal(score.numpy(), np.asarray(ref.score))


def test_merge_wrapper_dispatch():
    rng = np.random.default_rng(7)
    fields = [_t(x) for x in kernel_inputs.connections(rng, 1, 16)]
    peak_score = _t(kernel_inputs.peak_scores(rng, 1, 16))
    before = tmerge.launches
    out = tmerge.assemble(*fields, peak_score, 16, 32)
    ref = tmerge.assemble_plain(*fields, peak_score, 16, 32)
    assert tmerge.launches == before
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    with pytest.raises(ValueError, match="device"):
        tmerge.assemble(*[f.to("meta") for f in fields],
                        peak_score.to("meta"), 16, 32)


# ----------------------------------------------------------- end to end ---

_DECODERS = {}


def _decode_both(kinds, cfg):
    maps = [_maps(kind) for kind in kinds]
    conf = np.stack([c for c, _ in maps])
    paf = np.stack([p for _, p in maps])
    if cfg not in _DECODERS:
        _DECODERS[cfg] = jdecode.build_decoder(cfg)
    ref = _DECODERS[cfg](conf, paf)
    out = decode_maps(_t(conf), _t(paf), _port(cfg))
    return ref, out


@pytest.mark.parametrize("cfg,atol_coord,atol_score", [
    # default: every stage agrees to ~1 ulp, so the skeletons do too
    (CFG, 1e-5, 1e-5),
    # fidelity (8x upsample, sigma 5): peak tops are so flat that a 1-ulp
    # difference in the smoothed map can move an integer peak by one pixel;
    # subpixel refinement recovers the location (coords still ~1e-7), but
    # the PAF samples of that peak's limbs move, so the human's mean score
    # moves by up to ~2e-3
    (FIDELITY, 1e-5, 5e-3)], ids=["default", "fidelity"])
def test_decode_maps_matches_jax(cfg, atol_coord, atol_score):
    ref, out = _decode_both(["clean", "noisy", "very_noisy", "pure_noise"],
                            cfg)
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=atol_coord)
    np.testing.assert_allclose(out.part_scores.numpy(),
                               np.asarray(ref.part_scores), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score),
                               rtol=0, atol=atol_score)
    assert out.coords.dtype == torch.float32
    assert out.n_parts.dtype == torch.int32


@pytest.mark.parametrize("n_people", [1, 2, 3])
def test_decode_finds_standing_people(n_people):
    conf, paf = _scene(n_people)
    out = decode_maps(_t(conf)[None], _t(paf)[None], _port(CFG))
    assert int(out.num_humans[0]) == n_people
    assert (out.n_parts[0, :n_people] == skeleton.N_PARTS).all()
    humans = out.to_list(0)
    assert len(humans) == n_people
    assert all(len(h["parts"]) == skeleton.N_PARTS for h in humans)


def test_empty_maps_and_unported_options():
    conf = torch.zeros((2, 46, 54, 19))
    paf = torch.zeros((2, 46, 54, 38))
    out = decode_maps(conf, paf, _port(CFG))
    assert not out.valid.any()
    assert out.coords.shape == (2, CFG.max_humans, 18, 2)
    quality = decode_maps(conf, paf, _port(CFG).quality())  # merge on
    assert not quality.valid.any()
    assert quality.coords.shape == (2, CFG.max_humans, 18, 2)


def test_non_finite_maps_decode_as_reference():
    """An inf in one conf pixel and a NaN in one PAF channel: the port
    gives the reference's outputs, NaN included. The reference looks the
    peaks up by a one-hot matmul (0 x inf = NaN), so every part score of
    the image with the inf is NaN; the port's gather reproduces that."""
    maps = [_maps("clean"), _maps("noisy"), _maps("clean")]
    conf = np.stack([c for c, _ in maps])
    paf = np.stack([p for _, p in maps])
    conf[0, 5, 7, 3] = np.inf
    paf[1, :, :, 11] = np.nan
    ref = jdecode.build_decoder(CFG)(conf, paf)
    out = decode_maps(_t(conf), _t(paf), _port(CFG))
    assert np.isnan(np.asarray(ref.part_scores)[0][np.asarray(
        ref.part_valid)[0]]).all()
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # the finite values agree to ~1 ulp (test_decode_maps_matches_jax);
    # NaN must stand where the reference's stands
    for name in ("coords", "part_scores", "score"):
        a, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(r), name)
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-5, err_msg=name)
