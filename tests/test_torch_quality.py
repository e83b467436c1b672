"""Port quality decoder (fragment merge) and merge_dedup vs the JAX package.

- `merge_fragments` on the scenes of tests/test_fragment_merge.py (copied
  here), a tie and random batches: masks and counts exactly, coords and
  scores to float32 rounding, against `_merge_fragments_single`.
- `merge_dedup` on the scenes of tests/test_merge_dedup.py (copied here)
  and random batches with tied scores: masks and order exactly.
- `decode_maps(..., PostprocConfig().quality())` end to end against the JAX
  decoder, on the noise levels of tests/test_torch_postproc.py and on a
  scene of truncated people that the merge must repair.
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
from openpose_plus_tpu.postproc import HumanBatch as JaxHumanBatch
from openpose_plus_tpu.postproc import decode as jdecode
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.postproc import HumanBatch, decode_maps
from openpose_plus_tpu_torch.postproc import decode as tdecode

from tests import maputil

torch.set_num_threads(2)

W, H = 432, 368
M = 8
QUALITY = PostprocConfig().quality()
TQUALITY = tconfig.PostprocConfig().quality()    # the port's own preset


# ----------------------------------------------------- fragment merge ---

def _mk(rows, m=M):
    """rows: list of dicts {parts: {idx: (x_px, y_px)}, score}."""
    coords = np.zeros((m, 18, 2), np.float32)
    ps = np.zeros((m, 18), np.float32)
    pv = np.zeros((m, 18), bool)
    sc = np.zeros((m,), np.float32)
    cnt = np.zeros((m,), np.int32)
    for i, r in enumerate(rows):
        for p, (x, y) in r["parts"].items():
            coords[i, p] = (x / W, y / H)
            pv[i, p] = True
            ps[i, p] = r.get("score", 1.0)
        sc[i] = r.get("score", 1.0)
        cnt[i] = len(r["parts"])
    return coords, ps, pv, sc, cnt


_HEAD = {0: (200, 80), 14: (185, 60), 15: (215, 60)}
_SCENES = {   # name: (rows, rel)
    "two_fragments": ([dict(parts=_HEAD, score=0.9),
                       dict(parts={9: (195, 115), 10: (195, 185),
                                   12: (215, 115)}, score=0.7)], 0.5),
    "far_people": ([dict(parts={0: (50, 80), 14: (45, 70), 15: (55, 70)}),
                    dict(parts={0: (380, 80), 14: (375, 70),
                                15: (385, 70)})], 0.5),
    "shared_parts": ([dict(parts={0: (200, 80), 1: (200, 100)}),
                      dict(parts={0: (205, 82), 9: (195, 150)})], 0.5),
    # rel=1.0: the chain MECHANICS, as in test_fragment_merge.py
    "chain": ([dict(parts={0: (170, 60), 14: (230, 60)}),
               dict(parts={2: (170, 100), 5: (230, 100)}),
               dict(parts={9: (170, 150), 12: (230, 150)})], 1.0),
    # rows 1 and 2 mirror each other about the head's axis: rel(0, 1) ==
    # rel(0, 2) exactly, so the lowest flat index (0, 1) merges; row 2
    # then shares parts with row 0 and stays
    "tie": ([dict(parts={0: (200, 80), 1: (200, 100)}, score=0.8),
             dict(parts={9: (180, 110), 10: (170, 150)}, score=0.6),
             dict(parts={9: (220, 110), 10: (230, 150)}, score=0.7)], 1.0),
}


def _jax_merge(arrays, rel, rounds=8):
    fn = jax.jit(jax.vmap(functools.partial(
        jdecode._merge_fragments_single, w=W, h=H, rel_threshold=rel,
        rounds=rounds)))
    return [np.asarray(x) for x in fn(*map(jnp.asarray, arrays))]


def _port_merge(arrays, rel, rounds=8):
    return [x.numpy() for x in tdecode.merge_fragments(
        *map(torch.from_numpy, arrays), w=W, h=H, rel_threshold=rel,
        rounds=rounds)]


def _assert_merge_matches(out, ref):
    coords, ps, pv, sc, cnt = out
    np.testing.assert_array_equal(pv, ref[2], "part_valid")
    np.testing.assert_array_equal(cnt, ref[4], "count")
    assert cnt.dtype == ref[4].dtype
    np.testing.assert_allclose(coords, ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ps, ref[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(sc, ref[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_fragment_merge_scene_matches_jax(scene):
    rows, rel = _SCENES[scene]
    arrays = [a[None] for a in _mk(rows)]
    out = _port_merge(arrays, rel)
    _assert_merge_matches(out, _jax_merge(arrays, rel))
    cnt = out[4][0]
    expect = {"two_fragments": [6, 0], "far_people": [3, 3],
              "shared_parts": [2, 2], "tie": [4, 0, 2]}
    if scene == "chain":
        assert (cnt > 0).sum() == 1 and cnt.max() == 6
    else:
        assert cnt[:len(expect[scene])].tolist() == expect[scene]
    if scene == "two_fragments":   # weighted mean score, coords kept
        assert np.isclose(out[3][0, 0], (0.9 * 3 + 0.7 * 3) / 6)
        assert np.isclose(out[0][0, 0, 9, 0] * W, 195)


def test_fragment_merge_scenes_batched():
    """The five scenes as one batch: each image as when alone."""
    names = sorted(_SCENES)
    for rel in (0.5, 1.0):
        arrays = [np.stack(a) for a in zip(*(_mk(_SCENES[n][0])
                                             for n in names))]
        batched = _port_merge(arrays, rel)
        _assert_merge_matches(batched, _jax_merge(arrays, rel))
        for i in range(len(names)):
            alone = _port_merge([a[i:i + 1] for a in arrays], rel)
            for x, y in zip(batched, alone):
                np.testing.assert_array_equal(x[i], y[0])


@pytest.mark.parametrize("seed,rounds", [(0, 8), (1, 8), (2, 3), (3, 0)])
def test_fragment_merge_random_matches_jax(seed, rounds):
    """Random fragments (2-5 parts each, some empty rows) in 4 images of
    M=16 rows; rel 0.5 as in quality()."""
    rng = np.random.default_rng(seed)
    b, m = 4, 16
    coords = np.zeros((b, m, 18, 2), np.float32)
    pv = np.zeros((b, m, 18), bool)
    for i in range(b):
        for r in range(rng.integers(3, m)):
            parts = rng.choice(18, rng.integers(2, 6), replace=False)
            center = rng.uniform(0.2, 0.8, 2)
            pv[i, r, parts] = True
            coords[i, r, parts] = center + rng.normal(0, 0.04,
                                                      (len(parts), 2))
    coords = np.where(pv[..., None], coords, 0).astype(np.float32)
    ps = np.where(pv, rng.uniform(0.1, 1, pv.shape), 0).astype(np.float32)
    cnt = pv.sum(-1).astype(np.int32)
    sc = np.where(cnt > 0, rng.uniform(0.1, 1, cnt.shape),
                  0).astype(np.float32)
    arrays = [coords, ps, pv, sc, cnt]
    out = _port_merge(arrays, 0.5, rounds)
    _assert_merge_matches(out, _jax_merge(arrays, 0.5, rounds))
    if rounds:
        assert (out[4] > 0).sum() < (cnt > 0).sum()     # something merged


def test_argmin_takes_first_index_on_ties():
    """The merge picks its pair with torch.argmin on the flattened (M, M)
    matrix; like jnp.argmin it must return the first of equal minima."""
    rel = torch.full((3, 16), torch.inf)
    rel[0, [5, 9, 12]] = 0.25
    rel[1, [3, 4]] = 0.0
    out = rel.argmin(dim=1)
    assert out.tolist() == [5, 3, 0]
    assert out.tolist() == np.asarray(jnp.argmin(jnp.asarray(rel.numpy()),
                                                 axis=1)).tolist()


# --------------------------------------------------------------- dedup ---

def _person(cx, cy, s=0.1):
    """18-part skeleton around (cx, cy) with extent ~s (normalized)."""
    rng = np.random.default_rng(0)
    return np.stack([np.full(18, cx) + np.linspace(-s, s, 18),
                     np.full(18, cy) + rng.uniform(-s, s, 18)], -1
                    ).astype(np.float32)


def _fields(coords, scores, m=M, parts=None):
    """One image's HumanBatch fields (numpy, batch 1)."""
    c = np.zeros((1, m, 18, 2), np.float32)
    pv = np.zeros((1, m, 18), bool)
    ps = np.zeros((1, m, 18), np.float32)
    sc = np.zeros((1, m), np.float32)
    npart = np.zeros((1, m), np.int32)
    valid = np.zeros((1, m), bool)
    for i, (xy, s) in enumerate(zip(coords, scores)):
        c[0, i] = xy
        pv[0, i] = True if parts is None else parts[i]
        ps[0, i] = s
        sc[0, i] = s
        npart[0, i] = pv[0, i].sum()
        valid[0, i] = True
    return dict(coords=c, part_scores=ps, part_valid=pv, score=sc,
                n_parts=npart, valid=valid)


def _dedup_both(batches, thresh=0.5):
    """merge_dedup of the same numpy batches in JAX and in the port."""
    ref = jdecode.merge_dedup(
        [JaxHumanBatch(**{k: jnp.asarray(v) for k, v in f.items()})
         for f in batches], thresh)
    out = tdecode.merge_dedup(
        [HumanBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
         for f in batches], thresh)
    for f in dataclasses.fields(HumanBatch):
        o, r = getattr(out, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert o.dtype == r.dtype, f.name
        np.testing.assert_array_equal(o, r, f.name)    # gathers: exact
    return out


def _half(p):
    pv = np.zeros(18, bool)
    pv[p] = True
    return pv


_DEDUP = {
    "duplicates": lambda p: [_fields([p], [0.9]), _fields([p + 0.003],
                                                          [0.6])],
    "lower_score_first": lambda p: [_fields([p + 0.003], [0.6]),
                                    _fields([p], [0.9])],
    "distinct": lambda p: [_fields([_person(0.25, 0.3)], [0.8]),
                           _fields([_person(0.75, 0.7)], [0.7])],
    "no_shared_parts": lambda p: [
        _fields([p], [0.9], parts=[_half(slice(0, 9))]),
        _fields([p], [0.5], parts=[_half(slice(9, 18))])],
}


def test_oks_sigmas_copy():
    """The port's copy of the JAX helper (which imports JAX)."""
    out, ref = tdecode._oks_sigmas_18(), jdecode._oks_sigmas_18()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scene", sorted(_DEDUP))
def test_merge_dedup_scene_matches_jax(scene):
    out = _dedup_both(_DEDUP[scene](_person(0.5, 0.5)))
    assert out.coords.shape == (1, 2 * M, 18, 2)
    expect = {"duplicates": 1, "lower_score_first": 1, "distinct": 2,
              "no_shared_parts": 2}[scene]
    assert int(out.num_humans[0]) == expect
    if scene in ("duplicates", "lower_score_first"):
        assert float(out.score[0, 0]) == pytest.approx(0.9)
    assert float(out.score[0, 0]) >= float(out.score[0, 1])


@pytest.mark.parametrize("seed,n_batches", [(0, 2), (1, 3), (2, 3)])
def test_merge_dedup_random_ties_matches_jax(seed, n_batches):
    """Random batches (B=3, M=8 each) of people near a few centers, with
    scores from a small set (ties across and within batches), partial
    part sets and invalid rows."""
    rng = np.random.default_rng(seed)
    b, m = 3, 8
    centers = rng.uniform(0.2, 0.8, (4, 2))
    batches = []
    for _ in range(n_batches):
        pv = rng.random((b, m, 18)) < 0.7
        valid = rng.random((b, m)) < 0.8
        jitter = rng.normal(0, 0.004, (b, m, 18, 2))
        base = np.stack([_person(*centers[k]) for k in
                         rng.integers(0, 4, b * m)]).reshape(b, m, 18, 2)
        coords = np.where(pv[..., None], base + jitter, 0).astype(np.float32)
        score = rng.choice(np.float32([0.5, 0.7, 0.9]), (b, m))
        batches.append(dict(
            coords=coords,
            part_scores=np.where(pv, score[..., None], 0).astype(np.float32),
            part_valid=pv & valid[..., None],
            score=np.where(valid, score, 0).astype(np.float32),
            n_parts=np.where(valid, pv.sum(-1), 0).astype(np.int32),
            valid=valid))
    out = _dedup_both(batches)
    assert out.coords.shape == (b, m * n_batches, 18, 2)
    kept = out.num_humans
    assert (kept < sum(int(x["valid"].sum()) for x in batches)).any()


def test_merge_dedup_of_empty_batches():
    empty = {k: np.zeros_like(v) for k, v in
             _fields([_person(0.5, 0.5)], [0.9]).items()}
    out = _dedup_both([empty, empty])
    assert not out.valid.any()


# ---------------------------------------------------- quality decoder ---

def _truncated_person(cx, cy, s=1.0):
    """A standing person without the neck and ears: head, arms and legs
    are five disjoint 3-part fragments for the limb graph, each within half
    a fragment's size of the next (arm to leg: rel 0.35)."""
    person = maputil.standing_person(cx, cy, s)
    return {p: xy for p, xy in person.items() if p not in (1, 16, 17)}


def _maps(kind):
    """The noise levels of tests/test_torch_postproc.py, plus truncated
    people at 46x54."""
    if kind == "truncated":
        people = [_truncated_person(13.37, 21.43), _truncated_person(
            39.61, 22.1, 1.1)]
        return maputil.make_maps(people, 46, 54)
    if kind == "pure_noise":
        rng = np.random.default_rng(100)
        return (rng.uniform(0, 0.4, (46, 54, 19)).astype(np.float32),
                rng.uniform(-1, 1, (46, 54, 38)).astype(np.float32))
    n, noise, seed = {"clean": (3, 0.0, 0), "noisy": (3, 0.15, 1),
                      "very_noisy": (2, 0.2, 2)}[kind]
    people = [maputil.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                      0.93 + 0.1 * i)
              for i in range(n)]
    return maputil.make_maps(people, 46, 54, noise=noise, seed=seed)


_DECODERS = {}


def _decode_both(kinds, cfg):
    maps = [_maps(kind) for kind in kinds]
    conf = np.stack([c for c, _ in maps])
    paf = np.stack([p for _, p in maps])
    if cfg not in _DECODERS:
        _DECODERS[cfg] = jdecode.build_decoder(cfg)
    ref = _DECODERS[cfg](conf, paf)
    out = decode_maps(torch.from_numpy(conf), torch.from_numpy(paf),
                      tconfig.PostprocConfig(**dataclasses.asdict(cfg)))
    return ref, out


def test_quality_decode_matches_jax():
    """At the fidelity() tolerances of test_torch_postproc.py (flat peak
    tops at 8x upsample move PAF samples: scores to 5e-3)."""
    ref, out = _decode_both(["clean", "noisy", "very_noisy", "pure_noise",
                             "truncated"], QUALITY)
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.part_scores.numpy(),
                               np.asarray(ref.part_scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score),
                               rtol=0, atol=5e-3)


def test_quality_merges_truncated_people():
    """On truncated people quality() gives fewer, fuller skeletons than
    the same preset without the merge (fidelity())."""
    conf, paf = (torch.from_numpy(a)[None] for a in _maps("truncated"))
    merged = decode_maps(conf, paf, TQUALITY)
    plain = decode_maps(conf, paf, dataclasses.replace(
        TQUALITY, fragment_merge_rel=0.0))
    assert plain.n_parts[0].tolist()[:11] == [3] * 10 + [0]
    assert merged.n_parts[0].tolist()[:3] == [15, 15, 0]
    assert merged.num_humans.tolist() == [2]
    assert int(merged.part_valid.sum()) == int(plain.part_valid.sum())


def test_quality_decode_of_empty_maps():
    out = decode_maps(torch.zeros((2, 46, 54, 19)),
                      torch.zeros((2, 46, 54, 38)), TQUALITY)
    assert not out.valid.any()
    assert out.coords.shape == (2, TQUALITY.max_humans, 18, 2)


def test_quality_scene_is_mirror_consistent():
    """The truncated scene, decoded from its mirrored maps, gives the same
    people with x -> 1 - x and left/right parts swapped."""
    from openpose_plus_tpu_torch.postproc.flip import mirror_maps

    conf, paf = (torch.from_numpy(a)[None] for a in _maps("truncated"))
    out = decode_maps(conf, paf, TQUALITY)
    mir = decode_maps(*mirror_maps(conf, paf), TQUALITY)
    n = int(out.num_humans[0])
    assert int(mir.num_humans[0]) == n
    swap = torch.as_tensor(np.asarray(
        [dict(skeleton.FLIP_SWAP_PAIRS + tuple(
            (b, a) for a, b in skeleton.FLIP_SWAP_PAIRS)).get(p, p)
         for p in range(18)]))
    for i in range(n):     # match rows by their mirrored mean x
        j = int((mir.coords[0, :n, :, 0].sum(-1) / mir.n_parts[0, :n]
                 - (1 - out.coords[0, i, :, 0].sum() / out.n_parts[0, i])
                 ).abs().argmin())
        assert torch.equal(mir.part_valid[0, j], out.part_valid[0, i][swap])
        v = out.part_valid[0, i][swap]
        xy = mir.coords[0, j][v]
        ref = out.coords[0, i][swap][v]
        torch.testing.assert_close(xy[:, 0], 1 - ref[:, 0], rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(xy[:, 1], ref[:, 1], rtol=0, atol=1e-5)
