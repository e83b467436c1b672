"""The port's evaluation path vs the JAX package's, on the CPU.

- OKS / AP (`eval_coco`): the port's numpy copies give the reference's
  results on random detection sets with ignore boxes and area ranges.
- `humans_to_detections` on a port HumanBatch (tensors or `host_humans`)
  gives the JAX one's detections built from the same arrays.
- `data.targets.make_targets` within 1e-6 of the JAX `make_targets`.
- `data.synthetic`: the annotation-only bank equals the JSON that the JAX
  `make_scene_bank` writes; the port's `make_scene_bank` writes the same
  files.
- `data.coco.CocoPoseDataset`, `data.augment.letterbox` and
  `data.pipeline._load_image` equal the reference's.
- `evaluate_engine` with a port CPU engine equals the JAX engine's; on a
  bank that the loaders decode DCT-scaled (256 px into 64x64: a 1/4
  decode) with an unreadable file, the port's pooled path and the JAX
  package's native one feed the engines the same images (within the
  loader's bound), scales and pads, and count the same images.
- The GT-map oracle (`ap_oracle`) equals the JAX pipeline (JAX
  `make_targets`, `build_decoder`, `evaluate_detections_full`) on 16
  small-tier images.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu import eval_coco as JE
from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.data import augment as jaugment
from openpose_plus_tpu.data import coco as jcoco
from openpose_plus_tpu.data import pipeline as jpipeline
from openpose_plus_tpu.data import synthetic as jsynthetic
from openpose_plus_tpu.data import targets as jtargets
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu.postproc import HumanBatch as JaxHumanBatch
from openpose_plus_tpu.postproc import build_decoder as jax_build_decoder
from openpose_plus_tpu_torch import ap_oracle
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch import eval_coco as TE
from openpose_plus_tpu_torch.data import augment, coco, pipeline, synthetic
from openpose_plus_tpu_torch.data import targets
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.postproc import HumanBatch

torch.set_num_threads(2)


# ------------------------------------------------------------- OKS / AP ---

def _random_eval_set(rng, n_images=6):
    """GT with labeled people of small, medium and large areas, unlabeled
    people, crowd ignore boxes; detections: perturbed copies of some GTs,
    junk, and detections inside ignore boxes; more than MAX_DETS on one
    image. Returns (detections as (image_id, kp, score) tuples, gt)."""
    gt, dets = {}, []
    for img in range(n_images):
        g = int(rng.integers(0, 5))
        kps = np.zeros((g, 17, 3), np.float32)
        areas = np.zeros((g,), np.float32)
        for p in range(g):
            cx, cy = rng.uniform(50, 450, 2)
            spread = rng.choice([5.0, 30.0, 90.0])
            kps[p, :, 0] = cx + rng.uniform(-spread, spread, 17)
            kps[p, :, 1] = cy + rng.uniform(-spread, spread, 17)
            kps[p, :, 2] = np.where(rng.uniform(size=17) < 0.8, 2, 0)
            if p == 3:
                kps[p, :, 2] = 0                      # unlabeled person
            areas[p] = (2 * spread) ** 2 * rng.uniform(0.5, 1.5)
        q = int(rng.integers(0, 3))
        boxes = np.stack([np.array([*rng.uniform(0, 400, 2),
                                    *rng.uniform(20, 120, 2)], np.float32)
                          for _ in range(q)]) if q else \
            np.zeros((0, 4), np.float32)
        gt[img] = (kps, areas, boxes) if img % 2 else (kps, areas)
        n_det = 25 if img == 0 else int(rng.integers(0, 8))
        for _ in range(n_det):
            kind = rng.integers(0, 3)
            if kind == 0 and g:
                kp = kps[int(rng.integers(0, g))].copy()
                kp[:, :2] += rng.normal(0, rng.choice([1.0, 5.0, 20.0]),
                                        (17, 2))
            elif kind == 1 and q:
                b = boxes[int(rng.integers(0, q))]
                kp = np.zeros((17, 3), np.float32)
                kp[:, 0] = b[0] + rng.uniform(0, b[2], 17)
                kp[:, 1] = b[1] + rng.uniform(0, b[3], 17)
            else:
                kp = np.zeros((17, 3), np.float32)
                kp[:, :2] = rng.uniform(0, 500, (17, 2))
            kp[:, 2] = rng.uniform(0, 1, 17)
            dets.append((img, kp.astype(np.float32),
                         float(rng.uniform(0, 1))))
    return dets, gt


@pytest.mark.parametrize("seed", range(6))
def test_oks_ap_copies_match_reference(seed):
    dets, gt = _random_eval_set(np.random.default_rng(seed))
    jd = [JE.Detection(i, k, s) for i, k, s in dets]
    td = [TE.Detection(i, k, s) for i, k, s in dets]
    assert (TE.evaluate_detections_full(td, gt).as_dict()
            == JE.evaluate_detections_full(jd, gt).as_dict())
    for area in (TE.AREA_MEDIUM, TE.AREA_LARGE, (0.0, 40.0 ** 2)):
        assert (TE.evaluate_detections(td, gt, area).as_dict()
                == JE.evaluate_detections(jd, gt, area).as_dict())
    for img, value in gt.items():
        kps, areas, boxes = TE._gt_entry(value)
        for _, kp, _ in dets[:10]:
            for g, a in zip(kps, areas):
                assert TE.compute_oks(kp, g, a) == JE.compute_oks(kp, g, a)
            for b in boxes:
                assert TE.compute_oks_box(kp, b) == JE.compute_oks_box(kp, b)
    for name in ("OKS_THRESHOLDS", "RECALL_GRID", "MAX_DETS", "AREA_MEDIUM",
                 "AREA_LARGE"):
        np.testing.assert_array_equal(getattr(TE, name), getattr(JE, name))


def test_humans_to_detections_matches_reference():
    """The same (B, M) arrays as a port HumanBatch (tensors, and copied to
    the host once by `host_humans`) and as a JAX HumanBatch."""
    rng = np.random.default_rng(0)
    b, m = 3, 32
    fields = dict(
        coords=rng.uniform(0, 1, (b, m, 18, 2)).astype(np.float32),
        part_scores=rng.uniform(0, 1, (b, m, 18)).astype(np.float32),
        part_valid=rng.uniform(size=(b, m, 18)) < 0.7,
        score=rng.uniform(0, 1, (b, m)).astype(np.float32),
        n_parts=rng.integers(0, 18, (b, m)).astype(np.int32),
        valid=rng.uniform(size=(b, m)) < 0.3)
    ref = JaxHumanBatch(**{k: jax.numpy.asarray(v)
                           for k, v in fields.items()})
    port = HumanBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    host = TE.host_humans(port)
    assert all(isinstance(getattr(host, f.name), np.ndarray)
               for f in dataclasses.fields(host))
    for i in range(b):
        args = (i, 7 + i, 0.5 + i, (3.0, -2.5), 368, 432)
        want = JE.humans_to_detections(ref, *args)
        assert want
        for hb in (port, host):
            got = TE.humans_to_detections(hb, *args)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g.image_id, g.score) == (w.image_id, w.score)
                np.testing.assert_array_equal(g.keypoints, w.keypoints)


# ------------------------------------------------------------ GT maps ---

def _keypoints(kind, rng, b=3, p=5):
    """(B, P, 18, 3) keypoints in a 432x368 input of one kind."""
    kp = np.zeros((b, p, 18, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 432, (b, p, 18))
    kp[..., 1] = rng.uniform(0, 368, (b, p, 18))
    kp[..., 2] = 1.0
    if kind == "overlapping":          # people on top of each other
        kp[:, 1:, :, :2] = kp[:, :1, :, :2] + rng.normal(0, 6, (b, p - 1, 18,
                                                                2))
        kp[:, 2] = kp[:, 0]            # an exact duplicate
        kp[:, 3] = kp[:, 0]
        kp[:, 3, [1, 2]] = kp[:, 0, [2, 1]]        # a limb reversed
    elif kind == "invalid":            # invalid parts and empty rows
        kp[..., 2] = (rng.uniform(size=(b, p, 18)) < 0.6).astype(np.float32)
        kp[:, -2:] = 0.0
        kp[0, 0, 1, 2] = -1.0
    elif kind == "off_grid":           # outside the frame, on cell centers
        kp[..., 0] = rng.uniform(-60, 492, (b, p, 18))
        kp[..., 1] = rng.uniform(-60, 428, (b, p, 18))
        kp[:, 0, :, 0] = rng.integers(0, 54, (b, 18)) * 8 + 3.5
        kp[:, 0, :, 1] = rng.integers(0, 46, (b, 18)) * 8 + 3.5
        kp[:, 1, 2, :2] = kp[:, 1, 1, :2]                  # zero-length limb
    return kp


@pytest.mark.parametrize("kind", ["random", "overlapping", "invalid",
                                  "off_grid"])
def test_make_targets_matches_jax(kind):
    """Every map within 1e-6 of the JAX one. A band edge (`along <= norm`,
    `perp <= limb_width`) may flip with a 1-ulp difference in the
    projection and move a PAF pixel by a whole unit vector over its count:
    at most 2 PAF pixels a case may differ beyond 1e-6 (observed: none)."""
    kp = _keypoints(kind, np.random.default_rng(3))
    conf, paf = targets.make_targets(torch.from_numpy(kp), 46, 54, 8, 8.0,
                                     8.0)
    assert conf.shape == (3, 46, 54, 19) and paf.shape == (3, 46, 54, 38)
    assert conf.dtype == paf.dtype == torch.float32
    ref = jax.vmap(lambda k: jtargets.make_targets(k, 46, 54, 8, 8.0, 8.0))(
        kp)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    diff = np.abs(paf.numpy() - np.asarray(ref[1])).max(-1)
    assert int((diff > 1e-6).sum()) <= 2, np.argwhere(diff > 1e-6)
    assert float(diff.max()) <= 1.0 + 1e-6


# ---------------------------------------------------------- scene bank ---

@pytest.mark.parametrize("split", ["val", "val_large"])
@pytest.mark.parametrize("size", [256, 736])
def test_scene_bank_annotations_match_reference(split, size, tmp_path):
    """The annotation-only bank (no cv2, no images) equals the JSON the JAX
    `make_scene_bank` writes: every rng draw made, in order."""
    ann, _ = jsynthetic.make_scene_bank(str(tmp_path), split, 16, size)
    with open(ann) as f:
        ref = json.load(f)
    assert synthetic.scene_bank_annotations(split, 16, size) == ref


def test_make_scene_bank_matches_reference(tmp_path):
    """The port's cv2 bank writes the reference's files byte for byte, and
    `render_scene` draws the reference's image and poses."""
    a_ann, a_imgs = jsynthetic.make_scene_bank(str(tmp_path / "a"), "val",
                                               4, 128)
    b_ann, b_imgs = synthetic.make_scene_bank(str(tmp_path / "b"), "val",
                                              4, 128)
    assert sorted(os.listdir(a_imgs)) == sorted(os.listdir(b_imgs))
    for name in [*os.listdir(a_imgs), "../annotations.json"]:
        with open(os.path.join(a_imgs, name), "rb") as fa, \
                open(os.path.join(b_imgs, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ref = jsynthetic.render_scene(np.random.default_rng(7), 192)
    out = synthetic.render_scene(np.random.default_rng(7), 192)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1] == ref[1]
    with pytest.raises(ValueError, match="unknown split"):
        synthetic.scene_bank_annotations("test", 1)


# --------------------------------------------------- COCO, letterbox ---

def _coco_json(tmp_path):
    """Annotations that exercise every filter: crowd and unlabeled people
    (ignore boxes and raw segmentations), another category, an image with
    no labeled person, a shoulders-only person (neck), unsorted ids."""
    kp = [[10 + i, 20 + i, 2] for i in range(17)]
    anns = {
        "images": [
            {"id": 9, "file_name": "a.jpg", "width": 100, "height": 80},
            {"id": 2, "file_name": "b.jpg", "width": 64, "height": 64},
            {"id": 3, "file_name": "c.jpg", "width": 64, "height": 48},
        ],
        "annotations": [
            {"id": 10, "image_id": 9, "category_id": 1, "iscrowd": 0,
             "area": 400.0, "keypoints": sum(kp, []),
             "segmentation": [[0, 0, 10, 0, 10, 10, 0, 10]]},
            {"id": 11, "image_id": 9, "category_id": 1, "iscrowd": 1,
             "area": 100.0, "keypoints": [0] * 51, "bbox": [1, 2, 30, 40],
             "segmentation": {"counts": [0, 80, 80 * 99],
                              "size": [80, 100]}},
            {"id": 12, "image_id": 9, "category_id": 1, "iscrowd": 0,
             "area": 50.0, "keypoints": [0] * 51, "bbox": [50, 50, 10, 10],
             "segmentation": [[50, 50, 60, 50, 60, 60, 50, 60]]},
            {"id": 15, "image_id": 9, "category_id": 2, "iscrowd": 0,
             "area": 9.0, "keypoints": sum(kp, [])},
            {"id": 13, "image_id": 2, "category_id": 1, "iscrowd": 0,
             "area": 10.0, "keypoints": [0] * 51, "segmentation": []},
            {"id": 14, "image_id": 3, "category_id": 1, "iscrowd": 0,
             "area": 20.0, "keypoints": [0, 0, 0] * 5 + [10, 30, 2]
             + [30, 30, 1] + [0, 0, 0] * 10, "segmentation": []},
            {"id": 16, "image_id": 3, "category_id": 1, "iscrowd": 0,
             "keypoints": [5, 6, 1] + [0, 0, 0] * 16},
        ],
    }
    path = os.path.join(tmp_path, "ann.json")
    with open(path, "w") as f:
        json.dump(anns, f)
    return path, anns


@pytest.mark.parametrize("min_keypoints,max_people", [(1, 32), (2, 1)])
def test_coco_dataset_matches_reference(tmp_path, min_keypoints, max_people):
    path, raw = _coco_json(tmp_path)
    ref = jcoco.CocoPoseDataset(path, str(tmp_path), min_keypoints,
                                max_people)
    for out in (coco.CocoPoseDataset(path, str(tmp_path), min_keypoints,
                                     max_people),
                coco.CocoPoseDataset.from_annotations(
                    raw, str(tmp_path), min_keypoints, max_people)):
        assert len(out) == len(ref) == len(list(out))
        for a, b in zip(out, ref):
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype, f.name
                    np.testing.assert_array_equal(x, y, f.name)
                else:
                    assert x == y, f.name
    kps = ref[0].keypoints
    for n in (1, 3):
        np.testing.assert_array_equal(coco.pad_keypoints(kps, n),
                                      jcoco.pad_keypoints(kps, n))
    kp17 = np.asarray(raw["annotations"][5]["keypoints"],
                      np.float32).reshape(17, 3)
    np.testing.assert_array_equal(coco.coco17_to_openpose18(kp17),
                                  jcoco.coco17_to_openpose18(kp17))


@pytest.mark.parametrize("shape", [(80, 100, 3), (500, 333, 3),
                                   (368, 432, 3), (17, 640, 3)])
def test_letterbox_matches_reference(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    out, scale, pad = augment.letterbox(img, 368, 432)
    ref, rscale, rpad = jaugment.letterbox(img, 368, 432)
    np.testing.assert_array_equal(out, ref)
    assert (scale, pad) == (rscale, rpad)
    np.testing.assert_array_equal(
        augment._affine_matrix(100, 80, 432, 368, 12.5, 0.7, (3.0, -1.0),
                               True),
        jaugment._affine_matrix(100, 80, 432, 368, 12.5, 0.7, (3.0, -1.0),
                                True))


def test_load_image_matches_reference(tmp_path):
    import cv2

    img = np.random.default_rng(0).integers(0, 256, (30, 40, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(pipeline._load_image(path),
                                  jpipeline._load_image(path))
    with pytest.raises(FileNotFoundError):
        pipeline._load_image(str(tmp_path / "missing.png"))


# ------------------------------------------------------- evaluate_engine ---

def _engine_pair():
    """A JAX and a port engine (tiny float32 MobileNet-thin) on the same
    weights, the last stage's heads scaled so that random weights decode
    to humans (as tests/test_torch_engine.py does)."""
    kw = dict(hin=64, win=64, n_stages=2, compute_dtype="float32")
    jcfg = jconfig.default_config("mobilenet_thin")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **kw))
    tcfg = tconfig.default_config("mobilenet_thin")
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **kw))
    flat = _flatten(jax.device_get(JaxEngine(jcfg, seed=3).params))
    for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
        key = f"params/stages/stage2_{branch}/Conv_0/kernel"
        flat[key] = np.asarray(flat[key]) * gain
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    return (JaxEngine(jcfg, params=nested),
            Engine(tcfg, params=flat, device="cpu"))


def test_evaluate_engine_matches_reference(tmp_path, monkeypatch):
    """Both packages' Python loader paths over a 6-image bank (batch 4: a
    padded last batch): the same detections, hence the same AP."""
    from openpose_plus_tpu import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    ann, imgs = synthetic.make_scene_bank(str(tmp_path), "val", 6, 96)
    jax_engine, engine = _engine_pair()
    seen = {}
    for mod, eng, ds in ((JE, jax_engine, jcoco.CocoPoseDataset(ann, imgs)),
                         (TE, engine, coco.CocoPoseDataset(ann, imgs))):
        calls = []
        real = mod.evaluate_detections_full
        monkeypatch.setattr(mod, "evaluate_detections_full",
                            lambda d, g, calls=calls, real=real: (
                                calls.append(d) or real(d, g)))
        seen[mod] = (mod.evaluate_engine(eng, ds, batch_size=4), calls[0])
    (ref, ref_dets), (out, dets) = seen[JE], seen[TE]
    assert out.n_images == 6 and out.n_dets > 0
    assert out.n_dets == ref.n_dets
    for d, r in zip(dets, ref_dets):
        assert d.image_id == r.image_id
        np.testing.assert_allclose(d.keypoints, r.keypoints, rtol=0,
                                   atol=1e-3)
        assert abs(d.score - r.score) <= 1e-5
    for key, value in ref.as_dict().items():
        assert abs(out.as_dict()[key] - value) <= 1e-6, key
    # distributed=True without a process group: the whole bank, as the
    # reference on one process (tests/test_torch_parallel.py: 2 ranks)
    assert TE.evaluate_engine(engine, coco.CocoPoseDataset(ann, imgs),
                              batch_size=4, distributed=True).as_dict() == \
        out.as_dict()


def _spy_served(monkeypatch, module, engine):
    """image_id -> (plain image, scale, pad) as `evaluate_engine` serves
    them: each `infer` batch, and the row, scale and pad each
    `humans_to_detections` call reads."""
    from openpose_plus_tpu import native

    served, batches = {}, []
    infer, to_dets = engine.infer, module.humans_to_detections

    def spy_infer(images, *args, **kwargs):
        batches.append(np.asarray(images))
        return infer(images, *args, **kwargs)

    def spy_dets(humans, b, image_id, scale, pad, *args):
        served[image_id] = (native.d2s_u8(batches[-1][b]), scale, pad)
        return to_dets(humans, b, image_id, scale, pad, *args)

    monkeypatch.setattr(engine, "infer", spy_infer)
    monkeypatch.setattr(module, "humans_to_detections", spy_dets)
    return served


def test_evaluate_engine_streams_scaled_jpegs_as_the_reference(tmp_path,
                                                               monkeypatch):
    """Both packages' loader paths (the JAX one native, not patched) over a
    6-image bank of 256 px JPEGs served at 64x64 (the native decode's 2/8,
    cv2's 1/4: the same plane), the third file unreadable: the same images
    reach `infer`, pixels within 1 level inside the frame's first and last
    row and column, equal scales, pads within 1e-4; the unreadable image
    is never served and its GT still counts in `n_images`."""
    from openpose_plus_tpu import native

    if not native.is_available():
        pytest.skip("libpose_host.so not built")
    ann, imgs = synthetic.make_scene_bank(str(tmp_path), "val", 6, 256)
    dataset = coco.CocoPoseDataset(ann, imgs)
    with open(dataset[2].image_path, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    jax_engine, engine = _engine_pair()
    results, served = {}, {}
    for mod, eng, ds in ((JE, jax_engine, jcoco.CocoPoseDataset(ann, imgs)),
                         (TE, engine, dataset)):
        served[mod] = _spy_served(monkeypatch, mod, eng)
        results[mod] = mod.evaluate_engine(eng, ds, batch_size=4)
    ids = [dataset[i].image_id for i in range(6)]
    assert sorted(served[TE]) == sorted(served[JE]) == sorted(
        ids[:2] + ids[3:])
    for image_id, (img, scale, pad) in served[TE].items():
        ref, rscale, rpad = served[JE][image_id]
        assert img.shape == ref.shape == (64, 64, 3)
        assert np.float32(scale) == np.float32(rscale) == np.float32(0.25)
        np.testing.assert_allclose(pad, rpad, rtol=0, atol=1e-4)
        diff = np.abs(img.astype(int) - ref.astype(int))[1:-1, 1:-1]
        assert diff.max() <= 1, (image_id, diff.max())
    assert results[TE].n_images == results[JE].n_images == 6


# --------------------------------------------------------- the oracle ---

_JAX_ORACLE = {}


def _jax_oracle(variant):
    """The JAX pipeline of scripts/ap_benchmark.py::run_oracle on the port
    oracle's 16 small-tier images (the same bank: pinned above)."""
    if not _JAX_ORACLE:
        bank = ap_oracle.oracle_bank("small", limit=16)
        geo = bank.geo
        render = jax.jit(jax.vmap(lambda kp: jtargets.make_targets(
            kp, 16, 16, 8, geo["sigma"], geo["limb"])))
        _JAX_ORACLE["bank"] = bank
        _JAX_ORACLE["maps"] = [render(ap_oracle.input_keypoints(bank, i))
                               for i in range(0, 16, 8)]
    bank = _JAX_ORACLE["bank"]
    pcfg = jconfig.PostprocConfig()
    if variant != "base":
        pcfg = pcfg.fidelity(upsample=8)
    if variant == "fidelity_fm":
        pcfg = dataclasses.replace(pcfg, fragment_merge_rel=0.5)
    decoder = jax_build_decoder(pcfg)
    dets = []
    for i, (conf, paf) in zip(range(0, 16, 8), _JAX_ORACLE["maps"]):
        humans = decoder(conf, paf)
        for j in range(8):
            dets.extend(JE.humans_to_detections(humans, j, *bank.metas[i + j],
                                                128, 128))
    return JE.evaluate_detections_full(dets, bank.gt_by_image)


@pytest.mark.parametrize("variant", ["base", "fidelity", "fidelity_fm"])
def test_oracle_matches_jax_pipeline(variant):
    """The port's oracle on 16 small-tier images, rendered and decoded on
    the CPU, gives the JAX pipeline's AP within 1e-6 (observed: equal; at
    this tier K = 16 peaks cover every scene, so ulp-level reorders of
    near-equal peaks cannot change the kept set)."""
    out = ap_oracle.run_oracle("small", (variant,), device="cpu",
                               limit=16)[variant]
    ref = _jax_oracle(variant)
    assert out.n_images == 16 and out.n_dets == ref.n_dets > 0
    for key, value in ref.as_dict().items():
        assert abs(out.as_dict()[key] - value) <= 1e-6, key


def test_oracle_perfect_and_variants():
    """The perfect variant reads AP 1.0; the decoder configs and geometry
    tiers are scripts/ap_benchmark.py's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ap_benchmark", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "ap_benchmark.py"))
    ap_benchmark = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ap_benchmark)
    for tier, geo in ap_oracle.GEOMETRIES.items():
        ref = ap_benchmark.GEOMETRIES[tier]
        assert geo == {k: ref[k] for k in geo}
    out = ap_oracle.run_oracle("small", ("perfect",), device="cpu",
                               limit=8)
    assert out["perfect"].ap == 1.0 and out["perfect"].ar == 1.0
    assert ap_oracle.variant_config("base") == tconfig.PostprocConfig()
    assert ap_oracle.variant_config("fidelity_fm").fragment_merge_rel == 0.5
    with pytest.raises(ValueError, match="unknown oracle variants"):
        ap_oracle.run_oracle("small", ("tta",), device="cpu", limit=8)
