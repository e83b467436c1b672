"""Random inputs for the port's kernels (greedy assignment, subset merge,
PAF sampling, fused separable conv, the depthwise probe, the int8 conv and
the conv epilogue, with the epilogue calls a model makes), the bf16
agreement measure of the separable kernels, and synthetic pose scenes
(`make_maps`, `standing_person`: tests/maputil.py's functions on the port's
own skeleton tables; `standing_person_25`, BODY_25's figure; `peak_scene`,
`checkerboard_peaks`: the peaks kernels' maps). Each takes COCO's sizes
unless given BODY_25's (`n_limbs=26`, `n_parts=25`, `skel=BODY25`). numpy
and the port's skeleton tables only: no JAX, nothing of the JAX package.

Shared by the port's CPU tests, its `cuda`-marked tests and chip_smoke.py,
which loads this file by path.
"""

from __future__ import annotations

import numpy as np

from openpose_plus_tpu_torch import skeleton, skeletons

N_LIMBS = 19
N_PARTS = 18
BODY25 = skeletons.BODY25


def limb_scores(rng: np.random.Generator, b: int, k: int,
                density: float = 0.3, ties: bool = True,
                n_limbs: int = N_LIMBS) -> np.ndarray:
    """(b, n_limbs, k, k) float32 candidate scores, -inf where no candidate.

    With `ties`, the cases the tie order decides (lowest row-major index
    wins): an empty limb, a limb whose candidates all tie, exact ties
    between two corners and between two cells of one row."""
    s = rng.uniform(0.01, 1.0, (b, n_limbs, k, k)).astype(np.float32)
    s = np.where(rng.random(s.shape) < density, s, -np.inf)
    if ties:
        s[:, 1] = -np.inf
        s[:, 2] = np.where(np.isfinite(s[:, 2]), 0.5, -np.inf)
        s[:, 3, -1, -1] = s[:, 3, 0, 0] = 2.0
        s[:, 4, k // 2, -1] = s[:, 4, k // 2, 0] = 0.7
    return s.astype(np.float32)


def connections(rng: np.random.Generator, b: int, k: int,
                n_limbs: int = N_LIMBS) -> tuple[np.ndarray, ...]:
    """Connection sets shaped like greedy output, (b, n_limbs, k) each:
    distinct slots per limb and a valid prefix of random length. Returns
    slot_a, slot_b (int32), score (float32, 0 where invalid), valid
    (bool)."""
    slots = np.tile(np.arange(k, dtype=np.int32), (b, n_limbs, 1))
    slot_a = rng.permuted(slots, axis=-1)
    slot_b = rng.permuted(slots, axis=-1)
    valid = np.arange(k) < rng.integers(0, k + 1, (b, n_limbs, 1))
    score = (rng.uniform(0.1, 1.0, (b, n_limbs, k)) * valid).astype(
        np.float32)
    return slot_a, slot_b, score, valid


def signed_zero_scores(rng: np.random.Generator, b: int, k: int,
                       n_limbs: int = N_LIMBS) -> np.ndarray:
    """(b, n_limbs, k, k) float32 limb scores whose maxima are often zeros of
    both signs: -0.0 and +0.0 tie (`rem == best`), so the lowest index
    wins whatever the sign. Drawn from {-inf, -1, -0.0, +0.0, 0.5}; limb 0
    has no 0.5, limb 1 only zeros."""
    values = np.array([-np.inf, -1.0, -0.0, 0.0, 0.5], np.float32)
    s = rng.choice(values, (b, n_limbs, k, k), p=[0.3, 0.2, 0.2, 0.2, 0.1])
    s[:, 0] = np.where(s[:, 0] == 0.5, -0.0, s[:, 0])
    s[:, 1] = rng.choice(values[2:4], (b, k, k))
    return s.astype(np.float32)


# Connection sets that drive the merge down each of its branches, and the
# table size (max_humans) each is meant for; see `merge_connections`.
MERGE_KINDS = {"merge_heavy": 32, "table_filling": 4, "all_valid": 32,
               "none_valid": 32}


def merge_connections(rng: np.random.Generator, b: int, k: int, kind: str,
                      n_limbs: int = N_LIMBS) -> tuple[np.ndarray, ...]:
    """Connection sets like `connections`, (b, n_limbs, k) each, of one
    kind (the limb numbers below are COCO's; BODY_25's sets take the same
    rule by index):

    - "merge_heavy": each limb accepts a few slots at random positions,
      their endpoints drawn from peaks 0-2 only, so rows collide: two or
      more found rows, attaches that overwrite a held part. The neck-nose
      limb (12) mostly accepts none and the head and cycle-closing limbs
      (13-18) accept 2-5, so the head grows as a fragment of its own that
      limbs 17-18 then merge into a body (about one merge an image);
    - "all_valid": every slot valid, endpoints as in `connections`
      (distinct within a limb);
    - "table_filling": the same sets, meant for max_humans = 4: many
      connections find no row, the table fills after four creates and the
      creates after them are dropped;
    - "none_valid": no slot valid (the merge is a no-op).

    Returns slot_a, slot_b (int32), score (float32, 0 where invalid),
    valid (bool)."""
    if kind == "merge_heavy":
        pool = min(3, k)
        slot_a = rng.integers(0, pool, (b, n_limbs, k)).astype(np.int32)
        slot_b = rng.integers(0, pool, (b, n_limbs, k)).astype(np.int32)
        n = rng.integers(0, 4, (b, n_limbs, 1))
        n[:, 13:] = rng.integers(2, 6, (b, n_limbs - 13, 1))
        n[:, 12] = np.where(rng.random((b, 1)) < 0.8, 0, n[:, 12])
        valid = rng.random((b, n_limbs, k)).argsort(-1).argsort(-1) < n
    else:
        slot_a, slot_b, _, valid = connections(rng, b, k, n_limbs)
        if kind in ("table_filling", "all_valid"):
            valid = np.ones_like(valid)
        elif kind == "none_valid":
            valid = np.zeros_like(valid)
        else:
            raise ValueError(f"unknown connection set {kind!r}")
    score = (rng.uniform(0.1, 1.0, (b, n_limbs, k)) * valid).astype(
        np.float32)
    return slot_a, slot_b, score, valid


def peak_scores(rng: np.random.Generator, b: int, k: int,
                n_parts: int = N_PARTS) -> np.ndarray:
    """(b, n_parts, k) float32 peak scores."""
    return rng.uniform(0.1, 1.0, (b, n_parts, k)).astype(np.float32)


def paf_samples(rng: np.random.Generator, b: int, h: int, w: int, k: int,
                s: int = 10, n_limbs: int = N_LIMBS
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """paf (b, h, w, 2 n_limbs) float32 and in-bounds sample coordinates
    sy, sx (b, n_limbs, s, k, k) int32, with the map's corners and edges
    among them."""
    paf = (rng.random((b, h, w, 2 * n_limbs), np.float32) - 0.5)
    sy = rng.integers(0, h, (b, n_limbs, s, k, k)).astype(np.int32)
    sx = rng.integers(0, w, (b, n_limbs, s, k, k)).astype(np.int32)
    sy[:, :, 0], sx[:, :, 0] = 0, 0
    sy[:, :, -1], sx[:, :, -1] = h - 1, w - 1
    sy[:, 0, :, 0], sx[:, 1, :, 0] = h - 1, w - 1
    return paf.astype(np.float32), sy, sx


def sepconv_inputs(rng: np.random.Generator, b: int, h: int, w: int,
                   c: int, f: int) -> tuple[np.ndarray, ...]:
    """float32 x (b, h, w, c), dw_kernel (3, 3, 1, c), dw_bias (c,),
    pw_kernel (1, 1, c, f), pw_bias (f,) in the JAX layouts: unit-variance
    x, kernels scaled as the lecun-normal init (1 / sqrt(fan_in)), small
    nonzero biases."""
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (rng.standard_normal((3, 3, 1, c)) / 3.0).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((1, 1, c, f)) / np.sqrt(c)).astype(
                np.float32),
            (0.1 * rng.standard_normal(f)).astype(np.float32))


def int8_conv_inputs(rng: np.random.Generator, b: int, h: int, w: int,
                     cin: int, cout: int, k: int) -> tuple:
    """q (b, h, w, cin) int8 over the full range [-127, 127], float32
    weights (cout, cin, k, k) scaled as the lecun-normal init, a small
    nonzero bias (cout,), and the scales (s_in, s_out) as floats: outputs
    are ~s_in * 0.58 / sqrt(3) in spread, so at s_out = 1.2 * s_in a few
    percent of them saturate at 127."""
    q = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    weight = (rng.standard_normal((cout, cin, k, k))
              / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.05 * rng.standard_normal(cout)).astype(np.float32)
    s_in = float(np.float32(rng.uniform(0.5, 4.0)))
    return q, weight, bias, s_in, float(np.float32(1.2 * s_in))


# int8 conv shapes the kernel's launcher (`int8_conv_launch`) refuses, as
# (B, H, W, Cin_p, Cout, kernel, stride, (pad_top, pad_left)), each breaking
# one of its checks; the wrapper's tile plan refuses them too
INT8_REFUSED = [
    (8, 46, 54, 32, 128, 3, 1, (1, 1)),      # Cin not padded to 64
    (8, 46, 54, 100, 128, 3, 1, (1, 1)),
    (8, 46, 54, 0, 128, 3, 1, (1, 1)),
    (8, 46, 54, 64, 0, 3, 1, (1, 1)),        # no output channel
    (8, 46, 54, 64, 64, 9, 1, (4, 4)),       # kernel above 7
    (8, 46, 54, 64, 64, 0, 1, (0, 0)),
    (8, 46, 54, 64, 64, 3, 3, (1, 1)),       # stride 3
    (8, 46, 54, 64, 64, 3, 1, (3, 1)),       # a pad as large as the kernel
    (8, 46, 54, 64, 64, 3, 1, (1, -1)),
    (8, 0, 54, 64, 64, 3, 1, (1, 1)),        # an empty image
    (-1, 46, 54, 64, 64, 3, 1, (1, 1)),
]


def epilogue_inputs(rng: np.random.Generator, b: int, h: int, w: int,
                    c: int) -> tuple[np.ndarray, ...]:
    """A conv output y (b, h, w, c) and its bias and PReLU slope (c,),
    float32, for the bias_act epilogue: normal values with exact zeros of
    both signs, NaN, infinities of both signs and values that cancel their
    channel's bias to zero (also in bf16), 1 in 40 elements each; slopes of
    both signs, every fifth channel's 0."""
    y = rng.normal(0.0, 2.0, (b, h, w, c)).astype(np.float32)
    bias = rng.normal(0.0, 1.0, c).astype(np.float32)
    slope = rng.normal(0.0, 0.5, c).astype(np.float32)
    slope[::5] = 0.0
    flat = y.reshape(-1, c)
    where = rng.integers(0, flat.size, (6, max(1, flat.size // 40)))
    rows, chans = where // c, where % c
    for i, v in enumerate((0.0, -0.0, np.nan, np.inf, -np.inf)):
        flat[rows[i], chans[i]] = v
    flat[rows[5], chans[5]] = -bias[chans[5]]
    return y, bias, slope


def bias_act_calls(model) -> dict:
    """The tracer's epilogue counters one inference forward of `model`
    bumps, as the tracer records them (a counter never bumped is absent).
    `ops.bias_act`: one a float ConvRelu or PReLUConv, two an unfused float
    SepConvRelu (its depthwise and pointwise halves), one an unfused int8
    SepConvRelu (its bf16 depthwise); an int8 ConvRelu's conv applies its
    own bias and ReLU unless calibrating. `ops.bias_act_pool`: one a pooled
    VGG block (`model.blocks`) whose last conv is a float ConvRelu (an int8
    one pools its output apart, calibrating or not)."""
    from openpose_plus_tpu_torch.models import common

    n = pooled = 0
    for m in model.modules():
        float_path = not getattr(m, "int8", False) or m.calibrating
        if isinstance(m, (common.ConvRelu, common.PReLUConv)):
            n += float_path
        elif isinstance(m, common.SepConvRelu) and not m.fused:
            n += 1 + float_path
        for names, pool in getattr(m, "blocks", ()):
            pooled += pool and not getattr(m, names[-1]).int8
    counters = {"ops.bias_act": n, "ops.bias_act_pool": pooled}
    return {k: v for k, v in counters.items() if v}


def bf16_mismatch(out, ref, floor=0.0) -> tuple[float, float]:
    """Agreement of two bf16 results (given as float32 arrays): the worst
    |out - ref| in units of 2**-7 * (max(|out|, |ref|) + floor), and the
    share of identical elements.

    One unit is at least one bf16 ulp of the larger value. `floor` is the
    magnitude of the last bf16 add's other operand (the bias), where a 1-ulp
    difference before that add can cancel down to a small result."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    if out.size == 0:
        return 0.0, 1.0
    d = np.abs(out - ref)
    unit = 2.0 ** -7 * (np.maximum(np.abs(out), np.abs(ref)) + floor)
    units = np.divide(d, unit, out=np.where(d > 0, np.inf, 0.0),
                      where=unit > 0)
    units = np.where(np.isnan(d), np.inf, units)
    return float(units.max()), float(np.mean(out == ref))


def make_maps(people: list[dict[int, tuple[float, float]]], h: int, w: int,
              sigma: float = 2.0, limb_width: float = 1.5,
              noise: float = 0.0, seed: int = 0, skel=None):
    """people: list of {part_idx: (x, y)} dicts in map coords.

    Returns (conf (h,w,19), paf (h,w,38)) float32, or with `skel` (a
    `skeletons.Skeleton`) that skeleton's (n_parts + 1, 2 n_limbs) maps.
    """
    n_parts, pairs, channels = ((skeleton.N_PARTS, skeleton.COCO_PAIRS,
                                 skeleton.COCO_PAIRS_NETWORK) if skel is None
                                else (skel.n_parts, skel.limbs,
                                      skel.paf_channels))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    conf = np.zeros((h, w, n_parts + 1), np.float32)
    for person in people:
        for part, (px, py) in person.items():
            g = np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / (2 * sigma ** 2))
            conf[:, :, part] = np.maximum(conf[:, :, part], g)
    conf[:, :, n_parts] = 1.0 - conf[:, :, :n_parts].max(-1)

    paf = np.zeros((h, w, 2 * len(pairs)), np.float32)
    count = np.zeros((h, w, len(pairs)), np.float32)
    for person in people:
        for limb, (ia, ib) in enumerate(pairs):
            if ia not in person or ib not in person:
                continue
            ax, ay = person[ia]
            bx, by = person[ib]
            dx, dy = bx - ax, by - ay
            norm = max(np.hypot(dx, dy), 1e-4)
            ux, uy = dx / norm, dy / norm
            # distance along / perpendicular to the limb segment
            relx, rely = xx - ax, yy - ay
            along = relx * ux + rely * uy
            perp = np.abs(relx * (-uy) + rely * ux)
            band = (along >= 0) & (along <= norm) & (perp <= limb_width)
            cx, cy = channels[limb]
            paf[:, :, cx] += band * ux
            paf[:, :, cy] += band * uy
            count[:, :, limb] += band
    for limb, (cx, cy) in enumerate(channels):
        nz = count[:, :, limb] > 0
        paf[:, :, cx][nz] /= count[:, :, limb][nz]
        paf[:, :, cy][nz] /= count[:, :, limb][nz]

    if noise > 0:
        rng = np.random.default_rng(seed)
        conf = conf + rng.normal(0, noise, conf.shape).astype(np.float32)
        paf = paf + rng.normal(0, noise, paf.shape).astype(np.float32)
    return conf.astype(np.float32), paf.astype(np.float32)


def standing_person(cx: float, cy: float, scale: float = 1.0
                    ) -> dict[int, tuple[float, float]]:
    """A full 18-part stick figure centered near (cx, cy)."""
    s = scale
    return {
        0: (cx, cy - 10 * s),          # nose
        1: (cx, cy - 7 * s),           # neck
        2: (cx - 3 * s, cy - 7 * s),   # r shoulder
        3: (cx - 4 * s, cy - 3 * s),   # r elbow
        4: (cx - 5 * s, cy + 1 * s),   # r wrist
        5: (cx + 3 * s, cy - 7 * s),   # l shoulder
        6: (cx + 4 * s, cy - 3 * s),   # l elbow
        7: (cx + 5 * s, cy + 1 * s),   # l wrist
        8: (cx - 2 * s, cy),           # r hip
        9: (cx - 2 * s, cy + 5 * s),   # r knee
        10: (cx - 2 * s, cy + 9 * s),  # r ankle
        11: (cx + 2 * s, cy),          # l hip
        12: (cx + 2 * s, cy + 5 * s),  # l knee
        13: (cx + 2 * s, cy + 9 * s),  # l ankle
        14: (cx - 1 * s, cy - 11 * s),  # r eye
        15: (cx + 1 * s, cy - 11 * s),  # l eye
        16: (cx - 2 * s, cy - 10.5 * s),  # r ear
        17: (cx + 2 * s, cy - 10.5 * s),  # l ear
    }


def standing_person_25(cx: float, cy: float, scale: float = 1.0
                       ) -> dict[int, tuple[float, float]]:
    """A full BODY_25 stick figure centered near (cx, cy): COCO's figure
    with BODY_25's numbering, the mid hip between the hips, and the feet
    (big toe, small toe, heel) under each ankle."""
    s = scale
    coco = standing_person(cx, cy, scale)
    # BODY_25 part <- COCO part, for the parts they share
    shared = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 9: 8, 10: 9,
              11: 10, 12: 11, 13: 12, 14: 13, 15: 14, 16: 15, 17: 16, 18: 17}
    person = {p: coco[c] for p, c in shared.items()}
    person[8] = (cx, cy)                                  # mid hip
    for ankle, toes in ((14, (19, 20, 21)), (11, (22, 23, 24))):
        ax, ay = person[ankle]
        side = 1.0 if ankle == 14 else -1.0               # left, right
        person[toes[0]] = (ax + side * 1.5 * s, ay + 1.5 * s)   # big toe
        person[toes[1]] = (ax + side * 2.5 * s, ay + 1.0 * s)   # small toe
        person[toes[2]] = (ax - side * 0.5 * s, ay + 1.5 * s)   # heel
    return person


def peak_scene(kind: str, b: int = 1, skel=None) -> np.ndarray:
    """(b, 46, 54, 19) conf maps of one of the decoder tests' scene kinds,
    image i rolled i pixels along x: "plateau" (integer-grid keypoints:
    exact 2x2 plateaus after upsampling), "clean", "noisy", "very_noisy"
    (standing people at fractional keypoints, with Gaussian noise) and
    "pure_noise" (uniform in [0, 0.4)); with `skel` BODY25, (b, 46, 54,
    26) maps of its figures."""
    person = standing_person if skel is None else standing_person_25
    channels = skeleton.N_HEATMAPS if skel is None else skel.n_heatmaps
    if kind == "plateau":
        conf = make_maps([person(10, 8), person(10, 30)], 46, 54,
                         skel=skel)[0]
    elif kind == "pure_noise":
        conf = np.random.default_rng(100).uniform(
            0, 0.4, (46, 54, channels)).astype(np.float32)
    else:
        n, noise, seed = {"clean": (3, 0.0, 0), "noisy": (3, 0.15, 1),
                          "very_noisy": (2, 0.2, 2)}[kind]
        people = [person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                         0.93 + 0.1 * i) for i in range(n)]
        conf = make_maps(people, 46, 54, noise=noise, seed=seed,
                         skel=skel)[0]
    return np.stack([np.roll(conf, i, axis=1) for i in range(b)])


def checkerboard_peaks(b: int, h: int, w: int, c: int = 19) -> np.ndarray:
    """(b, h, w, c) maps of 1.0 on every pixel of even row and column and 0
    elsewhere: every 1.0 is a peak at threshold < 1, the most an (h, w)
    row can hold, ceil(h / 2) * ceil(w / 2), all of one score."""
    maps = np.zeros((b, h, w, c), np.float32)
    maps[:, ::2, ::2] = 1.0
    return maps
