"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Marked `cuda`: every test skips without a CUDA device. This file imports
neither JAX nor the repository's conftest, so it runs on a GPU machine that
has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Every check of a kernel against its plain version on seeded inputs lives
here (chip_smoke.py checks what needs a full-size engine or the whole
machine, and each kernel it times on its own inputs). The decode kernels run at both skeletons' sizes (COCO's 18 parts
and 19 limbs, BODY_25's 25 and 26): every register tiling of the greedy
kernel (K from 1 to 32, ties of -0.0 with +0.0, a NaN), merge tables with
fewer than 32 rows, odd K, the connection sets that drive each branch of
the merge, the PAF sampler at K = 1...32 with corner coordinates and on
the served decodes' maps (92x108 K 16, 368x432 K 32, BODY_25's 92x164 K
16, batch 8), the peaks kernels (the decoder tests' scenes at the default
and fidelity() decodes and tiled to BODY_25's 92x164, a checkerboard at
the per-row capacity, K past the shared-memory ranking and past H * W,
non-finite maps, equal scores, signed zeros, any layout, a CUDA-graph
replay, and no sort, top-K or max-pool on the card). Then the separable conv at odd channel counts,
every pixel and F tiling, ragged tiles, unaligned views (both load paths)
and the fused MobileNet-thin's six layer shapes on its three grids at
batch 8, the depthwise probe (batch 8 at C 128 and 256 among others), the
int8 conv (kernel sizes 1, 3 and 7, stride 2 on even and odd sizes, Cin
of 3, 185, 537 and 576, both output modes, M and N edges, both tile plans'
pixel counts and several N tiles) and the int8 quantize pass, empty
batches, and the wrappers' refusals on the card. Then the compiled
programs: `Engine.compile`, flip-TTA and the scale search replayed as CUDA
graphs (bit-equal to their eager calls on the default, fused and int8
engines, under the default, fidelity() and quality() decoders), the train
step as one CUDA-graph replay a step (Adam and momentum across a staircase
boundary, remat_stages, a resume; held to the eager step within the
eager-against-eager spread measured first), and loaded export artifacts.
And the tracer on the card: a graph captured while it records carries no
tracer events; the decode's stage device spans, captured in a graph, sum
to the graph's replay time. And BODY_25: the 25-part decode on the card
against the CPU, and a BODY_25 engine's compiled replay against its eager
call, with its model spans timing a captured forward. And the conv
epilogue (`bias_act`): the kernel bit for bit against the plain
expressions at C = 24 ... 512 (57 ragged) on a ragged pixel count, with
signed zeros, NaN, infinities and slopes of both signs, in bf16 and
float32; its second store into a dense block's buffer; the wrapper's
refusals; bf16 BODY_25 and VGG19 forwards equal with the kernel and with
the op swapped for its plain version. Pooled, against PyTorch's pool of
the plain expressions at the VGG front's three shapes, odd H and W, a
ragged C, an unaligned y and windows of every mix of NaN, infinities and
signed zeros; one launch a call, captured in a CUDA graph; and whole
BODY_25 and VGG19 forwards at 368x656 and batch 8 against the same
forwards pooled by PyTorch after the unpooled kernel.

The separable kernels are held to their plain versions as
tests/test_torch_sepconv.py states: `kernel_inputs.bf16_mismatch` at most 2
units (1 for the probe's depthwise) and at least 98% identical elements.
"""

import numpy as np
import pytest
import torch

# pytest puts this directory on sys.path; `from tests import ...` would
# break where an installed package named `tests` shadows it
import kernel_inputs
from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP
from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.skeletons import BODY25, COCO18
from openpose_plus_tpu_torch.ops.cuda import (bias_act, dw_probe, greedy,
                                              int8_conv, merge, paf_sample,
                                              peaks, sepconv)
from openpose_plus_tpu_torch.postproc import nms

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

# the decode kernels' two sizes: 18 parts and 19 limbs, 25 and 26
SKELETONS = {"coco18": COCO18, "body25": BODY25}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scores(rng, b, k, density, n_limbs=19):
    """limb_scores at `density`, or "signed_zero" (-0.0 and +0.0 tie), or
    "nan" (signed zeros with a NaN in limb 5 of image 0, which the plain
    version's amax propagates: that limb accepts nothing)."""
    if density in ("signed_zero", "nan"):
        s = kernel_inputs.signed_zero_scores(rng, b, k, n_limbs)
        if density == "nan":
            s[0, 5, k // 2, 0] = np.nan
        return torch.from_numpy(s)
    return torch.from_numpy(kernel_inputs.limb_scores(rng, b, k, density,
                                                      n_limbs=n_limbs))


def _conns(rng, b, k, kind="random", skel=COCO18):
    conns = (kernel_inputs.connections(rng, b, k, skel.n_limbs)
             if kind == "random" else kernel_inputs.merge_connections(
                 rng, b, k, kind, skel.n_limbs))
    fields = (*conns, kernel_inputs.peak_scores(rng, b, k, skel.n_parts))
    return [torch.from_numpy(x) for x in fields]


# K*K/32 candidates per lane: 1 (K <= 5), 2, 4, 8, 16 and 32 (K = 31, 32)
@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 11, 16, 22, 23, 31, 32])
@pytest.mark.parametrize("density", [0.3, 1.0, "signed_zero", "nan"])
@pytest.mark.parametrize("skel", SKELETONS)
def test_greedy_kernel_equals_plain(cuda, skel, k, density):
    n_limbs = SKELETONS[skel].n_limbs
    scores = _scores(np.random.default_rng(k), 5, k, density, n_limbs)
    before = greedy.launches
    out = greedy.greedy_assign(scores.to(cuda), k)
    torch.cuda.synchronize()
    assert greedy.launches == before + 1
    for o, r in zip(out, greedy.greedy_assign_plain(scores, k)):
        assert o.device.type == "cuda" and o.shape[1] == n_limbs
        assert torch.equal(o.cpu(), r)


# the random connection sets at table sizes below 32, odd K (16-byte and
# element-wise staging) and K = 64 (over 48 KB of shared memory), then each
# set of kernel_inputs.merge_connections at the table size it is meant for
_MERGE_CASES = [pytest.param(k, m, "random", id=f"{k}-{m}")
                for k, m in [(1, 1), (4, 4), (8, 16), (16, 7), (16, 32),
                             (32, 31), (32, 32), (5, 32), (31, 32),
                             (64, 32)]]
_MERGE_CASES += [pytest.param(k, m, kind, id=f"{kind}-{k}")
                 for kind, m in kernel_inputs.MERGE_KINDS.items()
                 for k in (16, 32)]


@pytest.mark.parametrize("k,m,kind", _MERGE_CASES)
@pytest.mark.parametrize("skel", SKELETONS)
def test_merge_kernel_equals_plain(cuda, skel, k, m, kind):
    skel = SKELETONS[skel]
    seed = 100 if skel is COCO18 else 200
    args = _conns(np.random.default_rng(seed + k * m), 6, k, kind, skel)
    before = merge.launches
    out = merge.assemble(*[t.to(cuda) for t in args], k, m)
    torch.cuda.synchronize()
    assert merge.launches == before + 1
    ref = merge.assemble_plain(*args, k, m)
    assert ref[0].shape == (6, m, skel.n_parts)
    for o, r in zip(out, ref):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), r)


@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("skel", SKELETONS)
def test_merge_kernel_on_greedy_output(cuda, skel, k):
    """The two kernels chained as the decoder chains them."""
    skel = SKELETONS[skel]
    rng = np.random.default_rng(7 if skel is COCO18 else 9)
    scores = _scores(rng, 8, k, 0.3, skel.n_limbs)
    conns = greedy.greedy_assign(scores.to(cuda), k)
    peak_score = torch.from_numpy(kernel_inputs.peak_scores(rng, 8, k,
                                                            skel.n_parts))
    out = merge.assemble(*conns, peak_score.to(cuda), k, 32)
    ref = merge.assemble_plain(*greedy.greedy_assign_plain(scores, k),
                               peak_score, k, 32)
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu(), r)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    scores = _scores(np.random.default_rng(0), 2, 16, 0.3).to(cuda)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores.double(), 16)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores.transpose(2, 3), 16)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores[:, :18].contiguous(), 16)
    big = torch.zeros((1, 19, 33, 33), device=cuda)
    with pytest.raises(ValueError, match="K <= 32"):
        greedy.greedy_assign(big, 33)
    args = [t.to(cuda) for t in _conns(np.random.default_rng(1), 2, 16)]
    with pytest.raises(ValueError, match="max_humans <= 32"):
        merge.assemble(*args, 16, 33)
    with pytest.raises(ValueError):
        merge.assemble(*args[:4], args[4].cpu(), 16, 32)
    with pytest.raises(ValueError):
        merge.assemble(args[0].long(), *args[1:], 16, 32)


def test_empty_batch_launches_nothing(cuda):
    """A batch of 0 images returns empty outputs and launches no kernel."""
    scores = torch.zeros((0, 19, 16, 16), device=cuda)
    args = [t.to(cuda) for t in _conns(np.random.default_rng(2), 0, 16)]
    before = (greedy.launches, merge.launches)
    out = greedy.greedy_assign(scores, 16) + merge.assemble(*args, 16, 32)
    assert (greedy.launches, merge.launches) == before
    assert [tuple(t.shape) for t in out] == [
        (0, 19, 16)] * 4 + [(0, 32, 18), (0, 32), (0, 32)]


def _sepconv_args(rng, b, h, w, c, f):
    x, *weights = kernel_inputs.sepconv_inputs(rng, b, h, w, c, f)
    return [torch.from_numpy(x).to(torch.bfloat16),
            *map(torch.from_numpy, weights)]


def _assert_bf16_close(out, ref, floor=0.0, max_units=2.0):
    units, same = kernel_inputs.bf16_mismatch(
        out.float().cpu().numpy(), ref.float().cpu().numpy(), floor)
    assert units <= max_units and same >= 0.98, (units, same)


# H, W = 11, 13: neither is a multiple of a tile side
@pytest.mark.parametrize("c", [1, 8, 57, 537])
@pytest.mark.parametrize("f", [1, 40, 384])
def test_sepconv_kernel_matches_plain(cuda, c, f):
    args = _sepconv_args(np.random.default_rng(c * f), 2, 11, 13, c, f)
    before = sepconv.launches
    with torch.no_grad():
        out = sepconv.fused_sepconv(*[t.to(cuda) for t in args])
        torch.cuda.synchronize()
        assert sepconv.launches == before + 1
        assert out.device.type == "cuda" and out.shape == (2, 11, 13, f)
        floor = args[4].to(torch.bfloat16).float().abs().numpy()
        _assert_bf16_close(out, sepconv.fused_sepconv_plain(*args), floor)
        _assert_bf16_close(out, sepconv.fused_sepconv_plain(
            *[t.to(cuda) for t in args]), floor)


def test_fused_module_on_channels_last_activations(cuda):
    """SepConvRelu(fused) reads the model's NCHW channels-last tensors as
    NHWC; an NCHW-contiguous tensor is refused, never copied silently."""
    from openpose_plus_tpu_torch.models.common import SepConvRelu, init_params

    fused = SepConvRelu(48, 24, fused=True)
    plain = SepConvRelu(48, 24)
    init_params(fused, torch.Generator().manual_seed(0))
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 48, 10, 12, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        ref = plain(x)
        out = fused.to(cuda)(x.to(cuda).contiguous(
            memory_format=torch.channels_last))
        _assert_bf16_close(out, ref)
        with pytest.raises(ValueError, match="channels-last"):
            fused(x.to(cuda).contiguous())


# K = 1 ... 32 on a small map, then the served decodes' maps at batch 8:
# the default's 92x108 at K 16, fidelity()'s 368x432 at K 32, and the
# BODY_25 cell's 92x164 at K 16
@pytest.mark.parametrize("b,h,w,k", [
    *[(3, 23, 29, k) for k in (1, 2, 5, 16, 23, 32)],
    (8, 92, 108, 16), (8, 368, 432, 32), (8, 92, 164, 16)])
@pytest.mark.parametrize("skel", SKELETONS)
def test_sample_paf_kernel_equals_plain(cuda, skel, b, h, w, k):
    """COCO's limbs in reversed channel order (any table), BODY_25's by its
    own table."""
    skel = SKELETONS[skel]
    paf, sy, sx = kernel_inputs.paf_samples(np.random.default_rng(k), b, h,
                                            w, k, n_limbs=skel.n_limbs)
    chans = (torch.as_tensor(np.asarray(
        [[2 * i, 2 * i + 1] for i in range(19)])[::-1].copy())
        if skel is COCO18 else paf_sample.limb_channels(
            torch.device("cpu"), skel))
    args = [torch.from_numpy(a) for a in (paf, sy, sx)] + [chans]
    before = paf_sample.launches
    out = paf_sample.sample_paf(*[t.to(cuda) for t in args])
    torch.cuda.synchronize()
    assert paf_sample.launches == before + 1
    for o, r in zip(out, paf_sample.sample_paf_plain(*args)):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), r)


# ---------------------------------------------------------------- peaks ---

_POSTPROC = {"default": PostprocConfig(), "fidelity": PostprocConfig().fidelity()}


def _smoothed(kind, post, b, skel=COCO18, hw=(46, 54)):
    """`kernel_inputs.peak_scene(kind, b)` of `skel`'s figures tiled to the
    `hw` grid, upsampled and smoothed on the CPU as the decode does: the
    einsum's layout, H outermost."""
    maps = torch.from_numpy(kernel_inputs.peak_scene(
        kind, b, None if skel is COCO18 else skel))
    h, w = hw
    maps = maps.repeat(1, -(-h // maps.shape[1]), -(-w // maps.shape[2]),
                       1)[:, :h, :w]
    return nms.upsample_smooth(maps.contiguous(), post.upsample_factor,
                               post.smooth_sigma)


def _assert_peaks_equal(cuda, smoothed, threshold, k, on_card=None):
    """The kernels on the card (on `on_card`, else `smoothed` copied with
    its strides) against the plain version on the CPU: all six fields, one
    row a part (the maps' last channel is the background), the floats
    compared as their bits."""
    before = peaks.launches
    out = peaks.find_peaks(smoothed.to(cuda) if on_card is None else on_card,
                           threshold, k)
    torch.cuda.synchronize()
    assert peaks.launches == before + 1
    ref = nms.find_peaks_plain(smoothed, threshold, k)
    for o, r in zip(out, [getattr(ref, f) for f in peaks.FIELDS]):
        assert o.device.type == "cuda" and o.dtype == r.dtype
        assert o.shape[1] == smoothed.shape[-1] - 1
        o = o.cpu()
        if r.dtype == torch.float32:
            o, r = o.view(torch.int32), r.view(torch.int32)
        assert torch.equal(o, r)
    return out


# the scenes' own 46x54 grid under both decodes, and the default decode on
# the BODY_25 cell's 46x82 grid (92x164 maps), the scenes tiled to it
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("post,grid", [("default", "46x54"),
                                       ("fidelity", "46x54"),
                                       ("default", "46x82")])
@pytest.mark.parametrize("kind", ["plateau", "clean", "noisy", "very_noisy",
                                  "pure_noise"])
@pytest.mark.parametrize("skel", SKELETONS)
def test_peaks_kernel_equals_plain(cuda, skel, kind, post, grid, b):
    skel, cfg = SKELETONS[skel], _POSTPROC[post]
    hw = tuple(map(int, grid.split("x")))
    smoothed = _smoothed(kind, cfg, b, skel, hw)
    assert smoothed.shape == (b, *(n * cfg.upsample_factor for n in hw),
                              skel.n_heatmaps)
    out = _assert_peaks_equal(cuda, smoothed, cfg.peak_threshold,
                              cfg.max_peaks)
    if kind == "plateau" and hw == (46, 54):   # one peak a plateau, two
        assert int(out[3].sum()) == 2 * skel.n_parts * b     # people an image


# 368x432: the fidelity grid at its bound; 92x108 with K over the 1,024
# keys ranked in shared memory (K under and over the row's 2,484 peaks);
# the BODY_25 cell's 92x164; odd sides
@pytest.mark.parametrize("h,w,k", [(368, 432, 32), (92, 108, 2000),
                                   (92, 108, 3000), (92, 164, 16),
                                   (7, 9, 32)])
@pytest.mark.parametrize("skel", SKELETONS)
def test_peaks_kernel_on_a_checkerboard(cuda, skel, h, w, k):
    """Every row at ceil(H/2) * ceil(W/2) peaks of one score: the capacity
    is reached (in both part groups of a tile at 25 parts) and the ties go
    to the lowest flat index."""
    skel = SKELETONS[skel]
    smoothed = torch.from_numpy(kernel_inputs.checkerboard_peaks(
        2, h, w, skel.n_heatmaps))
    _assert_peaks_equal(cuda, smoothed, 0.5, k)
    assert torch.equal(peaks.candidates.cpu(), torch.full(
        (2, skel.n_parts), peaks.capacity(h, w), dtype=torch.int32))


def test_peaks_kernel_on_non_finite_maps(cuda):
    """An inf conf pixel smoothed as test_non_finite_maps_decode_as_reference
    makes it (its rows and columns turn NaN in the contraction), and inf,
    -inf, NaN pixels and a NaN column put into the smoothed maps."""
    cfg = _POSTPROC["default"]
    conf = np.concatenate([kernel_inputs.peak_scene(k)
                           for k in ("clean", "noisy", "clean")])
    conf[0, 5, 7, 3] = np.inf
    smoothed = nms.upsample_smooth(torch.from_numpy(conf),
                                   cfg.upsample_factor, cfg.smooth_sigma)
    _assert_peaks_equal(cuda, smoothed, cfg.peak_threshold, cfg.max_peaks)
    maps = _smoothed("noisy", cfg, 2).contiguous()
    maps[0, 10, 20, 0] = np.inf
    maps[0, 30:32, 40:42, 1] = np.inf
    maps[0, 0, 0, 2] = np.inf
    maps[1, 50, 60, 3] = np.nan
    maps[1, :, 70, 4] = np.nan
    maps[1, 91, 107, 5] = -np.inf
    _assert_peaks_equal(cuda, maps, cfg.peak_threshold, cfg.max_peaks)


def test_peaks_kernel_on_equal_scores(cuda):
    """Quarter steps of uniform noise: plateaus, and many more than K peaks
    of each score in a row."""
    rng = np.random.default_rng(5)
    maps = torch.from_numpy(
        np.round(rng.uniform(0, 3, (3, 60, 70, 19))).astype(np.float32) / 4)
    for k in (1, 16, 32):
        _assert_peaks_equal(cuda, maps, 0.1, k)


@pytest.mark.parametrize("shape,k", [((1, 3, 5), 32), ((2, 4, 4), 16),
                                     ((1, 1, 1), 3), ((2, 46, 54), 400)])
def test_peaks_kernel_with_fewer_peaks_than_k(cuda, shape, k):
    """H * W below or at K, and rows with fewer peaks than K: the slots past
    them hold index 0, score 0 and valid false."""
    rng = np.random.default_rng(sum(shape) + k)
    maps = torch.from_numpy(rng.uniform(0, 0.4, (*shape, 19))
                            .astype(np.float32))
    out = _assert_peaks_equal(cuda, maps, 0.05, k)
    assert not bool(out[3][..., -1].any())


def test_peaks_kernel_with_signed_zeros_under_a_negative_threshold(cuda):
    """-0.0 and +0.0 peaks tie (ties to the lowest index, as torch.sort
    ties them), and each keeps its own sign in the score."""
    rng = np.random.default_rng(6)
    maps = torch.from_numpy(rng.choice(np.asarray(
        [-0.0, 0.0, -1.0], np.float32), (2, 20, 24, 19)))
    out = _assert_peaks_equal(cuda, maps, -0.5, 16)
    score = out[2][out[3]].cpu()
    assert bool((score == 0).all()) and bool(torch.signbit(score).any())
    assert not bool(torch.signbit(score).all())


def test_peaks_kernel_reads_any_layout(cuda):
    """The einsum's layout (H outermost), the contiguous copy and a channel
    slice of wider maps: one PeakSet."""
    cfg = _POSTPROC["fidelity"]
    smoothed = _smoothed("noisy", cfg, 2)
    assert not smoothed.is_contiguous()
    einsum = smoothed.to(cuda)
    assert einsum.stride() == smoothed.stride()
    wide = torch.cat([einsum, torch.ones_like(einsum)], dim=-1)[..., 5:24]
    for on_card in (einsum, einsum.contiguous()):
        _assert_peaks_equal(cuda, smoothed, cfg.peak_threshold,
                            cfg.max_peaks, on_card)
    _assert_peaks_equal(cuda, wide.cpu(), cfg.peak_threshold, cfg.max_peaks,
                        wide)


def test_peaks_kernel_on_an_empty_batch_launches_nothing(cuda):
    before = peaks.launches
    out = peaks.find_peaks(torch.zeros((0, 8, 8, 19), device=cuda), 0.05, 16)
    out0 = peaks.find_peaks(torch.zeros((1, 8, 8, 19), device=cuda), 0.05, 0)
    assert peaks.launches == before
    assert [tuple(t.shape) for t in out + out0] == (
        [(0, 18, 16)] * 6 + [(1, 18, 0)] * 6)


def test_peaks_kernel_replays_in_a_cuda_graph(cuda):
    """Captured once, replayed on other maps copied into the captured
    input: each replay equals the eager call on those maps."""
    cfg = _POSTPROC["fidelity"]
    maps = [_smoothed(kind, cfg, 2).to(cuda)
            for kind in ("noisy", "very_noisy", "pure_noise")]
    static = maps[0].clone()
    peaks.find_peaks(static, cfg.peak_threshold, cfg.max_peaks)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = peaks.find_peaks(static, cfg.peak_threshold, cfg.max_peaks)
    for m in maps[1:] + maps[:1]:
        static.copy_(m)
        before = peaks.launches
        graph.replay()
        torch.cuda.synchronize()
        assert peaks.launches == before
        eager = peaks.find_peaks(m, cfg.peak_threshold, cfg.max_peaks)
        for o, e in zip(out, eager):
            assert torch.equal(o, e)


def test_peaks_kernel_runs_no_sort_topk_or_max_pool(cuda):
    """What the device runs for find_peaks on the card: the two kernels,
    and none of the plain version's sort, top-K or max-pool kernels (which
    the same trace shows for the plain version)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _POSTPROC["fidelity"]
    maps = _smoothed("noisy", cfg, 2).to(cuda)
    names = {}
    for label, fn in (("kernel", nms.find_peaks),
                      ("plain", nms.find_peaks_plain)):
        fn(maps, cfg.peak_threshold, cfg.max_peaks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(maps, cfg.peak_threshold, cfg.max_peaks)
            torch.cuda.synchronize()
        names[label] = " ".join(e.key for e in prof.key_averages()).lower()
    assert "sort" in names["plain"] and "max_pool" in names["plain"]
    assert "peak_keys_kernel" in names["kernel"]
    assert "select_kernel" in names["kernel"]
    for word in ("sort", "topk", "max_pool"):
        assert word not in names["kernel"], names["kernel"]


def test_peaks_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    maps = torch.zeros((1, 8, 8, 19), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        peaks.find_peaks(maps.double(), 0.05, 16)
    with pytest.raises(ValueError):
        peaks.find_peaks(maps[..., :17], 0.05, 16)
    with pytest.raises(ValueError):
        peaks.find_peaks(maps[0], 0.05, 16)
    with pytest.raises(ValueError, match="pixels"):    # over 2**24
        peaks.find_peaks(maps[:, :1, :1].expand(1, 4097, 4096, 19), 0.05, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        peaks.find_peaks(maps.to("meta"), 0.05, 16)


# The redesigned kernel's tilings: a block owns 128 pixels (8x16 or 16x8,
# whichever pads the image least) and an F tile of 64, 128 or 192; the
# input channels stream in chunks of 32 by 16-byte copies, each pixel's
# chunk at a shift of 0..7 elements where C % 8 != 0.
@pytest.mark.parametrize("b,h,w,c,f", [
    (2, 46, 54, 537, 128),    # the model's grids at one shape each:
    (2, 23, 27, 192, 384),    # 16x8 tiles at 46x54, 8x16 at 23x27 and
    (1, 69, 81, 128, 128),    # 69x81
    (2, 9, 17, 64, 100),      # F not a multiple of the F tile (128)
    (1, 17, 9, 40, 200),      # F = 200: two F tiles of 128
    (1, 12, 20, 33, 257),     # F = 257: two of 192; C odd: shifted
    (1, 1, 1, 96, 64),        # one pixel: all halo is padding
    (3, 33, 7, 24, 8),        # ragged against both tile sides
    (1, 16, 16, 480, 192),    # tiles exactly filled, C % 32 == 0
    (3, 13, 21, 57, 40),      # ragged tiles, C % 8 != 0
    # the fused MobileNet-thin's six (C, F) layer shapes at batch 8 on its
    # grids: 46x54 (368x432) and the scale search's 23x27 and 69x81
    *[(8, h, w, c, f) for h, w in ((46, 54), (23, 27), (69, 81))
      for c, f in ((128, 128), (192, 192), (192, 384), (384, 384),
                   (480, 128), (537, 128))],
])
def test_sepconv_kernel_tilings(cuda, b, h, w, c, f):
    args = _sepconv_args(np.random.default_rng(h * w + c), b, h, w, c, f)
    floor = args[4].to(torch.bfloat16).float().abs().numpy()
    with torch.no_grad():
        out = sepconv.fused_sepconv(*[t.to(cuda) for t in args])
        torch.cuda.synchronize()
        assert out.shape == (b, h, w, f)
        _assert_bf16_close(out, sepconv.fused_sepconv_plain(*args), floor)


@pytest.mark.parametrize("offset", [1, 2])
def test_sepconv_kernel_on_unaligned_views(cuda, offset):
    """x as a view 2 or 4 bytes into its storage: the 16-byte copies need
    16-byte aligned data, so the wrappers copy such an x first."""
    args = _sepconv_args(np.random.default_rng(offset), 2, 13, 21, 128, 128)
    flat = torch.cat([torch.zeros(offset, dtype=torch.bfloat16),
                      args[0].flatten()]).to(cuda)
    x = flat[offset:].view(args[0].shape)
    assert x.data_ptr() % 16 != 0
    floor = args[4].to(torch.bfloat16).float().abs().numpy()
    with torch.no_grad():
        out = sepconv.fused_sepconv(x, *[t.to(cuda) for t in args[1:]])
        _assert_bf16_close(out, sepconv.fused_sepconv_plain(*args), floor)
        dwk = args[1].reshape(9, 128).to(torch.bfloat16)
        _assert_bf16_close(dw_probe.dw3x3_relu(x, dwk.to(cuda)),
                           dw_probe.dw3x3_relu_plain(args[0], dwk),
                           max_units=1.0)


@pytest.mark.parametrize("shape", [(2, 46, 82, 256), (1, 23, 27, 537),
                                   (2, 9, 17, 40)])
def test_probe_dw_kernel_shapes(cuda, shape):
    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    dwk = torch.from_numpy((rng.standard_normal((9, shape[-1])) * 0.1)
                           .astype(np.float32)).to(torch.bfloat16)
    dw = dw_probe.dw3x3_relu(x.to(cuda), dwk.to(cuda))
    _assert_bf16_close(dw, dw_probe.dw3x3_relu_plain(x, dwk), max_units=1.0)


# scripts/profile_pallas_dw.py's batch (8) at both its widths, and C = 20
@pytest.mark.parametrize("b,c", [(2, 128), (2, 20), (8, 128), (8, 256)])
def test_probe_kernels_match_plain(cuda, b, c):
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((b, 46, 82, c)).astype(
        np.float32)).to(torch.bfloat16)
    dwk = torch.from_numpy((rng.standard_normal((9, c)) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    before = (dw_probe.dw3x3_relu_launches, dw_probe.copy_bias_launches)
    dw = dw_probe.dw3x3_relu(x.to(cuda), dwk.to(cuda))
    cp = dw_probe.copy_bias(x.to(cuda), dwk.to(cuda))
    torch.cuda.synchronize()
    assert (dw_probe.dw3x3_relu_launches,
            dw_probe.copy_bias_launches) == (before[0] + 1, before[1] + 1)
    _assert_bf16_close(dw, dw_probe.dw3x3_relu_plain(x, dwk), max_units=1.0)
    assert torch.equal(cp.cpu(), dw_probe.copy_bias_plain(x, dwk))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = [t.to(cuda) for t in _sepconv_args(np.random.default_rng(5), 1, 9,
                                              10, 16, 8)]
    with torch.no_grad():
        with pytest.raises(ValueError, match="stride 1"):
            sepconv.fused_sepconv(*args, stride=2)
        with pytest.raises(ValueError, match="bf16"):
            sepconv.fused_sepconv(args[0].float(), *args[1:])
        nchw = args[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        with pytest.raises(ValueError, match="contiguous"):
            sepconv.fused_sepconv(nchw, *args[1:])
        with pytest.raises(ValueError, match="one device"):
            sepconv.fused_sepconv(args[0], args[1].cpu(), *args[2:])
    w = args[1].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        sepconv.fused_sepconv(args[0], w, *args[2:])
    dwk = args[1].reshape(9, 16).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        dw_probe.dw3x3_relu(args[0].float(), dwk)
    with pytest.raises(ValueError, match="bf16"):
        dw_probe.copy_bias(nchw, dwk)
    paf, sy, sx = (torch.from_numpy(a).to(cuda) for a in
                   kernel_inputs.paf_samples(np.random.default_rng(6), 1, 8,
                                             9, 4))
    chans = torch.arange(38, device=cuda).reshape(19, 2)
    with pytest.raises(ValueError, match="int32"):
        paf_sample.sample_paf(paf, sy.long(), sx, chans)
    with pytest.raises(ValueError, match="contiguous"):
        paf_sample.sample_paf(paf.transpose(1, 2).contiguous().transpose(
            1, 2), sy, sx, chans)
    with pytest.raises(ValueError):
        paf_sample.sample_paf(paf, sy[:, :18], sx[:, :18], chans)


def test_new_kernels_launch_nothing_on_an_empty_batch(cuda):
    args = [t.to(cuda) for t in _sepconv_args(np.random.default_rng(7), 0, 9,
                                              10, 16, 8)]
    paf, sy, sx = (torch.from_numpy(a).to(cuda) for a in
                   kernel_inputs.paf_samples(np.random.default_rng(8), 0, 8,
                                             9, 4))
    chans = torch.arange(38, device=cuda).reshape(19, 2)
    dwk = torch.zeros((9, 16), dtype=torch.bfloat16, device=cuda)
    before = (sepconv.launches, paf_sample.launches,
              dw_probe.dw3x3_relu_launches, dw_probe.copy_bias_launches)
    with torch.no_grad():
        y = sepconv.fused_sepconv(*args)
    px, py = paf_sample.sample_paf(paf, sy, sx, chans)
    dw = dw_probe.dw3x3_relu(args[0], dwk)
    cp = dw_probe.copy_bias(args[0], dwk)
    assert (sepconv.launches, paf_sample.launches,
            dw_probe.dw3x3_relu_launches,
            dw_probe.copy_bias_launches) == before
    assert [tuple(t.shape) for t in (y, px, py, dw, cp)] == [
        (0, 9, 10, 8), (0, 19, 10, 4, 4), (0, 19, 10, 4, 4),
        (0, 9, 10, 16), (0, 9, 10, 16)]


def _int8_case(rng, b, h, w, cin, cout, k, dev):
    """The int8 conv's inputs on `dev` (kernel_inputs.int8_conv_inputs):
    q, the packed weights, rescale, bias and the floored s_out."""
    q, weight, bias, s_in, s_out = kernel_inputs.int8_conv_inputs(
        rng, b, h, w, cin, cout, k)
    qw, wmax = int8_conv.quantize_weight(torch.from_numpy(weight))
    return [torch.from_numpy(q).to(dev),
            int8_conv.pack_weight(qw).to(dev),
            int8_conv.rescale(torch.tensor(s_in).to(dev), wmax.to(dev)),
            torch.from_numpy(bias).to(dev), torch.tensor(s_out).to(dev)]


def _same_pads(h, w, k, stride):
    def low(size):
        out = -(-size // stride)
        return max((out - 1) * stride + k - size, 0) // 2
    return low(h), low(w)


# (B, H, W, Cin, Cout, k, stride): every kernel size, stride 2 on even
# (pads (0, 1)) and odd sizes, Cin 3 / 185 / 537 (channel-padded rows) and
# multiples of 16, Cout off the 64-wide tile, M off the pixel tile; then
# the tile plan's cases: Cout 256 and 512 (several 128-wide N tiles), M of
# 128 and 129 pixels (part of one 192 x 128 block; at Cout 64 and 40 one
# 128 x 64 block and one more pixel), a 7x7 over Cin 576 (441 stages: the
# ring wraps 55 times), stride 2 of a 7x7 and a 1x1 on even sizes (the
# im2col box's corners), and M = 19968 (104 blocks of 192 pixels) and
# 19969 (a last block of one pixel); then Cin 3 / 185 / 537 at larger
# sizes: stride 2 of a 3x3 and a 7x7, a 1x1 on MobileNet-thin's 46x54
# grid, a 7x7 on the scale search's 23x27
_INT8_CASES = [(2, 10, 12, 3, 24, 3, 2), (2, 9, 11, 3, 64, 3, 2),
               (1, 12, 14, 3, 64, 3, 1), (2, 7, 9, 185, 128, 7, 1),
               (1, 8, 10, 537, 128, 1, 1), (2, 9, 10, 48, 96, 1, 1),
               (1, 13, 17, 24, 48, 3, 2), (3, 5, 6, 128, 200, 3, 1),
               (1, 11, 9, 32, 40, 7, 2), (2, 6, 5, 16, 8, 1, 1),
               (1, 6, 7, 64, 256, 3, 1), (1, 5, 6, 128, 512, 1, 1),
               (1, 8, 16, 64, 128, 3, 1), (1, 3, 43, 64, 128, 3, 1),
               (1, 9, 10, 576, 64, 7, 1), (2, 14, 16, 64, 128, 7, 2),
               (1, 10, 12, 64, 64, 1, 2), (1, 104, 192, 64, 128, 3, 1),
               (1, 1, 19969, 64, 96, 3, 1), (1, 8, 16, 64, 64, 3, 1),
               (1, 3, 43, 64, 40, 3, 1), (2, 40, 50, 3, 24, 3, 2),
               (3, 17, 19, 185, 200, 7, 2), (2, 46, 54, 537, 128, 1, 1),
               (1, 23, 27, 185, 128, 7, 1), (1, 9, 7, 537, 40, 3, 2)]


# int8 out at the layer's s_out, bf16 out, and int8 out at s_out 1e-6
# (every positive output saturates)
@pytest.mark.parametrize("case", _INT8_CASES)
@pytest.mark.parametrize("mode", ["int8", "bf16", "saturated"])
def test_int8_conv_kernel_equals_plain(cuda, case, mode):
    b, h, w, cin, cout, k, stride = case
    args = _int8_case(np.random.default_rng(cin + k), b, h, w, cin, cout,
                      k, cuda)
    q, wp, rs, bias, s_out = args
    quant = mode != "bf16"
    s_out = {"int8": s_out, "bf16": None,
             "saturated": torch.full_like(s_out, 1e-6)}[mode]
    pads = _same_pads(h, w, k, stride)
    before = int8_conv.launches
    out = int8_conv.int8_conv(q, wp, k, rs, bias, stride, pads, s_out)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    ref = int8_conv.int8_conv_plain(q, wp, k, rs, bias, stride, pads, s_out)
    cpu = int8_conv.int8_conv_plain(
        q.cpu(), wp.cpu(), k, rs.cpu(), bias.cpu(), stride, pads,
        None if s_out is None else s_out.cpu())
    assert out.dtype == (torch.int8 if quant else torch.bfloat16)
    assert torch.equal(out, ref) and torch.equal(out.cpu(), cpu)
    if quant:
        assert int(out.abs().max()) == 127 and int((out == 0).sum()) > 0


@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (1000,), (4099,),
                                   (2, 5, 7, 3), (2, 5, 7, 24),
                                   (2, 5, 7, 128), (2, 5, 7, 185),
                                   (2, 5, 7, 537), (3, 61, 67, 537),
                                   (1, 2053, 185), (4111, 24), (2, 1201, 3),
                                   (3, 333, 1000), (7, 96), (2, 16448)])
@pytest.mark.parametrize("scale", [0.0, 0.8, 1.0])
def test_quantize_kernel_equals_plain(cuda, shape, scale):
    """Clipping, the 1e-6 floor, and the .5 ties of t = (2i + 1) / 254 at
    scale 1; rows of C % 8 != 0 (pieces across rows), C % 8 == 0 (a piece
    in one row) and C % 64 == 0 (the flat pass, also where a row is longer
    than the padded pass's staging tile), the others written
    channel-padded to a multiple of 64 with zeros; row counts that give a
    block several rows and leave the tensor's last 16-byte piece partial
    (rows * C % 8 != 0: 537, 185, 3 and 1000 channels)."""
    size = int(np.prod(shape))
    rng = np.random.default_rng(size)
    ties = (np.arange(-127, 127) * 2 + 1) / 254.0
    x = np.concatenate([rng.standard_normal(size) * 2, ties])[:size] * 1.0
    x = torch.from_numpy(x.reshape(shape)).to(torch.bfloat16).to(cuda)
    s = torch.tensor(scale, device=cuda)
    before = int8_conv.quantize_launches
    out = int8_conv.quantize_act(x, s)
    torch.cuda.synchronize()
    assert int8_conv.quantize_launches == before + 1
    assert out.shape == (*shape[:-1], int8_conv.padded(shape[-1]))
    assert torch.equal(out, int8_conv.quantize_act_plain(x, s))
    assert torch.equal(out.cpu(), int8_conv.quantize_act_plain(x.cpu(),
                                                               s.cpu()))


def test_quantize_kernel_takes_a_scalar(cuda):
    """A 0-d input takes the flat pass and comes back 0-d, as the plain
    version's."""
    s = torch.tensor(0.8, device=cuda)
    before = int8_conv.quantize_launches
    for v in (-3.0, -0.5, 0.3, 0.8, 5.0):
        x = torch.tensor(v, dtype=torch.bfloat16, device=cuda)
        out = int8_conv.quantize_act(x, s)
        assert out.shape == () and out.dtype == torch.int8
        assert torch.equal(out, int8_conv.quantize_act_plain(x, s))
    assert int8_conv.quantize_launches == before + 5


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, wp, rs, bias, s_out = _int8_case(np.random.default_rng(0), 1, 6, 7,
                                        16, 8, 3, cuda)
    pads = (1, 1)
    with pytest.raises(ValueError, match="int8"):
        int8_conv.int8_conv(q.float(), wp, 3, rs, bias, 1, pads, s_out)
    with pytest.raises(ValueError, match="packed"):
        int8_conv.int8_conv(q, wp, 1, rs, bias, 1, (0, 0), s_out)
    with pytest.raises(ValueError, match="bias"):
        int8_conv.int8_conv(q, wp, 3, rs, bias[:4], 1, pads, s_out)
    with pytest.raises(ValueError, match="s_out"):
        int8_conv.int8_conv(q, wp, 3, rs, bias, 1, pads, s_out.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv(q.transpose(1, 2).contiguous().transpose(1, 2),
                            wp, 3, rs, bias, 1, pads, s_out)
    with pytest.raises(ValueError, match="stride"):
        int8_conv.int8_conv(q, wp, 3, rs, bias, 3, pads, s_out)
    x = torch.zeros((4, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        int8_conv.quantize_act(x, s_out)
    with pytest.raises(ValueError, match="scale"):
        int8_conv.quantize_act(x.bfloat16(), s_out.cpu())
    before = (int8_conv.launches, int8_conv.quantize_launches)
    empty = int8_conv.int8_conv(q[:0], wp, 3, rs, bias, 1, pads, s_out)
    assert empty.shape == (0, 6, 7, 8)
    assert int8_conv.quantize_act(x[:0].bfloat16(), s_out).shape == (0, 64)
    assert (int8_conv.launches, int8_conv.quantize_launches) == before


@pytest.mark.parametrize("args", kernel_inputs.INT8_REFUSED)
def test_int8_launcher_refuses_what_the_tile_plan_refuses(cuda, args):
    """int8_conv_launch itself returns an error under every plan for each
    shape the tile plan refuses: it checks its arguments before it reads a
    pointer, so none is passed."""
    from openpose_plus_tpu_torch.ops.cuda import build
    lib = build.load()
    b, h, w, cin_p, cout, k, stride, (top, left) = args
    ho, wo = -(-h // stride), -(-w // stride)
    for plan in int8_conv.PLANS:
        assert lib.int8_conv_launch(None, None, None, None, None, None, b, h,
                                    w, cin_p, cout, ho, wo, k, stride, top,
                                    left, *plan, cuda.index, None) != 0


@pytest.mark.parametrize("name", ["mobilenet_thin", "vggtiny"])
def test_int8_engine_runs_every_int8_layer_through_the_kernel(cuda, name):
    """A small int8 engine on the card: one int8_conv launch per ConvRelu
    and SepConvRelu, and its maps equal those of the same forward with
    every kernel call sent to its plain version."""
    import dataclasses

    from openpose_plus_tpu_torch import Engine, default_config
    from openpose_plus_tpu_torch.models import common

    cfg = default_config(name)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=80, n_stages=2, compute_dtype="int8"))
    engine = Engine(cfg, seed=0, device=cuda)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64, 80, 3), dtype=np.uint8)).to(cuda)
    engine.calibrate(images)
    layers = sum(isinstance(m, (common.ConvRelu, common.SepConvRelu))
                 for m in engine.model.modules())
    before = int8_conv.launches
    maps = engine.forward(images)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + layers
    kernel, quant = int8_conv.int8_conv, int8_conv.quantize_act
    try:
        int8_conv.int8_conv = int8_conv.int8_conv_plain
        int8_conv.quantize_act = int8_conv.quantize_act_plain
        plain = engine.forward(images)
    finally:
        int8_conv.int8_conv, int8_conv.quantize_act = kernel, quant
    for a, b in zip(maps, plain):
        assert torch.equal(a, b)


# ------------------------------------------------------ the deploy path ---

def _deploy_engine(cuda, dtype="bfloat16", fused=False):
    """A small MobileNet-thin on the card, its last stage's prediction
    kernels scaled (as tests/test_torch_engine.py scales them) so random
    images decode to humans."""
    import dataclasses

    from openpose_plus_tpu_torch import Engine, default_config

    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=80, n_stages=2, compute_dtype=dtype,
        fused_inference=fused))
    engine = Engine(cfg, seed=3, device=cuda)
    with torch.no_grad():
        for name, p in engine.model.named_parameters():
            for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
                if name.endswith(f"stage2_{branch}.Conv_0.weight"):
                    p.mul_(gain)
    return engine


def _deploy_images(cuda, seed, b=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, 64, 80, 3), dtype=np.uint8)).to(cuda)


def _same_humans(a, b):
    import dataclasses

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("fused", [False, True])
def test_compiled_replay_equals_eager(cuda, fused):
    """compile captures infer in a CUDA graph: the replay launches no
    kernel from Python (the counts stay) and gives the eager HumanBatch;
    the s2d^2 layout compiles too; other shapes stay eager, and flip-TTA
    (its own graph since its first call) gives its first call's result."""
    from openpose_plus_tpu_torch.models.common import space_to_depth

    engine = _deploy_engine(cuda, fused=fused)
    images = _deploy_images(cuda, 0)
    eager = engine.infer(images)
    flip = engine.infer(images, flip_tta=True)
    packed = space_to_depth(space_to_depth(images))
    engine.compile(2)
    engine.compile(2, "s2d2")
    assert all(v is not None for v in engine._graphs.values())
    before = (greedy.launches, merge.launches, sepconv.launches)
    out = engine.infer(images)
    out2 = engine.infer(packed)
    torch.cuda.synchronize()
    assert (greedy.launches, merge.launches, sepconv.launches) == before
    assert _same_humans(out, eager) and _same_humans(out2, eager)
    assert int(out.num_humans.sum()) >= 1
    assert _same_humans(engine.infer(images, flip_tta=True), flip)
    before = (greedy.launches,)
    engine.infer(images[:1])               # another shape: eager
    torch.cuda.synchronize()
    assert greedy.launches == before[0] + 1


def test_compiled_result_survives_the_next_call(cuda):
    engine = _deploy_engine(cuda)
    a, b = _deploy_images(cuda, 1), _deploy_images(cuda, 2)
    eager_a, eager_b = engine.infer(a), engine.infer(b)
    assert not _same_humans(eager_a, eager_b)
    engine.compile(2)
    held = engine.infer(a)
    second = engine.infer(b)
    torch.cuda.synchronize()
    assert _same_humans(held, eager_a) and _same_humans(second, eager_b)


def test_graph_captured_while_recording_carries_no_tracer_events(cuda):
    """`compile` while the tracer records: its capture records no device
    span's events (the served graph carries none), the replay equals the
    eager call, and the call's spans and counters are there."""
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    engine = _deploy_engine(cuda)
    images = _deploy_images(cuda, 0)
    eager = engine.infer(images)
    with GLOBAL_TRACER.recording() as rec:
        engine.compile(2)
        out = engine.infer(images)
    torch.cuda.synchronize()
    assert _same_humans(out, eager)
    assert all(s.events is None for s in rec.spans) and not rec.device_ms()
    # the decode's peaks kernel and the conv epilogues: CAPTURE_WARMUP
    # eager steps and the capture
    assert rec.counters == {"graphs.captures": 1, "engine.calls": 1,
                            "engine.replays": 1,
                            "postproc.peaks_kernel": CAPTURE_WARMUP + 1,
                            **{k: (CAPTURE_WARMUP + 1) * v for k, v in
                               kernel_inputs.bias_act_calls(
                                   engine.model).items()}}
    assert {"graphs.capture", "postproc.group", "engine.infer",
            "engine.inputs", "engine.copy_in", "engine.replay",
            "engine.outputs"} <= {s.name for s in rec.spans}


def test_decode_stage_spans_sum_to_the_replay(cuda):
    """20 fidelity decodes of 368x432 maps captured in one graph while the
    tracer records: each replay times every stage of every decode, and the
    stages sum within 5% of the same decodes replayed from a graph
    captured without the tracer (median of 5 replays after the first)."""
    import statistics

    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.postproc import decode_maps
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    calls = 20
    cfg = default_config("mobilenet_thin").postproc.fidelity()
    gen = torch.Generator(device=cuda).manual_seed(0)
    conf = torch.rand(8, 46, 54, 19, device=cuda, generator=gen) * 0.8
    paf = torch.randn(8, 46, 54, 38, device=cuda, generator=gen)

    def capture():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                decode_maps(conf, paf, cfg)
        return graph

    decode_maps(conf, paf, cfg)
    torch.cuda.synchronize()
    plain = capture()
    with GLOBAL_TRACER.recording() as rec:
        traced = capture()
    plain_ms, staged_ms = [], []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain.replay()
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
        traced.replay()
        torch.cuda.synchronize()
        stages = rec.device_ms()
        assert {k: len(v) for k, v in stages.items()} == dict.fromkeys(
            ("postproc.smooth", "postproc.peaks", "postproc.group"), calls)
        staged_ms.append(sum(sum(v) for v in stages.values()))
    plain_med = statistics.median(plain_ms[1:])
    staged_med = statistics.median(staged_ms[1:])
    assert abs(staged_med - plain_med) <= 0.05 * plain_med, (staged_ms,
                                                             plain_ms)


def test_calibrate_drops_the_graph(cuda):
    """An uncalibrated int8 engine captures at its first (calibrating)
    infer; calibrate() drops the graph, the next infer captures again, and
    every replay equals the eager step of the engine as it then is."""
    from openpose_plus_tpu_torch.engine import infer_step

    engine = _deploy_engine(cuda, dtype="int8")
    images = _deploy_images(cuda, 3)
    engine.compile(2)
    shape = tuple(images.shape)
    assert engine._graphs == {shape: None}

    def eager():
        with torch.inference_mode():
            return infer_step(engine.model, images, engine.config.postproc)

    out = engine.infer(images)
    assert engine._graphs[shape] is not None
    assert _same_humans(out, eager())
    engine.calibrate(_deploy_images(cuda, 4) // 2 + 128)
    assert engine._graphs == {shape: None}
    out = engine.infer(images)
    assert engine._graphs[shape] is not None
    assert _same_humans(out, eager())


@pytest.mark.parametrize("dtype,chunk", [("bfloat16", 0), ("int8", 0),
                                         ("bfloat16", 1)])
def test_bench_chained_graph_on_the_card(cuda, dtype, chunk):
    """The bench's chained step (`bench.ChainedStep`) captured on the card:
    each replay serves the images as eager `infer_step` does (an int8
    engine calibrated first; a chunked engine's loop inside the graph),
    launches no kernel from Python, leaves the score sum in the carry, and
    its cost count sees the convolutions."""
    from openpose_plus_tpu_torch import bench
    from openpose_plus_tpu_torch.engine import infer_step

    engine = _deploy_engine(cuda, dtype=dtype)
    engine.chunk = chunk
    images = _deploy_images(cuda, 5)
    engine.calibrate(images)
    with torch.inference_mode():
        eager = infer_step(engine.model, images, engine.config.postproc,
                           chunk)
    chain = bench.ChainedStep(engine, images)
    assert chain.graph is not None
    before = (greedy.launches, merge.launches, int8_conv.launches)
    carry = chain.run(3)
    torch.cuda.synchronize()
    assert (greedy.launches, merge.launches, int8_conv.launches) == before
    assert _same_humans(chain.out, eager)
    assert float(carry) == float(eager.score.sum())
    flops, nbytes = bench.program_cost(engine, chain.images)
    assert flops > 0 and nbytes > 0


def test_stream_and_export_on_the_card(cuda, tmp_path):
    """StreamEstimator compiles the engine and stages frames through its
    pinned buffers: each result equals infer on the letterboxed batch. An
    artifact exported on the card reloads and launches the kernels."""
    from openpose_plus_tpu_torch import export, host, stream
    from openpose_plus_tpu_torch.data.augment import letterbox

    engine = _deploy_engine(cuda)
    m = engine.config.model
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((50, 70), (64, 80), (90, 40), (33, 81), (64, 99))]
    est = stream.StreamEstimator(engine, batch=2)
    results = list(est.run_frames(frames))
    assert [r.n for r in results] == [2, 2, 1]
    for r in results:
        batch = np.zeros(est.shape, np.uint8)
        batch[:r.n] = [host.pack(letterbox(frames[i], m.hin, m.win)[0],
                                 est.s2d) for i in r.indices]
        assert _same_humans(r.humans, engine.infer(batch))
    export.save_engine(engine, str(tmp_path / "a"), batch_size=2)
    loaded = export.load_engine(str(tmp_path / "a"))
    images = _deploy_images(cuda, 6)
    before = greedy.launches
    out = loaded.infer(images)           # warm-ups and the capture
    torch.cuda.synchronize()
    assert greedy.launches == before + CAPTURE_WARMUP + 1
    assert _same_humans(out, engine.infer(images))


# --------------------------------- flip-TTA and the scale search replayed ---

_ACC_ENGINES = {}
_ACC_PATHS = ["tta", "avg", "avg_flip", "dedup", "dedup_flip"]
_ACC_SCALES = (0.5, 1.0, 1.5)


def _acc_engine(cuda, kind, post):
    """_deploy_engine as bf16 ("default"), fused or int8 (calibrated), with
    the default, fidelity() or quality() decoder; one per (kind, post)."""
    if (kind, post) not in _ACC_ENGINES:
        from openpose_plus_tpu_torch import Engine

        base = _deploy_engine(cuda, dtype="int8" if kind == "int8"
                              else "bfloat16", fused=kind == "fused")
        cfg = base.config
        if post != "default":
            cfg = cfg.replace(postproc=getattr(cfg.postproc, post)())
        engine = Engine(cfg, params=base.model.state_dict(), device=cuda)
        engine.calibrate(_deploy_images(cuda, 8))
        _ACC_ENGINES[kind, post] = engine
    return _ACC_ENGINES[kind, post]


def _acc_calls(engine, path):
    """(the engine call, the module function's eager call) of a path."""
    from openpose_plus_tpu_torch import engine as engine_mod

    cfg = engine.config
    if path == "tta":
        return (lambda x: engine.infer(x, flip_tta=True),
                lambda x: engine_mod.infer_tta(engine.model, x,
                                               cfg.postproc))
    combine, _, flip = path.partition("_")
    fn = (engine_mod.infer_multiscale_avg if combine == "avg"
          else engine_mod.infer_multiscale_dedup)
    return (lambda x: engine.infer_multiscale(
                x, _ACC_SCALES, flip_tta=bool(flip), combine=combine),
            lambda x: fn(engine.model, x, cfg.postproc, _ACC_SCALES,
                         bool(flip), cfg.model.stride))


def _python_launches():
    return (greedy.launches, merge.launches, paf_sample.launches,
            sepconv.launches, int8_conv.launches, peaks.launches)


@pytest.mark.parametrize("kind", ["default", "fused", "int8"])
@pytest.mark.parametrize("post", ["default", "fidelity", "quality"])
@pytest.mark.parametrize("path", _ACC_PATHS)
def test_accuracy_replay_equals_eager(cuda, kind, post, path):
    """flip-TTA and the scale search ("avg" and "dedup", with and without
    the flip) capture at their first call and replay one graph a call (no
    kernel launched from Python): each HumanBatch equals the eager module
    function's on the same images bit for bit, and a held result survives
    the next call."""
    engine = _acc_engine(cuda, kind, post)
    call, eager = _acc_calls(engine, path)
    a, b = _deploy_images(cuda, 9), _deploy_images(cuda, 10)
    with torch.inference_mode():
        eager_a, eager_b = eager(a), eager(b)
    n_graphs = len(engine._accuracy_graphs)
    first = call(a)
    assert len(engine._accuracy_graphs) == n_graphs + 1
    torch.cuda.synchronize()
    before = _python_launches()
    held = call(a)
    other = call(b)
    torch.cuda.synchronize()
    assert _python_launches() == before
    assert len(engine._accuracy_graphs) == n_graphs + 1
    assert _same_humans(first, eager_a) and _same_humans(held, eager_a)
    assert _same_humans(other, eager_b)


def test_calibrate_drops_the_accuracy_graphs(cuda):
    """An int8 engine's flip-TTA and scale search graphs hold its scales:
    calibrate() drops them, and the next calls capture again and equal the
    eager calls of the engine as it then is."""
    engine = _deploy_engine(cuda, dtype="int8")
    images = _deploy_images(cuda, 11)
    tta, tta_eager = _acc_calls(engine, "tta")
    avg, avg_eager = _acc_calls(engine, "avg_flip")
    tta(images)                  # calibrates on its batch, then captures
    avg(images)
    assert len(engine._accuracy_graphs) == 2
    engine.calibrate(_deploy_images(cuda, 12) // 2 + 128)
    assert engine._accuracy_graphs == {}
    out, out_avg = tta(images), avg(images)
    assert len(engine._accuracy_graphs) == 2
    with torch.inference_mode():
        assert _same_humans(out, tta_eager(images))
        assert _same_humans(out_avg, avg_eager(images))


# ------------------------------------------------ the train step replayed ---

def _train_cfg(optimizer, remat=False):
    """A small bf16 MobileNet-thin (64x80, 2 stages, batch 2), the lr
    halved every 3 steps, coupled L2."""
    import dataclasses

    from openpose_plus_tpu_torch import default_config

    cfg = default_config("mobilenet_thin")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hin=64, win=80, n_stages=2,
                                  remat_stages=remat),
        train=dataclasses.replace(cfg.train, batch_size=2,
                                  optimizer=optimizer, lr_init=1e-3,
                                  lr_decay_every=3, lr_decay_factor=0.5,
                                  weight_decay=5e-4))


def _train_batches(cfg, n):
    """n pipeline batches: three people an image, some parts hidden."""
    rng = np.random.default_rng(0)
    m = cfg.model
    out = []
    for _ in range(n):
        kp = np.zeros((2, 3, 18, 3), np.float32)
        kp[..., 0] = rng.uniform(3, m.win - 3, (2, 3, 18))
        kp[..., 1] = rng.uniform(3, m.hin - 3, (2, 3, 18))
        kp[..., 2] = rng.uniform(0, 1, (2, 3, 18)) < 0.8
        out.append({"images": rng.integers(0, 256, (2, m.hin, m.win, 3),
                                           dtype=np.uint8),
                    "keypoints": kp,
                    "mask": np.ones((2, m.hout, m.wout, 1), np.float32)})
    return out


def _train(cfg, batches, cuda, graphed=True, state=None):
    """The batches through make_train_step_on_batch (graphed) or the eager
    `_update` on a seeded state (or `state`); returns the state."""
    from openpose_plus_tpu_torch import train as T

    if state is None:
        state = T.create_train_state(cfg, seed=0, device=cuda)
    step = T.make_train_step_on_batch(cfg)
    targets = T.batch_on_device(cfg)
    for batch in batches:
        if graphed:
            state, _ = step(state, batch)
        else:
            T._update(state, *targets(state, batch))
    torch.cuda.synchronize()
    return state


def _params(state):
    return {n: p.detach().float().clone()
            for n, p in state.model.named_parameters()}


def _max_diff(a, b):
    return max(float((a[n] - b[n]).abs().max()) for n in a)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_train_step_graph_within_eager_spread(cuda, optimizer, remat):
    """7 steps across the lr boundaries at 3 and 6: CAPTURE_WARMUP eager
    steps, a capture, then one replay a step. The run makes 7 updates (the
    step, the schedule, Adam's counts), its lr metric is the schedule's,
    and its parameters lie within the spread of two eager runs measured
    first (cuDNN's backward is not bit-reproducible)."""
    from openpose_plus_tpu_torch import train as T

    cfg = _train_cfg(optimizer, remat)
    batches = _train_batches(cfg, 7)
    eager = [_params(_train(cfg, batches, cuda, graphed=False))
             for _ in range(2)]
    spread = _max_diff(*eager)
    state = T.create_train_state(cfg, seed=0, device=cuda)
    step = T.make_train_step_on_batch(cfg)
    lrs = []
    for batch in batches:
        state, metrics = step(state, batch)
        lrs.append(float(metrics["lr"]))
    torch.cuda.synchronize()
    assert state.step == 7 and state.scheduler.last_epoch == 7
    (captured,) = state.graphs.values()
    assert isinstance(captured, T._Captured)
    if optimizer == "adam":
        assert {int(st["step"]) for st in state.optimizer.state.values()} \
            == {7}
    schedule = T.lr_schedule(cfg.train)
    assert lrs == [float(np.float32(schedule(c))) for c in range(7)]
    assert np.isfinite(float(metrics["loss"]))
    diff = _max_diff(_params(state), eager[0])
    assert diff <= spread, (diff, spread)


def test_train_resume_through_the_graph(cuda, tmp_path):
    """4 graphed steps, a checkpoint, a restore into a fresh state and 3
    more (which warm up and capture again) against 7 graphed steps in one
    run: within the eager-against-eager spread."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T

    cfg = _train_cfg("adam")
    batches = _train_batches(cfg, 7)
    spread = _max_diff(*(_params(_train(cfg, batches, cuda, graphed=False))
                         for _ in range(2)))
    whole = _params(_train(cfg, batches, cuda))
    part = _train(cfg, batches[:4], cuda)
    ckpt.save(str(tmp_path / "ck"), part, part.step)
    fresh = ckpt.restore(str(tmp_path / "ck"), T.create_train_state(
        cfg, seed=5, device=cuda))
    assert fresh.step == 4 and fresh.graphs == {}
    assert all(g["lr"].device.type == "cuda" and g["capturable"]
               for g in fresh.optimizer.param_groups)
    resumed = _train(cfg, batches[4:], cuda, state=fresh)
    assert resumed.step == 7 and len(resumed.graphs) == 1
    diff = _max_diff(_params(resumed), whole)
    assert diff <= spread, (diff, spread)


# ------------------------------------------------ loaded artifacts replayed ---

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_artifact_replays_a_graph(cuda, dtype, tmp_path):
    """A reloaded artifact captures at its first call (CAPTURE_WARMUP + 1
    Python launches of each decoder kernel) and then replays one graph a
    call with none, each HumanBatch equal to the engine's; a held result
    survives the next call."""
    from openpose_plus_tpu_torch import export

    engine = _deploy_engine(cuda, dtype=dtype)
    a, b = _deploy_images(cuda, 13), _deploy_images(cuda, 14)
    engine.calibrate(a)
    export.save_engine(engine, str(tmp_path / "a"), batch_size=2)
    loaded = export.load_engine(str(tmp_path / "a"))
    before = greedy.launches
    first = loaded.infer(a)
    torch.cuda.synchronize()
    assert greedy.launches == before + CAPTURE_WARMUP + 1
    before = _python_launches()
    held, other = loaded.infer(a), loaded.infer(b)
    torch.cuda.synchronize()
    assert _python_launches() == before
    ref_a, ref_b = engine.infer(a), engine.infer(b)
    assert _same_humans(first, ref_a) and _same_humans(held, ref_a)
    assert _same_humans(other, ref_b)
    with pytest.raises(ValueError, match="artifact"):
        loaded.infer(a[:1])


# ------------------------------------------------------------- BODY_25 ---

def test_decode_at_25_parts_equals_the_cpu(cuda):
    """The whole decode of BODY_25 maps (noisy figures, both decoders) on
    the card against the CPU: the same people and parts; coordinates and
    scores within 1e-5 (the float64 smoothing contracts in another order
    on the card, which moves a refined coordinate by float32 ulps)."""
    import dataclasses

    from openpose_plus_tpu_torch.postproc import decode_maps

    people = [kernel_inputs.standing_person_25(11.37 + 15.61 * i,
                                               21.43 - 0.7 * i)
              for i in range(3)]
    conf, paf = (torch.from_numpy(np.stack([m, np.roll(m, 2, axis=1)]))
                 for m in kernel_inputs.make_maps(people, 46, 54, noise=0.05,
                                                  skel=BODY25))
    for cfg in _POSTPROC.values():
        ref = decode_maps(conf, paf, cfg)
        out = decode_maps(conf.to(cuda), paf.to(cuda), cfg)
        assert ref.coords.shape == (2, cfg.max_humans, 25, 2)
        assert int(ref.num_humans.sum()) >= 4
        for f in dataclasses.fields(ref):
            got, want = getattr(out, f.name).cpu(), getattr(ref, f.name)
            if want.dtype == torch.float32:
                assert torch.allclose(got, want, rtol=0, atol=1e-5), f.name
            else:
                assert torch.equal(got, want), f.name


def _body25_engine(cuda):
    import dataclasses

    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.engine import Engine

    cfg = default_config("body25")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=64, win=80))
    return Engine(cfg, seed=3, device=cuda)


def test_body25_compiled_replay_equals_eager(cuda):
    engine = _body25_engine(cuda)
    images = _deploy_images(cuda, 4)
    eager = engine.infer(images)
    engine.compile(2)
    out = engine.infer(images)
    torch.cuda.synchronize()
    assert engine._graphs[tuple(images.shape)] is not None
    assert out.coords.shape[2] == 25 and _same_humans(out, eager)


def test_body25_model_spans_time_a_captured_forward(cuda):
    """An eager forward counts 30 dense blocks and 108 conv epilogues, 3
    of them pooled; forwards captured while
    the tracer records: each replay times the front, the PAF stages and
    the heatmap stages of every forward, and they sum to no more than the
    replay."""
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    engine = _body25_engine(cuda)
    images = _deploy_images(cuda, 5)
    with GLOBAL_TRACER.recording() as rec:
        engine.forward(images)
    assert rec.counters == {"models.dense_blocks": 30, "ops.bias_act": 108,
                            "ops.bias_act_pool": 3}
    calls = 4
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        torch.cuda.synchronize()
        with GLOBAL_TRACER.recording() as rec, torch.cuda.graph(graph):
            for _ in range(calls):
                engine.forward(images)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
    stages = rec.device_ms()
    assert {k: len(v) for k, v in stages.items()} == dict.fromkeys(
        ("models.front", "models.paf_stages", "models.conf_stages"), calls)
    assert all(ms > 0 for v in stages.values() for ms in v)
    assert sum(sum(v) for v in stages.values()) <= start.elapsed_time(end)


# ---------------------------------------------- the conv epilogue, bias_act

_EPILOGUE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _epilogue_case(cuda, dtype, c, b=3, h=7, w=13, seed=0):
    """y (b, c, h, w) channels-last in `dtype`, bias and slope float32, on
    the card (`kernel_inputs.epilogue_inputs`); 3 x 7 x 13 = 273 pixels, a
    ragged count for a block of 256 threads."""
    y, bias, slope = kernel_inputs.epilogue_inputs(
        np.random.default_rng(seed + c), b, h, w, c)
    return (torch.from_numpy(y).to(cuda, dtype).permute(0, 3, 1, 2),
            torch.from_numpy(bias).to(cuda), torch.from_numpy(slope).to(cuda))


def _bits(t):
    """The tensor's bit patterns (signed zeros and NaN compared too)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


@pytest.mark.parametrize("c", [24, 57, 64, 96, 128, 512])
@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("dtype", list(_EPILOGUE_DTYPES))
def test_bias_act_kernel_equals_plain(cuda, dtype, act, c):
    """Signed zeros, NaN, infinities, sums that cancel to zero, slopes of
    both signs and zero, 8-channel groups and a ragged C (57: the
    element-wise path): the kernel's bits are the plain expressions' on
    the card, its values the CPU's."""
    y, bias, slope = _epilogue_case(cuda, _EPILOGUE_DTYPES[dtype], c)
    slope = slope if act == "prelu" else None
    before = bias_act.launches
    out = bias_act.bias_act(y, bias, slope)
    torch.cuda.synchronize()
    assert bias_act.launches == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(out), _bits(bias_act.bias_act_plain(y, bias,
                                                                  slope)))
    cpu = bias_act.bias_act_plain(y.cpu(), bias.cpu(),
                                  None if slope is None else slope.cpu())
    assert torch.equal(out.cpu().isnan(), cpu.isnan())
    assert torch.equal(out.cpu().nan_to_num(), cpu.nan_to_num())


@pytest.mark.parametrize("c,offset", [(96, 0), (96, 96), (96, 192),
                                      (128, 256), (24, 4), (57, 57)])
@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_bias_act_kernel_stores_into_a_wider_buffer(cuda, c, offset, act):
    """The second store at channels [offset, offset + C) of a 3C-wide
    channels-last buffer (a dense block's), beside the kernel's own
    output, leaves the rest of the buffer as it was; an offset or C off
    the 8-channel grid takes the element-wise path."""
    y, bias, slope = _epilogue_case(cuda, torch.bfloat16, c, seed=1)
    slope = slope if act == "prelu" else None
    into = torch.full((y.shape[0], 3 * c, *y.shape[2:]), 7.0,
                      dtype=y.dtype, device=cuda).contiguous(
                          memory_format=torch.channels_last)
    want = into.clone()
    ref = bias_act.bias_act_plain(y, bias, slope, want, offset)
    out = bias_act.bias_act(y, bias, slope, into, offset)
    torch.cuda.synchronize()
    assert torch.equal(_bits(into), _bits(want))
    assert torch.equal(_bits(out), _bits(ref))


def test_bias_act_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, bias, slope = _epilogue_case(cuda, torch.bfloat16, 64)
    into = torch.zeros((y.shape[0], 128, *y.shape[2:]), dtype=y.dtype,
                       device=cuda).contiguous(
                           memory_format=torch.channels_last)
    refused = [((y.half(), bias, slope), "bf16 or float32"),
               ((y, bias.bfloat16(), slope), "float32 bias"),
               ((y, bias[:32], slope), "float32 bias"),
               ((y, bias, slope.double()), "float32 slope"),
               ((y.contiguous(), bias, slope), "channels-last y"),
               ((y, bias.cpu(), slope), "one device"),
               ((y, bias, slope, into.cpu()), "one device"),
               ((y, bias, slope, into.float()), "buffer"),
               ((y, bias, slope, into.contiguous()), "buffer"),
               ((y, bias, slope, into, 65), "buffer")]
    before = bias_act.launches
    for args, match in refused:
        with pytest.raises(ValueError, match=match):
            bias_act.bias_act(*args)
    out = bias_act.bias_act(y[:0], bias, slope)     # an empty batch
    torch.cuda.synchronize()
    assert bias_act.launches == before and tuple(out.shape) == (
        0, *y.shape[1:])


@pytest.mark.parametrize("name,calls", [("body25", 108), ("vgg19", 80)])
def test_bias_act_forward_equals_the_plain_op(cuda, monkeypatch, name,
                                              calls):
    """A bf16 forward at batch 2 launches the kernel once a conv epilogue;
    with the op swapped for its plain version (the dense blocks still
    written in place) it launches none and gives the same maps bit for
    bit."""
    import dataclasses

    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.engine import Engine

    cfg = default_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=96, win=160))
    engine = Engine(cfg, seed=5, device=cuda)
    assert cfg.model.compute_dtype == "bfloat16"
    images = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 96, 160, 3), dtype=np.uint8)).to(cuda)
    before = bias_act.launches
    maps = engine.forward(images)
    torch.cuda.synchronize()
    assert bias_act.launches == before + calls
    monkeypatch.setattr(
        bias_act, "_bias_act_op",
        bias_act.bias_act_plain)
    plain = engine.forward(images)
    torch.cuda.synchronize()
    assert bias_act.launches == before + calls
    for a, b in zip(maps, plain, strict=True):
        assert bool(a.isfinite().all()) and torch.equal(a, b)


def _unpooled_route(op):
    """The op as the models ran it before the epilogue pooled: the kernel
    unpooled, then PyTorch's pool."""
    import torch.nn.functional as F

    def route(y, bias, slope, into, offset, pool=False):
        out = op(y, bias, slope, into, offset)
        return F.max_pool2d(out, 2, 2) if pool else out

    return route


# the VGG front's three pooled epilogues at batch 2, an odd H and W, a
# ragged C
_POOLED = {"conv1_2": (2, 64, 368, 656), "conv2_2": (2, 128, 184, 328),
           "conv3_4": (2, 256, 92, 164), "odd": (3, 24, 7, 13),
           "ragged": (2, 57, 10, 9)}


@pytest.mark.parametrize("shape", list(_POOLED))
@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("dtype", list(_EPILOGUE_DTYPES))
def test_bias_act_pooled_kernel_equals_plain_then_pool(cuda, dtype, act,
                                                       shape):
    """Pooled, one launch gives `F.max_pool2d` of the plain expressions
    bit for bit on the card (signed zeros, NaN and infinities among the
    inputs, so the same NaN and the same zero win), (B, C, H // 2, W // 2)
    channels-last, at the front's shapes, an odd H and W (the last row and
    column dropped) and a ragged C (the element-wise path)."""
    import torch.nn.functional as F

    b, c, h, w = _POOLED[shape]
    y, bias, slope = _epilogue_case(cuda, _EPILOGUE_DTYPES[dtype], c, b, h,
                                    w, seed=2)
    slope = slope if act == "prelu" else None
    before = bias_act.launches
    out = bias_act.bias_act(y, bias, slope, pool=True)
    torch.cuda.synchronize()
    assert bias_act.launches == before + 1
    assert tuple(out.shape) == (b, c, h // 2, w // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    ref = F.max_pool2d(bias_act.bias_act_plain(y, bias, slope), 2, 2)
    assert bool(ref.isnan().any()) and bool(ref.isinf().any())
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("dtype", list(_EPILOGUE_DTYPES))
def test_bias_act_pooled_kernel_on_unaligned_y_and_special_windows(cuda,
                                                                   dtype):
    """y one element into its storage (the element-wise path), and
    windows of NaN, infinities and signed zeros in every position: the
    pooled kernel's bits are PyTorch's pool's of the plain expressions."""
    import itertools

    import torch.nn.functional as F

    dt = _EPILOGUE_DTYPES[dtype]
    b, c, h, w = 2, 64, 6, 10
    y, bias, slope = _epilogue_case(cuda, dt, c, b, h, w, seed=3)
    store = torch.empty(y.numel() + 1, dtype=dt, device=cuda)
    moved = store[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    moved.copy_(y)
    assert moved.data_ptr() % 16 and moved.is_contiguous(
        memory_format=torch.channels_last)
    for s in (None, slope):
        out = bias_act.bias_act(moved, bias, s, pool=True)
        ref = F.max_pool2d(bias_act.bias_act_plain(y, bias, s), 2, 2)
        assert torch.equal(_bits(out), _bits(ref))
    special = (float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1.0,
               -1.0)
    windows = torch.tensor(list(itertools.product(special, repeat=4)))
    for n in (2400, 2401):      # of the 7 ** 4 windows: 16-byte, ragged
        y = windows[:n].reshape(1, n, 2, 2).to(cuda, dt).contiguous(
            memory_format=torch.channels_last)
        bias = torch.full((n,), -0.0, device=cuda)    # x + -0 is x
        for s in (None, torch.ones(n, device=cuda)):
            out = bias_act.bias_act(y, bias, s, pool=True)
            ref = F.max_pool2d(bias_act.bias_act_plain(y, bias, s), 2, 2)
            assert torch.equal(_bits(out), _bits(ref))
    torch.cuda.synchronize()


def test_bias_act_pooled_kernel_captures_in_a_graph(cuda):
    """A pooled call allocates nothing and never synchronises: captured
    in a CUDA graph (one launch), its replay on new inputs equals the
    eager call."""
    y, bias, slope = _epilogue_case(cuda, torch.bfloat16, 64, 2, 20, 30)
    static = y.clone()
    out = bias_act.bias_act(static, bias, slope, pool=True)   # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = bias_act.launches
    with torch.cuda.graph(graph):
        out = bias_act.bias_act(static, bias, slope, pool=True)
    assert bias_act.launches == before + 1
    y2, _, _ = _epilogue_case(cuda, torch.bfloat16, 64, 2, 20, 30, seed=9)
    static.copy_(y2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(bias_act.bias_act(y2, bias, slope,
                                                           pool=True)))


@pytest.mark.parametrize("name,calls", [("body25", 108), ("vgg19", 80)])
def test_pooled_forward_equals_the_unpooled_route(cuda, monkeypatch, name,
                                                  calls):
    """A bf16 forward at the cells' 368x656 and batch 8 pools in three of
    its epilogues; its maps equal bit for bit those of the same forward
    with every epilogue unpooled and PyTorch's pool after it."""
    import dataclasses

    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.engine import Engine
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    cfg = default_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=368,
                                                win=656))
    engine = Engine(cfg, seed=7, device=cuda)
    images = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (8, 368, 656, 3), dtype=np.uint8)).to(cuda)
    with GLOBAL_TRACER.recording() as rec:
        maps = engine.forward(images)
    torch.cuda.synchronize()
    assert rec.counters["ops.bias_act"] == calls
    assert rec.counters["ops.bias_act_pool"] == 3
    monkeypatch.setattr(bias_act, "_bias_act_op",
                        _unpooled_route(bias_act._bias_act_op))
    before = bias_act.launches
    unpooled = engine.forward(images)
    torch.cuda.synchronize()
    assert bias_act.launches == before + calls
    for a, b in zip(maps, unpooled, strict=True):
        assert bool(a.isfinite().all()) and torch.equal(a, b)
