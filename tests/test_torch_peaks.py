"""The peaks op (`ops.cuda.peaks`) on the CPU: its dispatch is the plain
version, and the capacity its kernels are sized by holds.

`openpose_plus_tpu_torch::find_peaks` takes `postproc.nms.find_peaks_plain`
for a CPU tensor; `nms.find_peaks` wraps the op's six outputs in a
PeakSet. The kernels give each (image, part) row room for
ceil(H/2) * ceil(W/2) peaks: two 8-adjacent pixels are never both peaks
(they would be equal candidates, and the tie-break keeps the lower flat
index), and a checkerboard reaches the bound. The kernels themselves are
tested on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import kernel_inputs
from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.ops.cuda import peaks
from openpose_plus_tpu_torch.postproc import nms

torch.set_num_threads(2)

POSTPROC = {"default": PostprocConfig(), "fidelity": PostprocConfig().fidelity()}


def _smoothed(kind, cfg, b=2):
    return nms.upsample_smooth(torch.from_numpy(kernel_inputs.peak_scene(
        kind, b)), cfg.upsample_factor, cfg.smooth_sigma)


def _fields(p):
    return [getattr(p, f.name) for f in dataclasses.fields(p)]


@pytest.mark.parametrize("post", ["default", "fidelity"])
@pytest.mark.parametrize("kind", ["plateau", "clean", "noisy", "very_noisy",
                                  "pure_noise"])
def test_cpu_dispatch_is_the_plain_version(kind, post):
    """The wrapper, the registered op and `nms.find_peaks` all return the
    plain version's fields on the decode's einsum layout, bit for bit."""
    cfg = POSTPROC[post]
    smoothed = _smoothed(kind, cfg)
    ref = nms.find_peaks_plain(smoothed, cfg.peak_threshold, cfg.max_peaks)
    assert peaks.FIELDS == tuple(f.name for f in dataclasses.fields(ref))
    before = peaks.launches
    for out in (peaks.find_peaks(smoothed, cfg.peak_threshold,
                                 cfg.max_peaks),
                torch.ops.openpose_plus_tpu_torch.find_peaks(
                    smoothed, cfg.peak_threshold, cfg.max_peaks),
                _fields(nms.find_peaks(smoothed, cfg.peak_threshold,
                                       cfg.max_peaks))):
        for o, r in zip(out, _fields(ref), strict=True):
            assert o.dtype == r.dtype and torch.equal(o, r)
    assert peaks.launches == before       # the CPU launches no kernel


@pytest.mark.parametrize("shape,k", [((0, 8, 8), 16), ((1, 8, 8), 0),
                                     ((1, 3, 5), 32), ((1, 1, 1), 3)])
def test_cpu_dispatch_at_the_edges(shape, k):
    """An empty batch, K = 0, and K above H * W: the plain version's
    shapes and values."""
    maps = torch.rand(*shape, 19, generator=torch.Generator().manual_seed(0))
    out = peaks.find_peaks(maps, 0.05, k)
    ref = nms.find_peaks_plain(maps, 0.05, k)
    for o, r in zip(out, _fields(ref), strict=True):
        assert tuple(o.shape) == (shape[0], 18, k) and torch.equal(o, r)


def test_fake_outputs_match_the_plain_version():
    """The op's fake implementation (what torch.export traces) gives the
    plain version's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    maps = _smoothed("noisy", POSTPROC["default"])
    ref = peaks.find_peaks(maps, 0.05, 16)
    with FakeTensorMode() as mode:
        fake = peaks.find_peaks(mode.from_tensor(maps), 0.05, 16)
    assert [(tuple(t.shape), t.dtype) for t in fake] == [
        (tuple(t.shape), t.dtype) for t in ref]


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (5, 7), (6, 8), (37, 43),
                                 (92, 108)])
def test_checkerboard_reaches_the_capacity(h, w):
    """Every row of a checkerboard holds exactly ceil(H/2) * ceil(W/2)
    peaks, the room the kernels give a row, and they come out in ascending
    flat index (one score, ties to the lowest index)."""
    cap = peaks.capacity(h, w)
    assert cap == -(-h // 2) * -(-w // 2)
    maps = torch.from_numpy(kernel_inputs.checkerboard_peaks(2, h, w))
    p = nms.find_peaks_plain(maps, 0.5, cap + 3)
    assert torch.equal(p.valid.sum(-1), torch.full((2, 18), cap))
    flat = (p.y * w + p.x)[..., :cap]
    assert bool((flat[..., 1:] > flat[..., :-1]).all())
    assert bool((p.y[..., :cap] % 2 == 0).all())
    assert bool((p.x[..., :cap] % 2 == 0).all())


def test_no_two_peaks_are_adjacent():
    """On maps quantized to quarter steps (plateaus everywhere), no peak
    has another among its 8 neighbours: the bound's premise."""
    rng = np.random.default_rng(3)
    maps = torch.from_numpy(
        np.round(rng.uniform(0, 3, (2, 40, 50, 19))).astype(np.float32) / 4)
    p = nms.find_peaks_plain(maps, 0.1, 40 * 50)
    for b in range(2):
        for part in range(18):
            v = p.valid[b, part]
            ys, xs = p.y[b, part][v], p.x[b, part][v]
            dy = (ys[:, None] - ys[None]).abs()
            dx = (xs[:, None] - xs[None]).abs()
            near = (dy <= 1) & (dx <= 1)
            assert int(near.sum()) == int(v.sum())   # each only with itself
