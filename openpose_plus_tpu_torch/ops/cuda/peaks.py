"""Heatmap peaks (3x3 NMS, per-part top K, subpixel refinement): CUDA
kernels beside the plain PyTorch version.

Replaces no Pallas kernel: the JAX package's NMS and top K are plain lax
code (`openpose_plus_tpu/postproc/nms.py` find_peaks). Kernel source
`openpose_plus_tpu_torch/csrc/peaks.cu`; the plain version is
`postproc.nms.find_peaks_plain` (max-pools, masks and a full stable sort of
every row). On the H100 the stage is bound by reading the smoothed part
maps once; the kernels read them once (one 32 x 8 tile of all 18 parts a
block, with a 2-pixel halo; BODY_25's 25 parts in two blocks of 13, so a
block's tile fits in static shared memory), append each row's peaks as
unique 64-bit keys (score bits above, complemented flat index below), then
select the top K of each row exactly (a radix select where a row holds
more than K) and refine them: the plain version's PeakSet, bit for bit,
and no sort.

`find_peaks` calls the op `openpose_plus_tpu_torch::find_peaks`
(torch.library), which dispatches on the device of `smoothed`: a CPU tensor
takes the plain version, a CUDA tensor launches the kernels or raises. The
maps are read through their strides, so the decode's einsum layout needs no
copy. Each launch adds one to the module-level `launches` count and to the
tracer's `postproc.peaks_kernel` counter, and leaves `candidates`, the
(B, n_parts) int32 device tensor of peaks each row held (for tests and
chip_smoke.py; the served path never reads it).
"""

from __future__ import annotations

import ctypes

import torch

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.ops import NAMESPACE, check_device
from openpose_plus_tpu_torch.utils.tracer import count

MAX_PIXELS = 1 << 24   # the plain version's float32 flat index is exact
# the op's outputs, in order: the fields of `postproc.nms.PeakSet`
FIELDS = ("y", "x", "score", "valid", "refined_y", "refined_x")

launches = 0   # kernel launches in this process (see module docstring)
candidates: torch.Tensor | None = None   # peaks a row, of the last launch


def capacity(h: int, w: int) -> int:
    """Most peaks a row of an (h, w) map can hold: no two are 8-adjacent,
    so each 2 x 2 cell of the plane holds at most one."""
    return ((h + 1) // 2) * ((w + 1) // 2)


@torch.library.custom_op(
    f"{NAMESPACE}::find_peaks", mutates_args=(), device_types="cpu",
    schema="(Tensor smoothed, float threshold, int max_peaks) -> (Tensor, "
           "Tensor, Tensor, Tensor, Tensor, Tensor)")
def _find_peaks_op(smoothed: torch.Tensor, threshold: float, max_peaks: int
                   ) -> tuple[torch.Tensor, ...]:
    from openpose_plus_tpu_torch.postproc import nms   # nms imports this

    # contiguous, as the kernels write them (the sort leaves some transposed)
    p = nms.find_peaks_plain(smoothed, threshold, max_peaks)
    return tuple(getattr(p, f).contiguous() for f in FIELDS)


@_find_peaks_op.register_fake
def _(smoothed, threshold, max_peaks):
    n = skeletons.find(n_heatmaps=smoothed.shape[-1]).n_parts
    shape = (smoothed.shape[0], n, max_peaks)
    y = smoothed.new_empty(shape, dtype=torch.int32)
    refined = smoothed.new_empty(shape, dtype=torch.promote_types(
        torch.float32, smoothed.dtype))
    return (y, torch.empty_like(y), smoothed.new_empty(shape),
            smoothed.new_empty(shape, dtype=torch.bool), refined,
            torch.empty_like(refined))


@_find_peaks_op.register_kernel("cuda")
def _find_peaks_cuda(smoothed: torch.Tensor, threshold: float,
                     max_peaks: int) -> tuple[torch.Tensor, ...]:
    if smoothed.dim() != 4:
        raise ValueError(f"find_peaks: smoothed {tuple(smoothed.shape)} is "
                         "not (B, H, W, C)")
    n = skeletons.find(n_heatmaps=smoothed.shape[3]).n_parts
    if smoothed.dtype != torch.float32:
        raise ValueError("find_peaks kernel takes float32 maps")
    b, h, w = smoothed.shape[:3]
    if h < 1 or w < 1 or h * w > MAX_PIXELS or max_peaks < 0:
        raise ValueError(f"find_peaks kernel: a {h}x{w} map (1 to "
                         f"{MAX_PIXELS} pixels) and max_peaks {max_peaks} "
                         ">= 0")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches, candidates
    dev = smoothed.device
    shape = (b, n, max_peaks)
    y = torch.empty(shape, dtype=torch.int32, device=dev)
    x = torch.empty_like(y)
    score = torch.empty(shape, dtype=torch.float32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    ry = torch.empty_like(score)
    rx = torch.empty_like(score)
    if y.numel() == 0:
        return y, x, score, valid, ry, rx
    cap = capacity(h, w)
    keys = torch.empty(b * n * cap, dtype=torch.int64, device=dev)
    rows = torch.empty((b, n), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.find_peaks_launch(
        smoothed.data_ptr(), *smoothed.stride(), b, h, w, n,
        ctypes.c_float(threshold), max_peaks, keys.data_ptr(), cap,
        rows.data_ptr(), y.data_ptr(), x.data_ptr(), score.data_ptr(),
        valid.data_ptr(), ry.data_ptr(), rx.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "find_peaks_launch")
    launches += 1
    count("postproc.peaks_kernel")
    candidates = rows
    return y, x, score, valid, ry, rx


def find_peaks(smoothed: torch.Tensor, threshold: float, max_peaks: int
               ) -> tuple[torch.Tensor, ...]:
    """Dispatching wrapper (the op): y, x, score, valid, refined_y,
    refined_x, each (B, P, max_peaks), P the parts of the skeleton of the
    maps' channels (`skeletons.find`: 19 COCO's 18, 26 BODY_25's 25), as
    `postproc.nms.find_peaks_plain` computes them. On the card the maps
    are float32, of 1 to 2**24 pixels an image, at any strides."""
    check_device("find_peaks", smoothed)
    return _find_peaks_op(smoothed, threshold, max_peaks)
