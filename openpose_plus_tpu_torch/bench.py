"""The port's benchmark harness: the JAX package's `bench.py` and its three
scripts (`scripts/bench_one.py`, `bench_train.py`, `bench_stream.py`) as the
modes of one module, timed on one CUDA card.

    python -m openpose_plus_tpu_torch bench                  # the table
    python -m openpose_plus_tpu_torch.bench table
    python -m openpose_plus_tpu_torch.bench one --model vggtiny --dtype int8
    python -m openpose_plus_tpu_torch.bench train [--model vgg19] [--remat]
    python -m openpose_plus_tpu_torch.bench stream [--src-h 3000 --src-w 4000]
                                                   [--loader-only]

Every mode runs on the card (`--device cuda`, the default) and raises
without one, naming the flag; `--device cpu` runs it on the CPU.

Methodology (the reference's, on a CUDA card):
  * The input is device-resident and seeded (`np.random.default_rng(0)`),
    in the engine's input layout of record (`ModelConfig.input_shape`); the
    result stays on the card.
  * The timed unit is the engine's own `infer_step` (chunk and all)
    chained through a device scalar: each iteration's input is `where(
    isfinite(carry), images, 0)` and the carry becomes the sum of its
    skeleton scores, so the card runs the iterations in order. PyTorch has
    no device loop, so one iteration is captured in a CUDA graph over a
    static input and a static carry (`ChainedStep`), and a pass of n
    iterations is n replays back to back, ended by one synchronise (the
    carry's `.item()`).
  * The figure is the two-point slope (t(n_large) - t(n_small)) /
    (n_large - n_small) of `fori_slope_seconds`, which cancels the fixed
    cost of a pass (here the launch of the first replay and the last
    synchronise), the median of its valid samples.
  * FLOPs and bytes of one served call come from shapes (`program_cost`),
    counted on one eager call, and are held against the H100's published
    peaks (`utilization_row`).

`vs_baseline` compares the headline with the port's own first H100 run,
`openpose_plus_tpu_torch/bench_baseline.json`; the JAX package's
`bench_baseline.json` is a TPU figure and is never read here.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# H100 SXM5 per-card peaks (NVIDIA H100 data sheet), the denominators of
# the MFU and roofline columns: dense bf16 tensor-core peak, HBM3 rate
PEAK_TFLOPS_BF16 = 989.0
PEAK_HBM_GBPS = 3350.0
HEADLINE = "e2e_fps_per_chip_368x656_bs8"
# bench.py's rows: (name, model, hin, win, batch, compute dtype, chunk);
# the first is the headline
ROWS = (
    (HEADLINE, "mobilenet_thin", 368, 656, 8, "bfloat16", 0),
    ("e2e_fps_single_368x432", "mobilenet_thin", 368, 432, 1, "bfloat16", 0),
    ("e2e_fps_vgg19_single_368x656", "vgg19", 368, 656, 1, "bfloat16", 0),
    ("e2e_fps_vgg19_368x656_bs8", "vgg19", 368, 656, 8, "bfloat16", 0),
    ("e2e_fps_per_chip_368x656_bs32", "mobilenet_thin", 368, 656, 32,
     "bfloat16", 0),
    ("e2e_fps_per_chip_368x656_bs32_chunk8", "mobilenet_thin", 368, 656, 32,
     "bfloat16", 8),
    ("e2e_fps_vgg19_int8_368x656_bs8", "vgg19", 368, 656, 8, "int8", 0),
    ("e2e_fps_vggtiny_368x656_bs8", "vggtiny", 368, 656, 8, "bfloat16", 0),
    ("e2e_fps_hao28_368x656_bs8", "hao28", 368, 656, 8, "bfloat16", 0),
    ("e2e_fps_vggtiny_int8_368x656_bs8", "vggtiny", 368, 656, 8, "int8", 0),
    ("e2e_fps_hao28_int8_368x656_bs8", "hao28", 368, 656, 8, "int8", 0),
    ("e2e_fps_mobilenet_int8_368x656_bs8", "mobilenet_thin", 368, 656, 8,
     "int8", 0),
)
HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PATH = os.path.join(HERE, "bench_baseline.json")
# the stream mode's seeded photo sets, content-addressed (git-ignored)
PHOTO_ROOT = os.path.join(os.path.dirname(HERE), ".bench_photos_torch")
STREAM_DRAIN = 12             # batches read before the stream is timed


def check_device(device: str | torch.device) -> torch.device:
    """The bench's device; a CUDA device without a card raises (nothing
    falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bench: --device {device}, but no CUDA device "
                           "is available; pass --device cpu to run on the "
                           "CPU")
    return dev


# --------------------------------------------------------------- cost ---

def _cost_formulas() -> dict:
    """FlopCounterMode formulas (raw arguments) for the port's ops that do
    arithmetic. `fused_sepconv`: its depthwise and pointwise products.
    `int8_conv`: 2 * output elements * kernel^2 * Cin, where Cin is the
    layer's own input channels: a quantize pass pads them with zeros to the
    multiple of 64 the kernel reads, so its formula notes the channels of
    its input against its output (kept alive for the count, so no later
    tensor takes its storage) and counts no flops itself."""
    # importing the modules registers the ops
    from openpose_plus_tpu_torch.ops.cuda import (  # noqa: F401
        int8_conv, sepconv)

    real_channels: dict[int, int] = {}
    keep: list = []

    def quantize_flops(x, scale, out_val=None):
        keep.append(out_val)
        real_channels[out_val.untyped_storage().data_ptr()] = x.shape[-1]
        return 0

    def int8_conv_flops(q, w_packed, kernel, rescale, bias, stride, pads,
                        s_out, out_val=None):
        cin = real_channels.get(q.untyped_storage().data_ptr(), q.shape[-1])
        return 2 * out_val.numel() * kernel * kernel * cin

    def sepconv_flops(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                      out_val=None):
        px_c = x.numel()                     # B * H * W * C
        return 2 * px_c * 9 + 2 * px_c * pw_kernel.shape[-1]

    ops = torch.ops.openpose_plus_tpu_torch
    formulas = {ops.quantize_act: quantize_flops,
                ops.int8_conv: int8_conv_flops,
                ops.fused_sepconv: sepconv_flops}
    for fn in formulas.values():
        fn._get_raw = True
    return formulas


class _ByteCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums the bytes of every input and output tensor of every op that
    moves data (views and allocations move none)."""

    def __init__(self) -> None:
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.__name__.startswith("empty")):
            leaves = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.nbytes += sum(t.numel() * t.element_size() for t in leaves
                               if isinstance(t, torch.Tensor))
        return out


def program_cost(engine, images: torch.Tensor) -> tuple[float, float]:
    """(flops, bytes) of ONE served call, `infer_step` of `engine` on
    `images`, counted from shapes on one eager call (on a warmed engine:
    a first call also quantizes an int8 engine's weights).

    FLOPs: `torch.utils.flop_counter.FlopCounterMode` (convolutions and
    contractions: the CNN and the decoder's, 2 per multiply-add), with
    formulas for the port's ops (`_cost_formulas`). XLA's `cost_analysis`,
    which the reference reads, also counts elementwise ops and leaves out
    the taps of a SAME conv that fall on the padding; this count takes
    every tap and no elementwise op. Every chunk of a chunked call is
    counted (XLA counted a `lax.map` body once, the reference's
    `cost_note`; no such note here).

    Bytes: every op's input and output bytes over the call, the eager
    counterpart of XLA's "bytes accessed" at fusion boundaries: an UPPER
    BOUND on DRAM traffic (a tensor that stays in the 50 MB L2 between two
    ops is counted twice), so `hbm_pct_est` can exceed 100."""
    from openpose_plus_tpu_torch.engine import infer_step
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping=_cost_formulas())
    nbytes = _ByteCount()
    with torch.inference_mode(), counter, nbytes:
        infer_step(engine.model, images, engine.config.postproc,
                   engine.chunk)
    return float(counter.get_total_flops()), float(nbytes.nbytes)


def utilization_row(flops: float, nbytes: float, dt: float) -> dict:
    """Achieved TFLOP/s and its share of the bf16 peak (MFU), and the
    estimated HBM GB/s and its share of the HBM rate, for one program
    execution taking dt seconds. An int8 row is held against the bf16 peak
    too (the H100's dense int8 peak is twice it, so its true utilization is
    half the printed figure; the column is for comparing rows)."""
    tflops = flops / dt / 1e12
    gbps = nbytes / dt / 1e9
    return {
        "flops_per_exec": flops,
        "achieved_tflops": round(tflops, 2),
        "mfu_pct": round(100.0 * tflops / PEAK_TFLOPS_BF16, 1),
        "hbm_gbps_est": round(gbps, 1),
        "hbm_pct_est": round(100.0 * gbps / PEAK_HBM_GBPS, 1),
    }


# ------------------------------------------------------------- timing ---

def fori_slope_seconds(loop_fn, carry0, repeats: int = 3,
                       target_seconds: float = 0.4,
                       samples: list | None = None) -> float:
    """Seconds per iteration of a chained device loop (`bench.py::
    fori_slope_seconds`, the same algorithm).

    `loop_fn(n, carry) -> carry` runs n chained iterations of the measured
    step (`ChainedStep.run`: n CUDA-graph replays); each pass ends in one
    synchronise, the carry read back to the host. Per-iteration time is
    the two-point slope between a short and a long pass, (t(n_large) -
    t(n_small)) / (n_large - n_small): both pay the same fixed cost, so
    the slope cancels it. Warm-up passes of 5 and 20 iterations, the
    second sizing the long pass to `target_seconds` within [40, 1000]
    iterations, the short one an eighth of it (at least 5). Slope noise is
    two-sided (a stall on the short pass makes a slope too small or
    negative): non-positive samples are discarded, never clamped, with up
    to 3 * repeats pairs of passes, and the figure is the median of the
    valid samples; RuntimeError when there is none."""

    def run(n, carry):
        t0 = time.perf_counter()
        carry = loop_fn(n, carry)
        float(carry)                        # the synchronise
        return time.perf_counter() - t0, carry

    _, carry = run(5, carry0)           # capture is done; warm-up
    t_est, carry = run(20, carry)       # sizes the timed passes
    est = t_est / 20
    n_large = int(min(1000, max(40, round(target_seconds / est))))
    n_small = max(5, n_large // 8)
    slopes = []
    for _ in range(3 * repeats):        # bounded retries for bad windows
        t_small, carry = run(n_small, carry)
        t_large, carry = run(n_large, carry)
        dt = (t_large - t_small) / (n_large - n_small)
        if dt > 0:
            slopes.append(dt)
            if len(slopes) >= repeats:
                break
    if not slopes:
        raise RuntimeError(
            "fori_slope_seconds: no positive slope sample in "
            f"{3 * repeats} passes — rig too degraded to measure")
    if samples is not None:
        samples.extend(slopes)          # run-to-run spread for the record
    return float(np.median(slopes))


class ChainedStep:
    """The served step of `engine` on `images` (device-resident, copied
    once into a static buffer), chained through a 0-d float32 carry:

        images' = where(isfinite(carry), images, 0)
        result  = infer_step(model, images', postproc, chunk)
        carry   = sum(result.score)

    The scores are finite, so every iteration serves `images`, but the
    card cannot start one before the last has written the carry. On a CUDA
    engine `step` is captured in a CUDA graph as `Engine.compile` captures
    (`graphs.capture_graph`: its warm-up calls fill the lazy caches, an
    int8 engine's packed weights among them, so an int8 engine must be
    calibrated first); `run(n)` replays it n times, and `out` is the
    graph's own HumanBatch, overwritten by each replay. On the CPU `run`
    calls `step` eagerly."""

    def __init__(self, engine, images: torch.Tensor):
        self.engine = engine
        with torch.inference_mode():
            self.images = images.to(engine.device).clone()
            self.carry = torch.zeros((), dtype=torch.float32,
                                     device=engine.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        if engine.device.type == "cuda":
            self._capture()

    @torch.inference_mode()
    def step(self):
        from openpose_plus_tpu_torch.engine import infer_step

        images = torch.where(torch.isfinite(self.carry), self.images,
                             torch.zeros_like(self.images))
        out = infer_step(self.engine.model, images,
                         self.engine.config.postproc, self.engine.chunk)
        self.carry.copy_(out.score.sum())
        return out

    @torch.inference_mode()
    def _capture(self) -> None:
        from openpose_plus_tpu_torch.graphs import capture_graph

        self.graph, self.out = capture_graph(self.step, self.engine.device)

    def run(self, n: int, carry=None) -> torch.Tensor:
        """n chained iterations, enqueued without a synchronise; returns
        the carry (the `loop_fn` of `fori_slope_seconds`, whose carry
        argument is the chain's own buffer)."""
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.out = self.step()
        return self.carry


def _engine(model: str, hin: int, win: int, dtype: str, chunk: int,
            device: torch.device, frag_merge: bool = False):
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.engine import Engine

    cfg = default_config(model)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=hin, win=win, compute_dtype=dtype))
    if frag_merge:
        cfg = cfg.replace(postproc=dataclasses.replace(
            cfg.postproc, fragment_merge_rel=0.5))
    return Engine(cfg, fast_init=True, chunk=chunk, device=device)


@dataclasses.dataclass
class Measured:
    """One benched configuration: its row; the slope, seconds per batch;
    the slope's valid samples; the timed chain (its engine and images)."""
    row: dict
    seconds: float
    samples: list
    chain: ChainedStep


def bench_engine(model: str, hin: int, win: int, batch: int,
                 dtype: str = "bfloat16", chunk: int = 0, *,
                 device: str | torch.device = "cuda",
                 rng: Optional[np.random.Generator] = None,
                 frag_merge: bool = False, repeats: int = 3) -> Measured:
    """One engine configuration by the device-loop slope. The row: fps,
    batch, the slope samples' spread, and the `utilization_row` of one
    served call with its FLOPs per image (or `cost_analysis_error` when
    the count failed)."""
    dev = check_device(device)
    rng = rng if rng is not None else np.random.default_rng(0)
    eng = _engine(model, hin, win, dtype, chunk, dev, frag_merge)
    shape = eng.config.model.input_shape(batch)
    images = torch.from_numpy(rng.integers(
        0, 255, shape, dtype=np.uint8)).to(dev)
    eng.calibrate(images)               # no-op for float modes
    chain = ChainedStep(eng, images)
    samples: list = []
    dt = fori_slope_seconds(chain.run, chain.carry, repeats=repeats,
                            samples=samples)
    row = {"fps": round(batch / dt, 2), "batch": batch,
           "spread_pct": round(
               100.0 * (max(samples) - min(samples)) / dt, 1)}
    try:
        flops, nbytes = program_cost(eng, chain.images)
        row.update(utilization_row(flops, nbytes, dt))
        row["flops_per_image"] = round(flops / batch)
    except Exception as e:   # count failed: keep the FPS row
        row["cost_analysis_error"] = str(e)[:200]
    return Measured(row, dt, samples, chain)


# --------------------------------------------------------------- modes ---

def table_rows(rows=None, device: str | torch.device = "cuda",
               repeats: int = 3):
    """`bench.py::main`, a row at a time: yields (name, Measured) for every
    row of `rows` (default `ROWS`, the first the headline) in order. The
    headline's line is printed as soon as it is measured;
    `BENCH_HEADLINE_ONLY` stops after it; the rows go to
    `BENCH_DETAILS_PATH` (default bench_details_torch.json in the temporary
    directory, never the tree) when the table ends. A caller drops each
    Measured before it asks for the next row, so that one row's graph and
    engine are alive at a time."""
    dev = check_device(device)
    rows = ROWS if rows is None else rows
    rng = np.random.default_rng(0)
    results: dict = {}

    def measure(name, *config):
        if dev.type == "cuda":
            torch.cuda.empty_cache()        # the last row's graph pool
        m = bench_engine(*config, device=dev, rng=rng, repeats=repeats)
        results[name] = m.row
        return m

    (head_name, *head_config), *rest = rows
    m = measure(head_name, *head_config)
    head = m.row
    value = head["fps"]
    base = value
    if os.path.exists(BASELINE_PATH):
        with open(BASELINE_PATH) as f:
            base = json.load(f)["value"]
    print(json.dumps({
        "metric": head_name,
        "value": value,
        "unit": "frames/s",
        "vs_baseline": round(value / base, 3),
        "mfu_pct": head.get("mfu_pct"),
        "hbm_pct_est": head.get("hbm_pct_est"),
        "spread_pct": head.get("spread_pct"),
    }), flush=True)
    yield head_name, m
    del m
    if os.environ.get("BENCH_HEADLINE_ONLY"):
        return
    try:
        for name, *config in rest:
            yield name, measure(name, *config)
    finally:
        details = os.environ.get(
            "BENCH_DETAILS_PATH",
            os.path.join(tempfile.gettempdir(), "bench_details_torch.json"))
        with open(details, "w") as f:
            json.dump(results, f, indent=2)


def table(rows=None, device: str | torch.device = "cuda",
          repeats: int = 3) -> dict:
    """The `table` mode (`table_rows` run to its end); returns {name:
    row}."""
    results = {}
    for name, m in table_rows(rows, device, repeats):
        results[name] = m.row
        del m
    return results


def one(model: str = "mobilenet_thin", hin: int = 368, win: int = 656,
        batch: int = 8, dtype: str = "bfloat16", chunk: int = 0,
        frag_merge: bool = False, device: str | torch.device = "cuda",
        repeats: int = 3) -> dict:
    """`scripts/bench_one.py`: one engine configuration, one line."""
    m = bench_engine(model, hin, win, batch, dtype, chunk, device=device,
                     frag_merge=frag_merge, repeats=repeats)
    row, dt = m.row, m.seconds
    out = {
        "metric": (f"e2e_fps_{model}_{dtype}_{hin}x{win}_bs{batch}"
                   + (f"_chunk{chunk}" if chunk else "")
                   + ("_fm" if frag_merge else "")),
        "value": row["fps"],
        "unit": "frames/s",
        "ms_per_batch": round(dt * 1e3, 3),
        "spread_pct": row["spread_pct"],
    }
    out.update({k: row[k] for k in ("flops_per_exec", "achieved_tflops",
                                     "mfu_pct", "hbm_gbps_est",
                                     "hbm_pct_est", "cost_analysis_error")
                if k in row})
    print(json.dumps(out), flush=True)
    return out


def train(model: str = "mobilenet_thin", batch: int = 8, hin: int = 368,
          win: int = 656, repeats: int = 3, remat: bool = False,
          device: str | torch.device = "cuda") -> dict:
    """`scripts/bench_train.py`: the full train step (`train.
    make_train_step_on_batch`: uint8 normalize, `make_targets` on the
    device, forward, loss, backward, update) by the same slope, each step's
    mask perturbed by the previous loss (+ loss * 1e-12) so the steps run in
    order. On the card the step is one CUDA-graph replay (after its warm-up
    steps and the capture), the program the JAX package's `bench_train`
    times: the figure is the device's, with the batch's copy into the
    graph's buffers."""
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.config import default_config

    dev = check_device(device)
    cfg = default_config(model)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=hin, win=win,
                                  remat_stages=remat),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    state = T.create_train_state(cfg, seed=0, device=dev)
    step = T.make_train_step_on_batch(cfg)
    rng = np.random.default_rng(0)
    max_people = 8
    # the model's preferred input layout, as the reference's pipeline ships
    img_shape = cfg.model.train_lowering().input_shape(batch)
    data = {
        "images": torch.from_numpy(rng.integers(
            0, 255, img_shape, dtype=np.uint8)).to(dev),
        "keypoints": torch.from_numpy(np.concatenate([
            rng.uniform(0, win, (batch, max_people, 18, 1)),
            rng.uniform(0, hin, (batch, max_people, 18, 1)),
            (rng.random((batch, max_people, 18, 1)) < 0.7),
        ], axis=-1).astype(np.float32)).to(dev),
        "mask": torch.ones((batch, hin // cfg.model.stride,
                            win // cfg.model.stride, 1), device=dev),
    }

    def loop_fn(n, c):
        for _ in range(n):
            b = dict(data)
            b["mask"] = data["mask"] + c * 1e-12
            _, metrics = step(state, b)
            c = metrics["loss"]
        return c

    best = fori_slope_seconds(loop_fn, torch.zeros((), device=dev),
                              repeats=repeats)
    name = (f"train_imgs_per_sec_{model}_{hin}x{win}_bs{batch}"
            + ("_remat" if remat else ""))
    out = {"metric": name, "value": round(batch / best, 2),
           "unit": "imgs/s", "ms_per_step": round(best * 1e3, 2)}
    print(json.dumps(out), flush=True)
    return out


def make_photo_set(src_h: int, src_w: int, n: int, quality: int = 90) -> str:
    """Seeded smooth-content JPEGs (a small random image, bilinear-resized
    to src_h x src_w, JPEG quality `quality`, written by cv2) in a
    content-addressed directory under `PHOTO_ROOT`; made once."""
    import cv2

    key = hashlib.sha1(
        f"{src_h}x{src_w}x{n}q{quality}cv2v1".encode()).hexdigest()[:10]
    out_dir = os.path.join(PHOTO_ROOT, f"photos_{key}")
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        small = rng.integers(0, 255, (max(src_h // 60, 8),
                                      max(src_w // 60, 8), 3), dtype=np.uint8)
        img = cv2.resize(small, (src_w, src_h), interpolation=cv2.INTER_LINEAR)
        if not cv2.imwrite(os.path.join(out_dir, f"p{i:03d}.jpg"), img,
                           [cv2.IMWRITE_JPEG_QUALITY, quality]):
            raise OSError(f"cannot write a photo under {out_dir}")
    open(marker, "w").close()
    return out_dir


def stream(model: str = "mobilenet_thin", src_h: int = 3000,
           src_w: int = 4000, n: int = 16, hin: int = 368, win: int = 656,
           batch: int = 8, workers: int = 4, repeat: int = 40,
           loader_only: bool = False,
           device: str | torch.device = "cuda") -> dict:
    """`scripts/bench_stream.py`: sustained frames/s of `StreamEstimator.
    run_files(loop=True)` on a compiled engine over the seeded photo set
    (or of the `StreamLoader` alone), after draining `STREAM_DRAIN` batches
    (the read-ahead made while the engine compiled is not counted); the
    host scopes' report of the run (`utils.tracer`, recorded over the whole
    run and kept as `GLOBAL_TRACER.last`) goes to stderr."""
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    dev = check_device(device)
    with GLOBAL_TRACER.recording() as rec:
        photo_dir = make_photo_set(src_h, src_w, n)
        paths = sorted(glob.glob(os.path.join(photo_dir, "*.jpg")))
        name = (f"stream_fps_{model}_{hin}x{win}_bs{batch}_src{src_h}x{src_w}"
                + ("_loader_only" if loader_only else ""))
        if loader_only:
            from openpose_plus_tpu_torch.loader import StreamLoader

            loader = StreamLoader(paths, hin, win, batch=batch,
                                  workers=workers, queue_capacity=4,
                                  loop=True, s2d=2)
            it = iter(loader)
            try:
                for _ in range(STREAM_DRAIN):
                    next(it)
                t0 = time.perf_counter()
                frames = 0
                while frames < repeat * batch:
                    frames += next(it)["images"].shape[0]
                dt = time.perf_counter() - t0
            finally:
                loader.close()
        else:
            from openpose_plus_tpu_torch.stream import StreamEstimator

            eng = _engine(model, hin, win, "bfloat16", 0, dev)
            est = StreamEstimator(eng, batch=batch, workers=workers)
            it = est.run_files(paths, loop=True)
            try:
                for _ in range(STREAM_DRAIN):
                    next(it)
                t0 = time.perf_counter()
                frames = 0
                for _ in range(repeat):
                    frames += next(it).n
                dt = time.perf_counter() - t0
            finally:
                it.close()
    out = {"metric": name, "value": round(frames / dt, 2),
           "unit": "frames/s", "ms_per_frame": round(dt / frames * 1e3, 3)}
    print(json.dumps(out), flush=True)
    print(rec.report(), file=sys.stderr)
    return out


def main(argv: Optional[list[str]] = None) -> int:
    from openpose_plus_tpu_torch.cli import add_device_flag

    parser = argparse.ArgumentParser(prog="openpose_plus_tpu_torch.bench",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("table", help="bench.py's rows; the headline first")
    add_device_flag(p, dest="device")

    p = sub.add_parser("one", help="one engine configuration")
    p.add_argument("--model", default="mobilenet_thin")
    p.add_argument("--hin", type=int, default=368)
    p.add_argument("--win", type=int, default=656)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--chunk", type=int, default=0,
                   help="serve the batch as a loop over chunk-sized "
                        "sub-batches (one graph; see engine.infer_step)")
    p.add_argument("--frag-merge", action="store_true",
                   help="enable the fragment-merge repair pass "
                        "(PostprocConfig.fragment_merge_rel=0.5) to "
                        "measure its serving cost")
    add_device_flag(p, dest="device")

    p = sub.add_parser("train", help="training-step throughput")
    p.add_argument("--model", default="mobilenet_thin")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hin", type=int, default=368)
    p.add_argument("--win", type=int, default=656)
    p.add_argument("--remat", action="store_true",
                   help="recompute stage activations in the backward pass")
    p.add_argument("--repeats", type=int, default=3)
    add_device_flag(p, dest="device")

    p = sub.add_parser("stream", help="stream throughput over seeded photos")
    p.add_argument("--model", default="mobilenet_thin")
    p.add_argument("--src-h", type=int, default=3000)
    p.add_argument("--src-w", type=int, default=4000)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--hin", type=int, default=368)
    p.add_argument("--win", type=int, default=656)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--repeat", type=int, default=40,
                   help="timed batches after the drain")
    p.add_argument("--loader-only", action="store_true",
                   help="host pipeline only (no engine), isolates decode")
    add_device_flag(p, dest="device")

    args = vars(parser.parse_args(argv))
    mode = args.pop("mode")
    {"table": table, "one": one, "train": train,
     "stream": stream}[mode](**args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
