#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (openpose_plus_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, any of which raises on failure (the
script then exits non-zero and prints no result):

1. Requires a CUDA device; prints the card's name and power limit
   (nvidia-smi).
2. Builds the hand-written kernels from openpose_plus_tpu_torch/csrc/ with
   nvcc (openpose_plus_tpu_torch/ops/cuda/build.py).
3. Kernel phases: each kernel against its plain PyTorch version on the
   card and on a CPU copy, at the main-path shapes (batch 8; K=16 and K=32;
   M=32) on random inputs with injected ties (tests/kernel_inputs.py).
   Outputs must be bit-equal.
4. Main path: Engine(default_config("mobilenet_thin"), seed=0,
   device="cuda") at full width (368x432, width 0.75, 6 stages, bfloat16),
   its last stage's prediction kernels scaled so that random weights give
   maps the decoder groups, runs `infer` on an (8, 368, 432, 3) uint8
   batch; both kernels' launch counts must rise during that call, every
   image must decode to at least one human, and the outputs must have the
   HumanBatch shapes and be finite. The float32 forward on the card must
   match the float32 forward on the CPU, and a synthetic scene of three
   standing people (tests/maputil.py) must decode to three full skeletons,
   identically on the card (with TF32 allowed for matmuls) and on the CPU.
5. Timings (CUDA events, median of 20 after warm-up): `infer` at batch 8,
   its CNN forward and decode parts alone, and each kernel beside its plain
   version.
6. With --profile only: batch scaling (1, 8, 32; decode also at the
   fidelity() preset), the host's enqueue time per call, and the device's
   busy time per call from torch.profiler (see `profile`).

The line before the last is the nvidia-smi name/power-limit line, the one
before it the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 8
TIMED_ITERS = 20
WARMUP = 3
PROFILED_CALLS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn) -> float:
    """Median wall time of fn() on the card, CUDA events, after warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, outs, refs) -> float:
    err = 0.0
    for o, r in zip(outs, refs):
        if o.dtype.is_floating_point:
            err = max(err, float((o.cpu() - r.cpu()).abs().max()))
    return err


def assert_equal(torch, what: str, outs, refs) -> None:
    for i, (o, r) in enumerate(zip(outs, refs)):
        if not torch.equal(o.cpu(), r.cpu()):
            raise AssertionError(f"{what}: output {i} differs")


def load_test_helper(name: str):
    """tests/<name>.py (numpy and the skeleton only) by path: another
    installed package named `tests` may shadow the repository's test
    directory."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scale_heads(torch, engine, images) -> dict:
    """Scale the last stage's prediction kernels so the served decode finds
    humans on random weights and images.

    The seeded random init gives final maps of ~5e-3, below the peak
    threshold: the decoder would find no peaks and the kernels would group
    nothing. The heads' 1x1 convs have zero biases, so scaling their
    kernels scales the maps exactly; the gains bring max |conf| to 0.7 and
    max |paf| to 5, as in tests/test_torch_engine.py."""
    conf, paf = engine.forward(images)
    stages = engine.model.stages
    n = engine.config.model.n_stages
    gains = {}
    for key, maps, target in (("conf", conf, 0.7), ("paf", paf, 5.0)):
        gains[key] = target / float(maps.abs().max())
        with torch.no_grad():
            getattr(stages, f"stage{n}_{key}").Conv_0.weight.mul_(gains[key])
    return gains


def profile(torch, np, rng, engine, images, gpu) -> None:
    """--profile: where the time of the served call goes.

    1. Batch scaling: CUDA-event medians of infer, forward and decode at
       batch 1, 8 and 32, and of decode at the fidelity() preset.
    2. Host enqueue: host-clock time for `infer` to return (its kernels
       queued, not run) beside the time to the end of its device work.
    3. Device busy: torch.profiler over PROFILED_CALLS calls at batch 8;
       the union of the device kernels' intervals per call, their count,
       and the idle share against the unprofiled median; then the top
       rows by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from openpose_plus_tpu_torch.postproc import decode_maps

    cfg = engine.config
    mc = cfg.model
    fidelity = cfg.postproc.fidelity()
    infer_ms = {}
    for bs in (1, BATCH, 32):
        imgs = torch.from_numpy(rng.integers(
            0, 256, (bs, mc.hin, mc.win, 3), dtype=np.uint8)).to(images.device)
        conf, paf = engine.forward(imgs)
        infer_ms[bs] = median_ms(torch, lambda: engine.infer(imgs))
        log(json.dumps({"scaling": {
            "batch": bs, "infer_ms": infer_ms[bs],
            "fps": bs * 1000.0 / infer_ms[bs],
            "forward_ms": median_ms(torch, lambda: engine.forward(imgs)),
            "decode_ms": median_ms(
                torch, lambda: decode_maps(conf, paf, cfg.postproc)),
            "decode_fidelity_ms": median_ms(
                torch, lambda: decode_maps(conf, paf, fidelity)),
            "gpu": gpu}}))

    enqueue, to_end = [], []
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.infer(images)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        to_end.append((t2 - t0) * 1e3)

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            engine.infer(images)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                 # union of intervals (one stream)
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3 / PROFILED_CALLS
    log(json.dumps({"host_and_device": {
        "batch": BATCH, "host_enqueue_ms": statistics.median(enqueue),
        "host_to_end_ms": statistics.median(to_end),
        "device_busy_ms": busy_ms,
        "device_kernels_per_call": len(spans) / PROFILED_CALLS,
        "device_idle_share": 1.0 - busy_ms / infer_ms[BATCH],
        "gpu": gpu}}))
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=15, max_name_column_width=60))


def main(argv: list[str]) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="also time infer/forward/decode at batch 1, 8 and 32, the "
             "host's enqueue time, and the device's busy time per call "
             "(torch.profiler)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    import numpy as np

    from openpose_plus_tpu_torch import Engine, default_config
    from openpose_plus_tpu_torch.models import get_model
    from openpose_plus_tpu_torch.ops.cuda import build, greedy, merge
    from openpose_plus_tpu_torch.postproc import decode_maps
    maputil = load_test_helper("maputil")
    inputs = load_test_helper("kernel_inputs")

    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
        if "ptxas info" in line and ("registers" in line
                                     or "Compiling" in line):
            log(f"  {line.strip()}")

    # ---- 3. kernel phases ----------------------------------------------
    rng = np.random.default_rng(0)
    cfg = default_config("mobilenet_thin")
    m = cfg.postproc.max_humans
    errs = {"greedy_assign": 0.0, "assemble": 0.0}
    for k in (16, 32):
        for density in (0.3, 1.0):
            scores = torch.from_numpy(inputs.limb_scores(rng, BATCH, k,
                                                         density))
            scores_dev = scores.to(dev)
            out = greedy.greedy_assign(scores_dev, k)
            plain_dev = greedy.greedy_assign_plain(scores_dev, k)
            plain_cpu = greedy.greedy_assign_plain(scores, k)
            torch.cuda.synchronize()
            assert_equal(torch, f"greedy K={k} vs plain (cuda)", out,
                         plain_dev)
            assert_equal(torch, f"greedy K={k} vs plain (cpu)", out,
                         plain_cpu)
            errs["greedy_assign"] = max(errs["greedy_assign"],
                                        max_abs_err(torch, out, plain_cpu))
            # merge on real greedy output and on random connection sets
            peak_score = torch.from_numpy(inputs.peak_scores(rng, BATCH, k))
            for conns in ([t.cpu() for t in plain_cpu],
                          [torch.from_numpy(x)
                           for x in inputs.connections(rng, BATCH, k)]):
                args_cpu = (*conns, peak_score)
                args_dev = tuple(t.to(dev) for t in args_cpu)
                out = merge.assemble(*args_dev, k, m)
                plain_dev = merge.assemble_plain(*args_dev, k, m)
                plain_cpu = merge.assemble_plain(*args_cpu, k, m)
                torch.cuda.synchronize()
                assert_equal(torch, f"merge K={k} vs plain (cuda)", out,
                             plain_dev)
                assert_equal(torch, f"merge K={k} vs plain (cpu)", out,
                             plain_cpu)
                errs["assemble"] = max(errs["assemble"],
                                       max_abs_err(torch, out, plain_cpu))
    log(f"kernels bit-equal to their plain versions at K=16, 32 (ties "
        f"included): max_abs_err {errs}")

    # ---- 4. main path ----------------------------------------------------
    engine = Engine(cfg, seed=0, device=dev)
    mc = cfg.model
    images = torch.from_numpy(rng.integers(
        0, 256, (BATCH, mc.hin, mc.win, 3), dtype=np.uint8)).to(dev)
    gains = scale_heads(torch, engine, images)
    engine.infer(images)                       # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    greedy.launches = 0
    merge.launches = 0
    out = engine.infer(images)
    torch.cuda.synchronize()
    launches = {"greedy_assign": greedy.launches,
                "assemble": merge.launches}
    log(f"main path: Engine.infer {tuple(images.shape)} {mc.name} "
        f"{mc.compute_dtype} {mc.n_stages} stages, head gains {gains}; "
        f"kernel launches {launches}; humans per image "
        f"{out.num_humans.tolist()}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"main path did not launch kernel {name}")
    if not bool((out.num_humans > 0).all()):
        raise AssertionError("main path decoded an image to no humans")
    expect = {"coords": (BATCH, m, 18, 2), "part_scores": (BATCH, m, 18),
              "part_valid": (BATCH, m, 18), "score": (BATCH, m),
              "n_parts": (BATCH, m), "valid": (BATCH, m)}
    for name, shape in expect.items():
        t = getattr(out, name)
        if tuple(t.shape) != shape or t.device != dev:
            raise AssertionError(f"HumanBatch.{name}: {tuple(t.shape)} on "
                                 f"{t.device}, expected {shape} on {dev}")
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"HumanBatch.{name} is not finite")

    # float32 forward on the card vs on the CPU, full width, one image;
    # TF32 off for this comparison only
    import dataclasses
    cfg32 = dataclasses.replace(mc, compute_dtype="float32")
    state = engine.model.state_dict()
    model_dev = get_model(cfg32).to(dev).eval()
    model_cpu = get_model(cfg32).eval()
    model_dev.load_state_dict(state)
    model_cpu.load_state_dict(state)
    x = (images[:1].float() / 255.0 - 0.5)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        o_dev = model_dev(x)
        o_cpu = model_cpu(x.cpu())
        o_bf16 = engine.model(x)
    for key in ("conf", "paf"):
        ref = o_cpu[key][-1]
        scale = float(ref.abs().max())
        err32 = float((o_dev[key][-1].cpu() - ref).abs().max())
        err16 = float((o_bf16[key][-1].float().cpu() - ref).abs().max())
        log(f"forward {key}: |ref|max {scale:.4g}, float32 card-vs-cpu "
            f"max_abs_err {err32:.3g}, bfloat16 card-vs-float32 cpu "
            f"{err16:.3g}")
        # float32, another accumulation order over ~40 conv layers
        if not err32 <= 1e-4 * scale:
            raise AssertionError(f"float32 forward {key} differs: {err32}")

    # synthetic scene: three standing people, card (kernels) vs CPU (plain)
    people = [maputil.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                      0.93 + 0.1 * i) for i in range(3)]
    conf, paf = maputil.make_maps(people, mc.hout, mc.wout)
    conf = torch.from_numpy(np.stack([conf] * BATCH))
    paf = torch.from_numpy(np.stack([paf] * BATCH))
    # with TF32 allowed for matmuls: the decoder's contractions must not
    # take it (they run in float64)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on_dev = decode_maps(conf.to(dev), paf.to(dev), cfg.postproc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    on_cpu = decode_maps(conf, paf, cfg.postproc)
    for name in ("valid", "n_parts", "part_valid"):
        assert_equal(torch, f"scene {name} card vs cpu",
                     [getattr(on_dev, name)], [getattr(on_cpu, name)])
    for name in ("coords", "part_scores", "score"):
        # float64 contractions summed in another order: ~1 ulp
        err = float((getattr(on_dev, name).cpu()
                     - getattr(on_cpu, name)).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"scene {name} card vs cpu: {err}")
    n_humans = on_dev.num_humans.tolist()
    if n_humans != [3] * BATCH or not bool(
            (on_dev.n_parts[:, :3] == 18).all()):
        raise AssertionError(f"scene decoded to {n_humans} humans, "
                             f"parts {on_dev.n_parts[0, :4].tolist()}")
    log(f"scene: 3 standing people -> {n_humans[0]} humans x 18 parts, "
        f"card == cpu")

    # ---- 5. timings -------------------------------------------------------
    infer_ms = median_ms(torch, lambda: engine.infer(images))
    forward_ms = median_ms(torch, lambda: engine.forward(images))
    conf, paf = engine.forward(images)
    decode_ms = median_ms(torch, lambda: decode_maps(conf, paf, cfg.postproc))
    log(json.dumps({"infer": {
        "model": mc.name, "batch": BATCH, "hw": [mc.hin, mc.win],
        "dtype": mc.compute_dtype, "stages": mc.n_stages,
        "ms": infer_ms, "fps": BATCH * 1000.0 / infer_ms,
        "forward_ms": forward_ms, "decode_ms": decode_ms, "gpu": gpu}}))
    k = cfg.postproc.max_peaks
    scores = torch.from_numpy(inputs.limb_scores(rng, BATCH, k)).to(dev)
    conns = [torch.from_numpy(x).to(dev)
             for x in inputs.connections(rng, BATCH, k)]
    peak_score = torch.from_numpy(inputs.peak_scores(rng, BATCH, k)).to(dev)
    timing = {
        "greedy_assign": (
            median_ms(torch, lambda: greedy.greedy_assign(scores, k)),
            median_ms(torch, lambda: greedy.greedy_assign_plain(scores, k))),
        "assemble": (
            median_ms(torch, lambda: merge.assemble(*conns, peak_score, k,
                                                    m)),
            median_ms(torch, lambda: merge.assemble_plain(*conns, peak_score,
                                                          k, m))),
    }
    for name, (ms, plain_ms) in timing.items():
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(batch {BATCH}, K={k}, M={m}; {gpu})")
    if args.profile:
        profile(torch, np, rng, engine, images, gpu)

    if "jax" in sys.modules or "flax" in sys.modules:
        raise AssertionError("the port pulled in jax/flax")

    source = {"greedy_assign": ("openpose_plus_tpu_torch/csrc/greedy.cu",
                                "openpose_plus_tpu/ops/pallas/greedy.py:53"),
              "assemble": ("openpose_plus_tpu_torch/csrc/merge.cu",
                           "openpose_plus_tpu/ops/pallas/merge.py:151")}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name][0],
         "replaces": source[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[name][0],
         "plain_ms": timing[name][1]} for name in source]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
