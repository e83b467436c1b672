"""The port's benchmark harness (`openpose_plus_tpu_torch/bench.py`) on the
CPU: its slope against the JAX package's `bench.fori_slope_seconds` on a
virtual clock, its FLOP count against XLA's `cost_analysis` of the JAX
program, `utilization_row`, the chained step against `Engine.infer`, and
every mode end to end on the CPU at a tiny size (one valid slope sample
a row: 70 calls of ~0.12 s, the plain decoder's).

The slope cases are tests/test_bench_harness.py's, on the same virtual
device: each loop_fn(n, carry) call costs `overhead + n * per_iter`, and
the slope must recover per_iter whatever the overhead."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.config import default_config as jax_default_config
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu_torch import bench as tbench
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.engine import Engine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (root bench.py: no JAX at import)

torch.set_num_threads(2)

HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline", "mfu_pct",
                 "hbm_pct_est", "spread_pct"]
ROW_KEYS = {"fps", "batch", "spread_pct", "flops_per_exec",
            "achieved_tflops", "mfu_pct", "hbm_gbps_est", "hbm_pct_est",
            "flops_per_image"}


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _simulated(clock, per_iter, overhead, jitter=0.0):
    """loop_fn of a device whose pass of n iterations costs overhead + n *
    per_iter (+ a seeded jitter), and the n of each call."""
    calls = []
    rng = np.random.default_rng(0)

    def loop_fn(n, carry):
        calls.append(n)
        clock.now += overhead + n * per_iter
        if jitter:
            clock.now += float(rng.uniform(0, jitter))
        return np.float32(carry + n)

    return loop_fn, calls


def _run(monkeypatch, per_iter, overhead, jitter=0.0, module=tbench):
    clock = VirtualClock()
    loop_fn, calls = _simulated(clock, per_iter, overhead, jitter)
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    dt = module.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)
    return dt, calls


def test_slope_cancels_fixed_overhead_exactly(monkeypatch):
    per_iter = 2.5e-3
    for overhead in (80e-6, 2.5e-3, 0.5):  # good window .. terrible window
        dt, _ = _run(monkeypatch, per_iter, overhead)
        assert abs(dt - per_iter) < 1e-12, (overhead, dt)


def test_slope_sizes_passes_to_target(monkeypatch):
    dt, calls = _run(monkeypatch, per_iter=1e-4, overhead=1e-3)
    assert abs(dt - 1e-4) < 1e-12
    assert max(calls) == 1000          # ~0.4 s of device time: the cap
    dt, calls = _run(monkeypatch, per_iter=0.05, overhead=1e-3)
    assert abs(dt - 0.05) < 1e-12
    assert min(calls) >= 5


def test_slope_median_rejects_degraded_pass(monkeypatch):
    per_iter = 2e-3
    dt, _ = _run(monkeypatch, per_iter, overhead=1e-3, jitter=1e-3)
    assert abs(dt - per_iter) < 1e-4


def test_nonpositive_slopes_discarded_not_clamped(monkeypatch):
    """A long stall on the first short pass makes its slope negative: it
    is discarded, and the clean passes give per_iter."""
    clock = VirtualClock()
    per_iter, overhead = 2e-3, 1e-3
    state = {"calls": 0}

    def loop_fn(n, carry):
        clock.now += overhead + n * per_iter
        state["calls"] += 1
        if state["calls"] == 3:
            clock.now += 30.0
        return np.float32(carry + n)

    monkeypatch.setattr(tbench.time, "perf_counter", clock.perf_counter)
    dt = tbench.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)
    assert abs(dt - per_iter) < 1e-9
    assert dt > 1e-4


def test_all_passes_degraded_raises(monkeypatch):
    clock = VirtualClock()
    state = {"calls": 0}

    def loop_fn(n, carry):
        state["calls"] += 1
        clock.now += 1e-3 + n * 2e-3
        if state["calls"] >= 3 and state["calls"] % 2 == 1:
            clock.now += 30.0  # stall every small pass
        return np.float32(carry + n)

    monkeypatch.setattr(tbench.time, "perf_counter", clock.perf_counter)
    with pytest.raises(RuntimeError, match="no positive slope"):
        tbench.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)


@pytest.mark.parametrize("per_iter,overhead,jitter", [
    (2.5e-3, 0.5, 0.0), (1e-4, 1e-3, 0.0), (2e-3, 1e-3, 1e-3),
    (0.05, 2e-3, 0.04)])
def test_slope_equals_the_reference(monkeypatch, per_iter, overhead,
                                    jitter):
    """The same simulated device and jitter seed through the port's and the
    JAX package's `fori_slope_seconds`: the same passes, samples and
    figure."""
    ours = _run(monkeypatch, per_iter, overhead, jitter)
    ref = _run(monkeypatch, per_iter, overhead, jitter, module=jbench)
    assert ours == ref


# ---------------------------------------------------------------- cost ---

def _tiny_pair(name, dtype):
    """A JAX engine and the port's on its weights: 64x64, 2 stages, the
    plain stem in both (the JAX package's s2d stem lowers to a block-grid
    conv that multiplies zero taps, work the port's plain stem does not
    do), the int8 engine calibrated on the images."""
    kw = dict(hin=64, win=64, n_stages=2, compute_dtype=dtype,
              stem_s2d=False)
    jcfg = jax_default_config(name)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **kw))
    tcfg = tconfig.default_config(name)
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **kw))
    images = np.random.default_rng(0).integers(
        0, 255, jcfg.model.input_shape(2), dtype=np.uint8)
    jeng = JaxEngine(jcfg, fast_init=True)
    jeng.calibrate(jnp.asarray(images))
    eng = Engine(tcfg, params=_flatten(jax.device_get(jeng.params)),
                 device="cpu")
    return jeng, eng, images


# XLA's count against the port's, |port / XLA - 1| <= FLOP_TOL. The two
# count the convolutions and the decoder's contractions at 2 per
# multiply-add, and differ in two ways at this size: XLA leaves out the
# taps of a SAME conv that fall on the padding (10.5% of VGG-tiny's conv
# flops on its 8x8 stage maps, 0.6% of MobileNet-thin's; the port counts
# every tap, as FlopCounterMode does), and XLA also counts elementwise ops
# (2-7% here). Measured: MobileNet-thin bf16 0.941, VGG-tiny int8 1.082.
FLOP_TOL = 0.12


@pytest.mark.parametrize("name,dtype", [("mobilenet_thin", "bfloat16"),
                                        ("vggtiny", "int8")])
def test_flop_count_agrees_with_xla(name, dtype):
    jeng, eng, images = _tiny_pair(name, dtype)
    xla_flops, xla_bytes = jbench.program_cost(jeng._infer, jeng.params,
                                               jnp.asarray(images))
    x = torch.from_numpy(images)
    eng.infer(x)                        # warm: int8 weights packed
    flops, nbytes = tbench.program_cost(eng, x)
    assert abs(flops / xla_flops - 1) <= FLOP_TOL, (flops, xla_flops)
    assert 0 < nbytes and 0 < xla_bytes


def test_int8_flops_count_the_layers_own_channels():
    """The int8 engine does the bf16 engine's convolutions: the quantize
    pass's zero channels (Cin padded to a multiple of 64) are not
    counted."""
    cfg = tconfig.default_config("vggtiny")
    counts = []
    for dtype in ("bfloat16", "int8"):
        c = cfg.replace(model=dataclasses.replace(
            cfg.model, hin=64, win=64, n_stages=2, compute_dtype=dtype))
        eng = Engine(c, seed=0, device="cpu")
        x = torch.from_numpy(np.random.default_rng(1).integers(
            0, 255, (1, 64, 64, 3), dtype=np.uint8))
        eng.infer(x)
        counts.append(tbench.program_cost(eng, x)[0])
    assert counts[0] == counts[1] > 0


def test_chunked_call_counts_every_chunk():
    cfg = tconfig.default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=64, win=64,
                                                n_stages=2))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, cfg.model.input_shape(4), dtype=np.uint8))
    whole = tbench.program_cost(Engine(cfg, device="cpu"), x)[0]
    chunked = tbench.program_cost(Engine(cfg, chunk=2, device="cpu"), x)[0]
    assert chunked == whole > 0


def test_utilization_row():
    row = tbench.utilization_row(flops=2.0e12, nbytes=6.7e9, dt=4e-3)
    # 2e12 / 4e-3 = 500 TFLOP/s of 989; 6.7e9 / 4e-3 = 1675 GB/s of 3350
    assert row == {"flops_per_exec": 2.0e12, "achieved_tflops": 500.0,
                   "mfu_pct": 50.6, "hbm_gbps_est": 1675.0,
                   "hbm_pct_est": 50.0}


# ------------------------------------------------------------ the chain ---

def _tiny_engine(name="mobilenet_thin", dtype="bfloat16", chunk=0):
    cfg = tconfig.default_config(name)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype=dtype))
    return Engine(cfg, seed=0, chunk=chunk, device="cpu")


def _assert_same_humans(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_chained_step_is_the_served_call():
    """With a finite carry the chained step serves the images as `infer`
    does, and leaves the score sum in the carry; a non-finite carry serves
    zeros."""
    eng = _tiny_engine(chunk=1)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, eng.config.model.input_shape(2), dtype=np.uint8))
    chain = tbench.ChainedStep(eng, x)
    assert chain.graph is None          # the CPU runs the step eagerly
    carry = chain.run(2)
    expect = eng.infer(x)
    _assert_same_humans(chain.out, expect)
    assert float(carry) == float(expect.score.sum())
    with torch.inference_mode():
        chain.carry.fill_(float("nan"))
    chain.run(1)
    _assert_same_humans(chain.out, eng.infer(torch.zeros_like(x)))


# -------------------------------------------------------------- modes ---

def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_table_mode(monkeypatch, tmp_path, capsys):
    details = tmp_path / "details.json"
    monkeypatch.setenv("BENCH_DETAILS_PATH", str(details))
    monkeypatch.delenv("BENCH_HEADLINE_ONLY", raising=False)
    monkeypatch.setattr(tbench, "ROWS", (
        ("head", "mobilenet_thin", 64, 64, 1, "bfloat16", 0),
        ("second", "mobilenet_thin", 64, 64, 2, "bfloat16", 0)))
    tbench.table(device="cpu", repeats=1)
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line) == HEADLINE_KEYS
    assert line["metric"] == "head" and line["value"] > 0
    rows = json.loads(details.read_text())
    assert list(rows) == ["head", "second"]
    for row in rows.values():
        assert set(row) == ROW_KEYS and row["fps"] > 0
    assert rows["second"]["flops_per_image"] == rows["head"][
        "flops_per_image"]


def test_table_rows_yield_the_timed_chains(monkeypatch, tmp_path, capsys):
    """`table_rows` yields each row with its timed chain; with
    BENCH_HEADLINE_ONLY it stops after the headline's line and writes no
    details."""
    details = tmp_path / "details.json"
    monkeypatch.setenv("BENCH_DETAILS_PATH", str(details))
    monkeypatch.setenv("BENCH_HEADLINE_ONLY", "1")
    rows = (("head", "mobilenet_thin", 64, 64, 1, "float32", 0),
            ("second", "mobilenet_thin", 64, 64, 2, "float32", 0))
    ((name, m),) = list(tbench.table_rows(rows, device="cpu", repeats=1))
    assert name == "head" and isinstance(m.chain, tbench.ChainedStep)
    assert m.row["fps"] == round(1 / m.seconds, 2) and m.samples
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line) == HEADLINE_KEYS and line["metric"] == "head"
    assert not details.exists()


def test_one_mode(capsys):
    tbench.one(model="mobilenet_thin", hin=64, win=64, batch=1,
               dtype="float32", device="cpu", repeats=1)
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line) == ["metric", "value", "unit", "ms_per_batch",
                          "spread_pct", "flops_per_exec", "achieved_tflops",
                          "mfu_pct", "hbm_gbps_est", "hbm_pct_est"]
    assert line["metric"] == "e2e_fps_mobilenet_thin_float32_64x64_bs1"
    assert line["value"] > 0 and line["flops_per_exec"] > 0


def test_train_mode(capsys):
    assert tbench.main(["train", "--model", "mobilenet_thin", "--batch",
                        "2", "--hin", "64", "--win", "64", "--repeats", "1",
                        "--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line) == ["metric", "value", "unit", "ms_per_step"]
    assert line["metric"] == "train_imgs_per_sec_mobilenet_thin_64x64_bs2"
    assert line["value"] > 0 and line["unit"] == "imgs/s"


@pytest.mark.parametrize("loader_only", [False, True])
def test_stream_mode(monkeypatch, tmp_path, capsys, loader_only):
    monkeypatch.setattr(tbench, "PHOTO_ROOT", str(tmp_path))
    argv = ["stream", "--src-h", "96", "--src-w", "128", "--n", "4",
            "--hin", "64", "--win", "64", "--batch", "2", "--workers", "2",
            "--repeat", "2", "--device", "cpu"]
    assert tbench.main(argv + ["--loader-only"] * loader_only) == 0
    out = capsys.readouterr()
    (line,) = _json_lines(out.out)
    assert list(line) == ["metric", "value", "unit", "ms_per_frame"]
    assert line["metric"] == ("stream_fps_mobilenet_thin_64x64_bs2_src96x128"
                              + "_loader_only" * loader_only)
    assert line["value"] > 0
    assert "decode" in out.err and "resize" in out.err   # the scopes
    (photos,) = tmp_path.iterdir()
    assert len(list(photos.glob("*.jpg"))) == 4


@pytest.mark.parametrize("mode", ["table", "one", "train", "stream"])
def test_no_card_no_run(mode):
    """Without a card the default device raises and names the flag."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbench.main([mode])
