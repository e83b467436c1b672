#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (openpose_plus_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package
(`openpose_plus_tpu`): the port keeps its own `config` and `skeleton`, and
the synthetic scenes come from tests/kernel_inputs.py; the end of the run
checks `sys.modules` for both (`foreign_modules`). It times with the
benchmark's yardstick: device times are `benchmark/harness/device_time.
graph_ms`, the peaks those of `benchmark/harness/cost.py`. It checks what
needs a full-size engine or the whole machine, and each kernel it times;
the kernels on seeded inputs are `cuda` tests (tests/test_torch_cuda.py).
Phases, any of which raises on failure (the script then exits non-zero and
prints no result):

1. Requires a CUDA device; prints the card's name and power limit
   (nvidia-smi).
2. Builds the hand-written kernels from openpose_plus_tpu_torch/csrc/ with
   nvcc (openpose_plus_tpu_torch/ops/cuda/build.py) and prints ptxas'
   report: every instance of greedy, merge, the int8 conv (one a tile plan
   and output type), the two quantize passes and the 16 of bias_act must
   keep 0 bytes of stack and spills.
4. Main paths: Engine(default_config("mobilenet_thin"), seed=0,
   device="cuda") at full width (368x432, width 0.75, 6 stages, bfloat16),
   its last stage's prediction kernels scaled so that random weights give
   maps the decoder groups, runs `infer` on an (8, 368, 432, 3) uint8
   batch; the find_peaks, greedy, merge and sample_paf launch counts must
   rise during that call, every image must decode to at least one human,
   and the outputs must have the HumanBatch shapes and be finite and
   compacted. Then the same
   with `fused_inference=True` on the same weights: fused_sepconv must
   launch exactly 41 times in the call, the decoder's kernels must launch,
   every image must decode to a human, and the final maps must lie within
   2e-2 of the map scale of the unfused engine's. The float32 forward on
   the card must match the float32 forward on the CPU, and a synthetic
   scene of three standing people (tests/kernel_inputs.py) must decode to
   three full skeletons, identically on the card (with TF32 allowed for
   matmuls) and on the CPU.
5. Accuracy paths, on both engines of phase 4 and its images (see
   `accuracy_paths`): `infer(flip_tta=True)` and `infer_multiscale` are
   captured in a CUDA graph at their first call and replayed after
   (`replayed_path`): the eager module functions (`infer_tta`,
   `infer_multiscale_avg`, `infer_multiscale_dedup`) launch the decoder's
   kernels (and fused_sepconv 41 x 2 / 41 x 6 times on the fused engine),
   the capturing call launches CAPTURE_WARMUP + 1 times as many from Python
   (its warm-ups and the capture), the replay none, and both give the eager
   HumanBatch bit for bit (phase 12's trace shows the replays' kernels by
   name); the memory each graph keeps is recorded (`graph_bytes`). The s2d
   and s2d^2 forms of the images give HumanBatches equal to the plain
   call's, with and without flip-TTA; flip-TTA finds a human in every
   image; `mirror_maps` twice is the identity; the three-person scene
   decoded from its mirrored maps is the scene mirrored, card == CPU; the
   scale search at scales (0.5, 1.0, 1.5) with flip, "avg" and "dedup",
   gives sorted finite HumanBatches of 32 and 96 rows, and the fused maps
   lie within 2e-2 of the unfused ones at each scale's grid (23x27, 46x54,
   69x81); the `quality()` decoder on a scene of truncated people agrees
   card vs CPU and merges fragments (fewer, fuller skeletons than
   `fidelity()`); `merge_dedup` on the card equals the CPU's; flip-TTA and
   the scale search (dedup, no flip) under the fidelity() and quality()
   decoders replay equal to their eager calls.
6. The kernels' timings, the figures of the final `kernels` line (CUDA
   events, median of 20 after warm-up; device times by `graph_ms`, which
   leave out the host's dispatch that the event time of one small call is
   made of): every kernel beside its plain version, checked against it
   on the card (greedy, merge, sample_paf, find_peaks and copy_bias bit for
   bit in every output; fused_sepconv within 2 bf16 units and dw3x3_relu
   within 1, each at least 98% identical; find_peaks and the probe's
   kernels in one launch a call) and its max_abs_err recorded, its bound (`bound`: bytes over the HBM rate against
   operations over the peak of their type) and the one PyTorch call that
   computes the same function where there is one (`library_ms`; never
   called by the port): the advanced-index gather for sample_paf, cuDNN's
   depthwise + ReLU for dw3x3_relu, `x + b` for copy_bias, and for
   fused_sepconv, which no one call computes, the cuDNN depthwise +
   pointwise pair. greedy and merge on seeded random sets at K=16 and K=32
   (`decoder_kernel_times`, beside their chain estimate; plain at the
   served K); fused_sepconv at each of the fused model's six (C, F) layer
   shapes (batch 8, 46x54; `sepconv` lines), summed over the 41 layers of
   one forward; the depthwise probe at (8, 46, 82, C), C in {128, 256};
   sample_paf at K=16 on the default 92x108 map; find_peaks at the
   fidelity() shape (368x432, K 32) on phase 4's head-scaled maps
   (`peaks_times`: `torch.topk` on the plain version's masked plane as the
   library call, the byte bound with the maps' L2 residency, the launches
   of a call and the peaks a row). A `kernel_times` line each.
7. The rest of the zoo (`zoo_paths`): for each of VGG19, VGG-tiny and
   hao28, Engine(default_config(name), seed=0, device="cuda") at full
   width (368x432, 6 stages, bfloat16) with its heads scaled as in phase 4
   runs `infer` on phase 4's batch-8 images: the greedy, merge and
   sample_paf counts must rise during that call (set to 0 just before it,
   read just after), every image must decode to a human, the HumanBatch
   must have its shapes and be finite and compacted, and the s2d form of
   the images must give an equal HumanBatch; the float32 forward on the
   card must match the float32 forward on the CPU at batch 1 within
   FORWARD32_REL_TOL of the map scale. A `zoo` line per model: launches,
   humans and the float32 forward's error.
   7b. BODY_25 at the body25.batch_bs8 cell's shapes (`body25_phase`):
   Engine(default_config("body25")) at 368x656 with its last PAF and
   heatmap predictions
   scaled (`scale_paf_first_heads`): the find_peaks, greedy, merge and
   sample_paf counts must rise during one `infer` (set to 0 just before
   it), the HumanBatch must hold 25 parts a row and be finite and
   compacted, the compiled graph's replay must equal the eager call, and
   three BODY_25 people drawn on the 46x82 grid must decode to three full
   skeletons, card == CPU. A `body25` line: launches, humans, `infer` ms.
   7c. The conv epilogue `bias_act` (`bias_act_phase`): on each bf16
   engine of BIAS_ACT_CALLS at its cells' shapes (BODY_25 and VGG19 at
   batch 8, 368x656; MobileNet-thin fused, the fidelity and live cells'
   engine, and unfused, phase 4's, at batch 8 and 1, 368x432): one eager
   `infer` launches it 108, 80, 21 and 103 times (the count set to 0 just
   before it; BODY_25's and VGG19's three pooled calls among them); the
   forward's maps through the kernel equal those with the op swapped for
   its plain version (dense blocks written in place either way), and both
   forwards' device times; at each distinct call shape of the forward the
   kernel, the plain expressions (pooled: then PyTorch's pool) and the
   byte bound at 3.35 TB/s are timed, inputs rotated past the L2. A
   `bias_act` line an engine and batch: per shape and summed over the
   forward; the `kernels` line's `bias_act` entry is BODY_25's sums.
8. The GT-map oracle on the card (`oracle_phase`): `ap_oracle` renders the
   ground-truth maps of the serving tier's 96 seeded val images
   (368x432, stride 8, sigma 8) on the card and decodes them with the
   port's decoder at the base, fidelity() and fidelity() + fragment-merge
   settings (each decode launches greedy, merge and sample_paf, counts
   read per variant). "perfect" must read AP 1.0, the three map variants
   must lie within ORACLE_AP_TOL of ap_benchmark.json's "oracle@368"
   record, and the same variants on the first ORACLE_CPU_IMAGES images on
   the CPU must give the card's AP on them within ORACLE_CPU_TOL. An
   `oracle` line per variant: AP beside the record and its delta, the
   variant's seconds.
9. `evaluate_engine` on the card (`eval_phase`): a seeded val bank of
   EVAL_IMAGES serving-size (736 px) JPEGs drawn with cv2 into a temporary
   directory of the checkout, streamed through the pooled loader
   (`loader.StreamLoader`: decoded DCT-scaled, here at 1/2, to a 368x368
   plane, letterboxed to 368x432, packed s2d^2) at batch 8 and served by
   phase 4's scaled-head MobileNet-thin bf16 engine: the run must complete
   with detections and a finite AP, launching greedy, merge and sample_paf
   once a batch, and a CPU engine on the same weights must give the same
   AP within EVAL_CPU_TOL. Then the same on EVAL_TIMED_IMAGES images (the
   studies' 96-image serving val bank) on the card alone, timed. An
   `evaluate_engine` line: both APs, the plane the loader decoded to, the
   launches and seconds of each run. Then the legacy checkpoint layout:
   the card engine's weights written as a pre-flattening npz (ConvRelu
   convs under 'Conv_0') and as the current one, each served through
   `Engine(cfg, params=checkpoint.load_npz(path))` on phase 4's batch: both
   HumanBatches must equal the card engine's bit for bit (a
   `legacy_checkpoint` line).
10. Training (`train_phase`): MobileNet-thin at full width (368x432,
   width 0.75, 6 stages, bf16, batch 8, lr 1e-3, no weight decay,
   ap_benchmark.py's moderate augmentation: `ap_bench.build_config`) on a
   seeded bank of TRAIN_IMAGES serving-size images drawn with cv2 into a
   temporary directory of the checkout. (1) One step from the same seeded
   parameters on the same TRAIN_CPU_BATCH images on the card and on the
   CPU: the loss within TRAIN_LOSS_RTOL, every gradient leaf within
   TRAIN_LEAF_RTOL relative L2 and all leaves within TRAIN_ALL_RTOL, every
   updated parameter within 2 lr (`train_step_card_vs_cpu`). (2)
   `train_loop` with the real pipeline for TRAIN_STEPS steps (a loss and a
   metrics-CSV row every step, a checkpoint every TRAIN_CKPT): every loss
   finite, the mean of the last 50 below TRAIN_FALL x the mean of the
   first 10, no hand kernel launched, the steps through one captured CUDA
   graph; then a resume to TRAIN_RESUME_TO that logs "resumed from step
   TRAIN_STEPS" and captures again. (3) The trained state_dict
   served by an Engine: `infer` launches the decoder's kernels and gives
   a finite, compacted HumanBatch. (4) A `train` line: the step's event
   median on a batch already on the card, its device-busy time
   (torch.profiler), the imgs/s of `train_loop` with the pipeline (log
   every 100 steps), the batches/s of `TrainPipeline` alone and which of
   the two sets the pace, peak memory, and the step's FLOP bound (3 x the
   forward's conv flops, `conv_flops`, over the bf16 tensor-core peak)
   with the share of it the step reaches. (5) A `train_graph` line: the
   step eager (`train._update`) and replayed, event ms, device-busy ms and
   idle share from one torch.profiler session (the calls
   TRAIN_TRACE_GAP_S apart), the graphed `train_loop`'s imgs/s beside the
   pipeline's, the captured step's memory, and the graph against eager
   (`train_graph_spread`): two eager runs and one graphed run of
   TRAIN_SPREAD_STEPS steps from the seeded state, the graphed within the
   eager runs' spread.
11. Calibrated int8 (`int8_phase`): for VGG19 and MobileNet-thin at full
   width (368x432, 6 stages, batch 8, phase 4's images): a bf16 engine
   seeded and head-scaled as in phases 4 and 7, an int8 engine on its weights
   (zero scales), `calibrate` on the batch (timed), then `infer`: the
   decoder's kernels launch, int8_conv launches once per ConvRelu and
   SepConvRelu and quantize_act once per float input (`int8_layers`),
   the HumanBatch is finite and compacted with a human in every image
   where the bf16 engine finds one. The forward's every int8_conv and
   quantize_act output equals that of the same forward routed through
   the plain versions (each distinct shape also checked kernel vs plain
   on its own inputs), the maps within INT8_PLAIN_TOL of their scale, and
   the int8 conf maps have cosine > INT8_COSINE against the bf16 engine's.
   An `int8` line per model (forward device ms int8 and bf16, infer
   event ms, calibration ms, the FLOP bound: int8 convs at the int8 peak,
   depthwise at bf16, heads at f32), a `kernel_times` line per int8_conv
   shape group (event and device ms, plain, bound, the tile plan,
   `torch._int_mm` on the 1x1 layers as `library_*`, the bf16 cuDNN conv
   of the shape as `cudnn_*`) and an `int8_forward_layers` line (the
   groups summed over a forward, and the quantize passes; int8_conv's own
   device time summed over the layers `torch._int_mm` was timed on, and
   the pair per shape group, `library_pairs`).
12. The deploy path (`deploy_phase`): copies of phase 4's two engines (same
   weights) and phase 11's VGG19 int8 engine, calibrated on the batch, each
   `compile`d at batch 8 (a CUDA-graph capture of `infer`): the replay
   launches no kernel from Python (the counts stay 0) and its HumanBatch
   equals the eager call's; a torch.profiler trace of the replays shows
   the kernels by name, per replay one greedy_assign_kernel,
   assemble_kernel and sample_paf_kernel, 41 fused_sepconv_kernel on the
   fused engine, and on the int8 engine one int8_conv_kernel per int8 layer
   and one quantize pass per float input, as phase 11 counts them; a
   result held by the caller is unchanged after the next call. The int8
   engine's flip-TTA is captured and replayed equal to its eager call
   (`replayed_path`), and the same trace shows one replay of each of phase
   5's flip-TTA and scale-search graphs (the decoder's kernels once a
   decode, 41 x 2 / 41 x 6 fused_sepconv) and of the int8 flip-TTA (2 x
   the int8 layers). The three compiled engines are exported at batch 8
   (`export.save_engine`) and reloaded in a fresh process: each artifact's
   first call captures (CAPTURE_WARMUP + 1 Python launches of each of its
   kernels), its replays launch none from Python and give the compiled
   engine's HumanBatch, and a trace of one replay (that process's only
   profiler session) names the compiled engine's kernels; the process
   imports neither `models` nor `engine`. `StreamEstimator.run_frames`
   over DEPLOY_FRAMES frames of mixed sizes gives, batch by batch, `infer`
   on the letterboxed batch; `python -m openpose_plus_tpu_torch infer`,
   `export` and `infer --engine-dir` on cv2-written JPEGs exit 0. A
   `deploy` line: each compile's seconds and graph's bytes, a replay's
   device-busy ms and device events (the artifacts' beside the compiled
   engines'), the artifacts' export and load seconds, the CLI's seconds.
13. The file stream and the grouping oracle (`stream_phase`): a seeded
   set of STREAM_JPEGS 640x480 JPEGs, STREAM_PNGS PNGs of mixed sizes and
   one unreadable file in a temporary `.smoke_bank_stream_*` directory.
   `StreamEstimator.run_files` on a compiled copy of phase 4's engine
   (batch 8, 368x432, 6 stages, bf16; it must be on the card) gives, batch
   by batch, `infer` on the loader's own batch (`loader.StreamLoader`);
   every readable file appears once and the unreadable one never. A replay
   raises no Python launch count (phase 12), so one torch.profiler session
   over that run names the kernels: greedy, merge and sample_paf once a
   batch. Phase 4's three-person scene and two noisy versions of it
   decode on the card to the humans of the port's numpy grouping oracle
   (`postproc/oracle.decode_oracle` on the card's own preprocessed maps;
   tests/test_postproc_parity.py's criteria): the card machine's first
   check of the decoder that does not come from the decoder's own code.
   `python -m openpose_plus_tpu_torch stream --images '<dir>/*.jpg' --loop
   --repeat 20` exits 0 and prints the host scopes' report; cv2 keeps its
   thread count once the loaders close. A `stream` line: the batches, the
   kernels of the traced run, the humans, the CLI's rate line, and the
   machine's CPU count.
14. The distributed layer (`parallel_phase`; `openpose_plus_tpu_torch.
   parallel`). (1) One NCCL rank on the card, started from torchrun's
   environment by `sharding.init_distributed`: the sync-sgd step (its
   gradient all_reduce over the rank) equals the plain
   `make_train_step_on_batch` step bit for bit (cuDNN held to
   deterministic algorithms; the plain step run twice first), and
   `Engine(mesh=)` of size 1 equals `infer` and launches the decoder's
   kernels. (2) PARALLEL_RANKS spawned ranks sharing the card over gloo
   (NCCL takes one rank a device), MobileNet-thin at full width (368x432,
   bf16, Adam at TRAIN_LR), a global batch of BATCH: PARALLEL_STEPS steps of
   each of sync-sgd, sma and pair-avg leave the ranks' replicas bit-identical
   (with two ranks pair-avg's one round pairs them); sync-sgd's first step
   lies within phase 10's card-vs-CPU tolerances of one process stepping on
   the global batch; `Engine(mesh=)` on phase 4's weights and images gives
   every rank the whole HumanBatch, bit-equal to a batch-4 engine on each
   rank's slice, its maps (`forward`) within 2e-2 of their scale of phase
   4's batch-8 maps (cuDNN's batch-4 algorithms move bf16 ulps, which move
   peaks: the decodes are not compared), and launches greedy, merge and
   sample_paf on every rank (counts set to 0 before the call, read after);
   distributed `evaluate_engine` over phase 9's bank gives phase 9's AP
   within PARALLEL_EVAL_TOL and its detection count on every rank. A
   `parallel` line ("two ranks on one card, not a scaling figure"): per
   strategy the step's ms, the collective, its bytes and ms; the mesh
   `infer` ms beside one process's; which collectives gloo takes on CUDA
   tensors (`gloo_cuda_probe`, all_to_all_single with uneven splits
   included). (3) The spatial axis (`parallel.spatial`): the same two ranks
   as a 1 data x 2 spatial mesh, each running the model on its band of
   image rows with halo-exchanged convs, sync-sgd from the seeded state:
   MobileNet-thin PARALLEL_STEPS steps, VGG19 (368x432, bf16; its 7x7
   refine convs read 3 rows of the other band) SPATIAL_VGG_STEPS; both
   replicas bit-identical after every step, the first step within phase
   10's card-vs-CPU tolerances of one process stepping on the global
   batch. The `parallel` line's `spatial` object ("two ranks on one card,
   not a scaling figure"): per model and rank the step ms, the halo
   exchanges' calls, bytes and ms a step and the map gather's bytes and
   ms (ms from one more step synchronised around each collective), and
   each rank's `max_memory_allocated` in its first step, and what it
   allocated beyond what it held before, beside one process's.
   `--spatial-phase` runs (3) alone and prints a `spatial` line.
15. The bench (`bench_phase`; `openpose_plus_tpu_torch.bench`): the whole
   `table` mode (bench.py's twelve rows at 368x656, each a CUDA graph of
   the chained served step timed by the two-point slope, with its FLOPs
   and bytes from shapes; `bench.table_rows`), each row held against its
   plain versions at its own shapes (`bench_row_vs_plain`: the int8 conv
   and quantize outputs of an int8 row bit-equal call by call, its maps
   within INT8_PLAIN_TOL; the decode bit-equal to its plain-routed
   version; the graph's HumanBatch against the plain one by
   `compare_decodes`; a scene of people across the row's map grid decoded
   bit-equal and in full); no row may carry a cost error, and its fps,
   step, MFU, HBM share and FLOPs are finite. The headline's two-point
   slope (`bench.fori_slope_seconds`) lies within BENCH_SLOPE_TOL of
   `graph_ms` of the same chained step, read once each; the headline
   graph's HumanBatch equals `Engine.compile`d `infer` on the same images,
   bit for bit; one torch.profiler session over a replay of the headline's graph
   and of BENCH_INT8_ROW's names greedy, merge and sample_paf once each,
   and one int8_conv_kernel per int8 layer and one quantize pass per float
   input, and five of each decoder kernel in five headline replays. Then
   `python -m openpose_plus_tpu_torch bench` in a fresh process with
   BENCH_HEADLINE_ONLY prints the headline line with bench.py's keys, and
   the `train` mode, the `stream` mode (3000x4000 photos, 16 of them) and
   the stream's `--loader-only` run once each at their defaults, each
   value finite. A `bench` line: every row's fps, ms, MFU, HBM share,
   spread, FLOPs an image and plain check, the trace, the modes' lines
   (the streams with their host scopes' ms a call and the plane a photo
   decodes to: 1/8, 375x500, since the loader decodes DCT-scaled) and the
   phase's seconds. The phase runs in a fresh process (`--bench-phase`):
   its profiler session is that process's first.
17. The accuracy studies (`studies_phase`; `ap_bench`, `ap_oracle`,
   `tune_fragment_merge`, `analyze_oracle_misses`, `synthetic_e2e`), in a
   temporary `.smoke_bank_studies_*` directory of the checkout, each
   decode and evaluation counted (greedy, merge and sample_paf must
   launch at least once a batch, fused_sepconv never; a flip-TTA or
   scale-search evaluation captures its graph at the first batch and
   replays it after: CAPTURE_WARMUP + 1 launches of each a decode of one
   call): (a) `ap_bench
   --oracle`'s rows "oracle@368#s4", "oracle@368#sig4", "oracle" and
   "oracle#s4" on the 96-image val banks ("perfect" AP 1.0, each map
   variant within ORACLE_AP_TOL of ap_benchmark.json, and the card within
   ORACLE_CPU_TOL of the CPU on the first ORACLE_CPU_IMAGES images); (b)
   the fragment-merge sweep on the serving tier's 256-image train bank,
   rels 0, 0.3 and 0.5 within ORACLE_AP_TOL of STUDIES_SWEEP_RECORD; (c)
   the miss audit at the serving tier with and without fragment-merge
   within STUDIES_AUDIT_TOL people of STUDIES_AUDIT_RECORD, its counts on
   the first ORACLE_CPU_IMAGES images equal on the card and the CPU; (d)
   MobileNet-thin at full width: `run_curve` to STUDIES_CURVE at the
   serving tier (both snapshots under the JAX names and different, a
   second call with --force evaluates without training), `run_model
   (ms_study=True)` at the serving tier (ms15 and msdd, no msup) and
   `run_large` (the seven val_large variants, msup's 2.0 scale included),
   STUDIES_STEPS steps each, every row finite; (e) `ap_bench --table` on
   that directory and (f) `synthetic_e2e --steps 50 --n-images 16` in
   fresh processes. A `studies` line per probe, the sweep, each audit,
   each model study and the processes, every figure beside its record.
   `--studies-phase` builds the kernels and runs this phase alone.

Each phase logs its seconds as it ends, and a `phase_seconds` line sums
them before the results. The line before the last is the nvidia-smi
name/power-limit line, the one before it the per-kernel JSON record
(`kernels`); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`python3 chip_smoke.py --decoder-kernels-of DIR` instead builds the kernels
of the port in DIR (a checkout of this repository, for instance an older
commit's unpacked with `git archive`), prints their ptxas frames, checks
greedy and merge bit-equal to their plain versions on phase 6's random sets
and times them there; it prints no result line. Two trees compared in one
run on one card: DIR=old, DIR=., DIR=., DIR=old. `--int8-kernels-of DIR`
does the same for the int8 kernels: it builds the port in DIR, runs phase
11's two int8 engines there, and checks and times DIR's `int8_conv` at each
shape group of their forwards (under each of DIR's tile plans too) and its
`quantize_act` at each quantize shape (`int8_kernels` lines, the layers and
passes of a forward summed). `--mma-ceiling` only builds and runs
`probes/mma_ceiling.cu`: the card's `mma.sync` rates from registers (s8
m16n8k32, bf16 m16n8k16) and `wgmma` rates from shared memory (s8
m64n128k32, bf16 m64n128k16). `--int8-phases` only builds
csrc/int8_conv.cu with its phase clocks and reads where a block of the
int8 conv spends its time at the forwards' main shapes (`int8_phases`).
`--bench-phase` only builds the kernels and runs phase 15,
`--studies-phase` phase 17, `--spatial-phase` phase 14's spatial axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

BATCH = 8
TIMED_ITERS = 20
WARMUP = 3
PROFILED_CALLS = 5
PROBE_HW = (46, 82)           # scripts/profile_pallas_dw.py B, H, W
SCALES = (0.5, 1.0, 1.5)      # infer_multiscale's default scale search
# The chain estimate of greedy and merge: their dependent steps on these
# inputs, each costed at one on-chip round trip of ROUND_TRIP_CYCLES (a
# shared-memory load to its use; a warp vote, shuffle or redux is of the
# same order) at the card's highest SM clock (nvidia-smi clocks.max.sm). A
# merge step is one round trip (the ballot that decides it), a greedy round
# two (its max, then its lowest index). A floor a serial kernel can
# approach, not a prediction: a step does more than that.
ROUND_TRIP_CYCLES = 30
FORWARD32_REL_TOL = 1e-4      # float32 forward, card vs CPU, of the map scale
# phase 6's bf16 kernels against their plain versions on the card
# (kernel_inputs.bf16_mismatch): fused_sepconv within 2 units, dw3x3_relu
# within 1, and each with at least this share of identical elements
SEPCONV_MAX_UNITS = 2.0
MIN_IDENTICAL = 0.98
ZOO = ("vgg19", "vggtiny", "hao28")
# phase 7c: the conv epilogue on each float engine the port serves: label:
# (model, fused_inference, input (H, W), batches, its launches in one infer)
BIAS_ACT_CALLS = {
    "body25": ("body25", False, (368, 656), (BATCH,), 108),  # batch cell
    "vgg19": ("vgg19", False, (368, 656), (BATCH,), 80),      # batch cell
    # the fidelity (batch 8) and live (batch 1) cells' engine: its stem,
    # dw1-dw4's two halves and 12 stage projections
    "mobilenet_thin-fused": ("mobilenet_thin", True, (368, 432),
                             (BATCH, 1), 21),
    # phase 4's unfused engine
    "mobilenet_thin": ("mobilenet_thin", False, (368, 432), (BATCH, 1), 103),
}
L2_BYTES = 50e6               # H100 L2; timed inputs rotate past twice it
# GT-map oracle AP on the card against ap_benchmark.json "oracle@368" (the
# JAX package's record, rounded to 4 digits): ulp-level reorders of
# near-equal peaks in crowded scenes may change a top-K; card vs CPU on the
# first ORACLE_CPU_IMAGES images
ORACLE_AP_TOL = 0.005
ORACLE_CPU_TOL = 1e-3
ORACLE_CPU_IMAGES = 16
EVAL_IMAGES = 16              # evaluate_engine's bank, serving size
EVAL_TIMED_IMAGES = 96        # the timed run: the studies' serving val bank
# its AP, card vs CPU: both bf16 engines, whose maps differ by bf16 rounding
# (cuDNN vs oneDNN), which can move a few random-weight skeletons
EVAL_CPU_TOL = 2e-2
# phase 10, training: a seeded bank of TRAIN_IMAGES serving-size images,
# TRAIN_STEPS steps of train_loop with a checkpoint every TRAIN_CKPT, then
# a resume to TRAIN_RESUME_TO; card vs CPU on TRAIN_CPU_BATCH images
TRAIN_IMAGES = 32
TRAIN_STEPS = 300
TRAIN_CKPT = 150
TRAIN_RESUME_TO = 310
TRAIN_LR = 1e-3
TRAIN_CPU_BATCH = 2
# card vs CPU, both bf16: the loss relative; each gradient leaf's relative
# L2 and that of all leaves together. bf16 rounds every activation to 8
# bits of mantissa, and the card's and the CPU's roundings differ
# independently; on the CPU one step's bf16 gradients at this width lie
# 1.2% (median leaf) to 8.5% (worst leaf), 0.4% overall, from the float32
# ones (tests/test_torch_train.py::test_bf16_step_gradients_near_float32)
TRAIN_LOSS_RTOL = 2e-2
TRAIN_LEAF_RTOL = 0.15
TRAIN_ALL_RTOL = 5e-2
TRAIN_FALL = 0.7              # mean of the last 50 losses / first 10
TRAIN_PIPELINE_BATCHES = 40   # TrainPipeline alone, after 5 of warm-up
TRAIN_SPREAD_STEPS = 6        # graph against eager: steps of each run
TRAIN_TRACE_GAP_S = 0.25      # an eager step's own gaps stay below half
# phase 11, int8: the two full-width engines; their conf maps against the
# bf16 engine's on the same weights (tests/test_quant.py's criterion); the
# kernel forward against the plain-routed one (equal int8 outputs, so only
# cuDNN's depthwise and float32 heads could move the maps)
INT8_MODELS = ("vgg19", "mobilenet_thin")
INT8_COSINE = 0.98
INT8_PLAIN_TOL = 1e-6
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
# phase 12, the deploy path: the compiled calls traced TRACE_GAP_S apart;
# run_frames' equality check over DEPLOY_FRAMES frames of mixed sizes; the
# CLI's JPEGs of DEPLOY_FRAME_HW
TRACE_GAP_S = 0.05
DEPLOY_FRAMES = 29
DEPLOY_FRAME_HW = (480, 640)
# phase 13, the file stream: the seeded files and the noisy scenes held to
# the oracle
STREAM_JPEGS = 24
STREAM_PNGS = 4
STREAM_SCENE_NOISE = 0.15
STREAM_NOISY_SEEDS = (0, 1)
HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's yardstick (harness.device_time, harness.cost), found as
# benchmark/run.py finds it; appended, so that it shadows no module of the
# repository (its `tests` among them) in a process that imports this file
sys.path.append(os.path.join(HERE, "benchmark"))
from harness.cost import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                          HBM_BYTES, sepconv_bound)
from harness.device_time import graph_ms  # noqa: E402
DECODER_KERNELS = ("greedy_assign_kernel", "assemble_kernel")
# csrc/int8_conv.cu: the conv (one instance per tile plan of
# ops/cuda/int8_conv.py `PLANS` and output type) and the quantize passes
INT8_KERNELS = ("int8_conv_kernel", "quantize_kernel", "quantize_pad_kernel")
# --int8-phases: int8_conv shapes of phase 11's forwards (batch 8, VGG19
# but the last), as (B, H, W, Cin, Cout, kernel, int8 output)
INT8_PHASE_SHAPES = ((8, 46, 54, 128, 128, 7, True),
                     (8, 46, 54, 128, 128, 1, True),
                     (8, 46, 54, 128, 128, 1, False),
                     (8, 92, 108, 256, 256, 3, True),
                     (8, 184, 216, 64, 128, 3, True),
                     (8, 368, 432, 64, 64, 3, True))
# top-level packages the port must never load: JAX and the JAX package
FOREIGN_PACKAGES = ("jax", "jaxlib", "flax", "openpose_plus_tpu")
# phase 14, the distributed layer: PARALLEL_RANKS gloo ranks sharing the
# card, PARALLEL_STEPS checked steps of each strategy on seeded global
# batches of BATCH with PARALLEL_PEOPLE people an image
PARALLEL_RANKS = 2
PARALLEL_STEPS = 3
PARALLEL_PEOPLE = 4
PARALLEL_TIMEOUT_S = 300
PARALLEL_EVAL_TOL = 1e-3
# phase 14's spatial axis: the same ranks as a 1 data x PARALLEL_RANKS
# spatial mesh, PARALLEL_STEPS sync-sgd steps of MobileNet-thin and
# SPATIAL_VGG_STEPS of VGG19 (its 7x7 refine convs' 3-row halos), both at
# 368x432, bf16, Adam at TRAIN_LR, a global batch of BATCH
SPATIAL_MODELS = ("mobilenet_thin", "vgg19")
SPATIAL_VGG_STEPS = 1
# phase 15, the bench: the int8 row whose replay is traced; the headline
# line's keys (bench.py's)
BENCH_INT8_ROW = "e2e_fps_vgg19_int8_368x656_bs8"
BENCH_SLOPE_TOL = 0.02        # the headline's slope against its graph_ms
BENCH_HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline", "mfu_pct",
                       "hbm_pct_est", "spread_pct"]
# phase 17, the accuracy studies: the oracle probes (tier, out_stride,
# label_sigma) against ap_benchmark.json, the fragment-merge sweep on the
# serving tier's train bank against docs/ARCHITECTURE.md:411-412, the miss
# audit against BASELINE.md:293-299,311-312 (within STUDIES_AUDIT_TOL
# people), and the model studies at full width with STUDIES_STEPS steps
STUDIES_PROBES = (("serving", 4, None), ("serving", 8, 4.0),
                  ("small", 8, None), ("small", 4, None))
STUDIES_MAP_VARIANTS = ("base", "fidelity", "fidelity_fm")
STUDIES_SWEEP_RECORD = {0.0: 0.5686, 0.3: 0.6268, 0.5: 0.6569}
STUDIES_AUDIT_RECORD = {False: {"misses": 55, "scattered": 42,
                                "disconnected": 43},
                        True: {"misses": 21}}
STUDIES_AUDIT_RECOVERY = 0.66     # printed beside the card's, not a gate
STUDIES_AUDIT_TOL = 1
STUDIES_STEPS = 40
STUDIES_CURVE = (20, 40)
SOURCES = {   # kernel: (source, the TPU kernel it replaces)
    "greedy_assign": ("openpose_plus_tpu_torch/csrc/greedy.cu",
                      "openpose_plus_tpu/ops/pallas/greedy.py:53"),
    "assemble": ("openpose_plus_tpu_torch/csrc/merge.cu",
                 "openpose_plus_tpu/ops/pallas/merge.py:151"),
    "fused_sepconv": ("openpose_plus_tpu_torch/csrc/sepconv.cu",
                      "openpose_plus_tpu/ops/pallas/sepconv.py:59"),
    "sample_paf": ("openpose_plus_tpu_torch/csrc/paf_sample.cu",
                   "openpose_plus_tpu/ops/pallas/paf_sample.py:70"),
    "dw3x3_relu": ("openpose_plus_tpu_torch/csrc/sepconv.cu",
                   "scripts/profile_pallas_dw.py:49"),
    "copy_bias": ("openpose_plus_tpu_torch/csrc/sepconv.cu",
                  "scripts/profile_pallas_dw.py:49"),
    # port kernels with no Pallas counterpart
    "int8_conv": ("openpose_plus_tpu_torch/csrc/int8_conv.cu",
                  "XLA int8 conv, openpose_plus_tpu/models/common.py:129 "
                  "(_int8_conv); no Pallas kernel"),
    "quantize_act": ("openpose_plus_tpu_torch/csrc/int8_conv.cu",
                     "XLA quantize_act, openpose_plus_tpu/models/"
                     "common.py:84 (_int8_conv's float input); no Pallas "
                     "kernel"),
    "find_peaks": ("openpose_plus_tpu_torch/csrc/peaks.cu",
                   "lax NMS and top-K, openpose_plus_tpu/postproc/nms.py "
                   "(find_peaks); no Pallas kernel"),
    "bias_act": ("openpose_plus_tpu_torch/csrc/bias_act.cu",
                 "XLA-fused conv bias and activation, openpose_plus_tpu/"
                 "models/common.py ConvRelu; no Pallas kernel"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def foreign_modules(modules=None) -> list[str]:
    """The loaded modules (`sys.modules` unless given) of JAX or of the JAX
    package `openpose_plus_tpu`; the port's own `openpose_plus_tpu_torch`
    is not one of them."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FOREIGN_PACKAGES)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    """The card's highest SM clock in MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def ptxas_frames(log_text: str, kernels=DECODER_KERNELS) -> dict:
    """{mangled name: (stack frame, spill store, spill load bytes)} of every
    compiled instance whose name holds one of `kernels`, from nvcc's
    -Xptxas=-v report (nvcc.log beside the built library)."""
    frames, name = {}, None
    for line in log_text.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1].strip()
        elif "bytes stack frame" in line and name is not None:
            if any(k in name for k in kernels):
                frames[name] = tuple(int(w) for w in line.replace(
                    ",", " ").split() if w.isdigit())[:3]
            name = None
    return frames


def record_calls(module, name: str, fn) -> list:
    """fn() with module.<name> recording its calls' (args, kwargs)."""
    calls, original = [], getattr(module, name)

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)
    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, original)
    return calls


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
    """The largest |out - ref| of the float outputs (a record: the checks
    are `assert_bits_equal` and `bf16_mismatch`); NaN if any is NaN."""
    errs = [float((o.cpu() - r.cpu()).abs().max())
            for o, r in zip(outs, refs, strict=True)
            if o.dtype.is_floating_point]
    return math.nan if any(map(math.isnan, errs)) else max(errs, default=0.0)


def assert_equal(torch, what: str, outs, refs) -> None:
    for i, (o, r) in enumerate(zip(outs, refs)):
        if not torch.equal(o.cpu(), r.cpu()):
            raise AssertionError(f"{what}: output {i} differs")


def assert_bits_equal(torch, what: str, outs, refs) -> None:
    """Equal outputs, every field of the same dtype and shape, floats
    compared as their bits (-0.0 is not 0.0, a NaN only its own bits)."""
    as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for i, (o, r) in enumerate(zip(outs, refs, strict=True)):
        o, r = o.cpu(), r.cpu()
        if o.dtype != r.dtype or o.shape != r.shape:
            raise AssertionError(f"{what}: output {i} is {o.dtype} "
                                 f"{tuple(o.shape)}, expected {r.dtype} "
                                 f"{tuple(r.shape)}")
        if o.dtype.is_floating_point:
            o, r = o.view(as_int[o.element_size()]), r.view(
                as_int[r.element_size()])
        if not torch.equal(o, r):
            raise AssertionError(f"{what}: output {i} differs")


def load_test_helper(name: str):
    """tests/<name>.py (numpy and the skeleton only) by path: another
    installed package named `tests` may shadow the repository's test
    directory."""
    import importlib.util
    path = os.path.join(HERE, "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# not harness/weights.scale_heads: that one centres the maps through the
# benchmark's reference network first; this one scales the port's own maps
def scale_heads(torch, engine, images, gains=None) -> dict:
    """Scale the last stage's prediction kernels so the served decode finds
    humans on random weights and images.

    The seeded random init gives final maps of ~5e-3, below the peak
    threshold: the decoder would find no peaks and the kernels would group
    nothing. The heads' 1x1 convs have zero biases, so scaling their
    kernels scales the maps exactly; the gains bring max |conf| to 0.7 and
    max |paf| to 5, as in tests/test_torch_engine.py. Given `gains`, applies
    those instead (the same weights in a second engine)."""
    stages = engine.model.stages
    n = engine.config.model.n_stages
    if gains is None:
        conf, paf = engine.forward(images)
        gains = {"conf": 0.7 / float(conf.abs().max()),
                 "paf": 5.0 / float(paf.abs().max())}
    for key in ("conf", "paf"):
        with torch.no_grad():
            getattr(stages, f"stage{n}_{key}").Conv_0.weight.mul_(gains[key])
    return gains


def fused_shapes(common, model) -> dict:
    """(C, F) -> number of the model's SepConvRelu layers that fuse."""
    shapes: dict = {}
    for m in model.modules():
        if isinstance(m, common.SepConvRelu) and m.fused:
            key = (m.dw_weight.shape[0], m.pw_weight.shape[0])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def bound(nbytes, op_seconds) -> tuple[float, str]:
    """The least time (ms) the card could take for a function and what
    bounds it: the bytes it must move (each input read once, each output
    written once) over the HBM rate, against `op_seconds`, the time of its
    operations at the peak rate of their type (the benchmark's peaks,
    harness/cost.py)."""
    t_bytes = nbytes / HBM_BYTES * 1e3
    t_ops = op_seconds * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_sepconv(torch, np, inputs, common, sepconv, b, h, w, c, f,
                 dev) -> dict:
    """One sepconv shape on seeded inputs: the kernel (weights already
    bf16), its plain version and the unfused port layer (cuDNN depthwise +
    pointwise pair); the kernel checked against its plain version on the
    card (SEPCONV_MAX_UNITS, MIN_IDENTICAL), its max_abs_err, the bound
    (harness/cost.py's `sepconv_bound`) and the kernel's and the pair's
    device time as a share of it."""
    x, *args = inputs.sepconv_inputs(np.random.default_rng(c * f), b, h, w,
                                     c, f)
    x = torch.from_numpy(x).to(dev, torch.bfloat16)
    weights = [torch.from_numpy(t).to(dev, torch.bfloat16) for t in args]
    pair = common.SepConvRelu(c, f)
    for name, t in zip(("dw_weight", "dw_bias", "pw_weight", "pw_bias"),
                       map(torch.from_numpy, args)):
        getattr(pair, name).data = t.permute(3, 2, 0, 1).contiguous() \
            if t.dim() == 4 else t
    pair.to(dev)
    x_nchw = x.permute(0, 3, 1, 2)        # channels-last, as in the model
    calls = {
        "kernel": lambda: sepconv.fused_sepconv(x, *weights),
        "plain": lambda: sepconv.fused_sepconv_plain(x, *weights),
        "pair": lambda: pair(x_nchw),
    }
    with torch.no_grad():
        y, ref = calls["kernel"](), calls["plain"]()
        units, same = inputs.bf16_mismatch(
            y.float().cpu().numpy(), ref.float().cpu().numpy(),
            weights[3].float().abs().cpu().numpy())     # the pointwise bias
        if not (units <= SEPCONV_MAX_UNITS and same >= MIN_IDENTICAL):
            raise AssertionError(
                f"fused_sepconv {tuple(x.shape)} -> {f} vs plain (cuda): "
                f"{units} units, {same} identical")
        out = {"max_abs_err": max_abs_err(torch, [y], [ref]),
               "units": units, "identical": same}
        out.update({f"{key}_ms": median_ms(torch, fn)
                    for key, fn in calls.items()})
    out.update({f"{key}_device_ms": graph_ms(fn, dev)
                for key, fn in calls.items()})
    out["bound_ms"] = sepconv_bound(b, h, w, c, f) * 1e3
    bytes_ms, _ = bound(io_bytes(x, *weights, y), 0.0)
    out["bound_by"] = ("bytes" if bytes_ms >= out["bound_ms"]
                       else "operations")
    out["pct_of_bound"] = 100.0 * out["bound_ms"] / out["kernel_device_ms"]
    out["pair_pct_of_bound"] = (100.0 * out["bound_ms"]
                                / out["pair_device_ms"])
    return out


def io_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def random_decoder_sets(torch, inputs, np, dev) -> dict:
    """Phase 6's random inputs of greedy and merge, batch 8 on the card,
    from their own generator (the same in every run and tree): limb scores
    with ties, and connection sets with a valid prefix of random length
    (about half the slots valid), at K=16 and K=32."""
    rng = np.random.default_rng(4)
    sets = {}
    for k in (16, 32):
        scores = inputs.limb_scores(rng, BATCH, k)
        conns = inputs.connections(rng, BATCH, k)
        peak_score = inputs.peak_scores(rng, BATCH, k)
        sets["random", k] = (torch.from_numpy(scores).to(dev),
                             [torch.from_numpy(x).to(dev) for x in conns],
                             torch.from_numpy(peak_score).to(dev))
    return sets


def decoder_kernel_times(torch, greedy, merge, scores, conns, peak_score, m,
                         clock_mhz, plain=False) -> dict:
    """greedy_assign on `scores` (B, 19, K, K) and assemble on `conns` +
    `peak_score` at table size m, both checked bit-equal to their plain
    versions on the card: event and device ms (and with `plain`, their
    plain versions' event ms), the bound (bytes over the HBM rate against a
    max and a compare a remaining candidate a round, or 2 m operations a valid
    connection, over the f32 rate), and the chain estimate: the dependent
    steps these inputs need (greedy: the most rounds of any image and limb,
    its accepted connections plus the round that finds none, at most K;
    merge: the most valid connections of any image) at ROUND_TRIP_CYCLES
    each (two a greedy round) and the highest SM clock."""
    k = scores.shape[-1]
    calls = {
        "greedy_assign": (lambda: greedy.greedy_assign(scores, k),
                          lambda: greedy.greedy_assign_plain(scores, k)),
        "assemble": (lambda: merge.assemble(*conns, peak_score, k, m),
                     lambda: merge.assemble_plain(*conns, peak_score, k, m)),
    }

    out = {}
    for name, (fn, slow) in calls.items():
        assert_bits_equal(torch, f"{name} K={k} vs plain (cuda)", fn(),
                          slow())
        t = out[name] = {"ms": median_ms(torch, fn),
                         "device_ms": graph_ms(fn, scores.device)}
        if plain:
            t["plain_ms"] = median_ms(torch, slow)
    accepted = greedy.greedy_assign(scores, k)
    rounds = torch.clamp(accepted[3].sum(-1) + 1, max=k)      # (B, 19)
    steps = conns[3].sum(dim=(1, 2))                          # (B,)
    cycle_ms = 1e-3 / clock_mhz
    out["greedy_assign"].update(zip(("bound_ms", "bound_by"), bound(
        io_bytes(scores, *accepted),
        2 * int(rounds.sum()) * k * k / F32_FLOPS), strict=True))
    out["greedy_assign"].update(
        rounds=int(rounds.max()), rounds_total=int(rounds.sum()),
        chain_ms=int(rounds.max()) * 2 * ROUND_TRIP_CYCLES * cycle_ms)
    out["assemble"].update(zip(("bound_ms", "bound_by"), bound(
        io_bytes(*conns, peak_score, *merge.assemble(*conns, peak_score, k,
                                                     m)),
        int(steps.sum()) * m * 2 / F32_FLOPS), strict=True))
    out["assemble"].update(
        steps=int(steps.max()), steps_total=int(steps.sum()),
        chain_ms=int(steps.max()) * ROUND_TRIP_CYCLES * cycle_ms)
    return out


def time_probe(torch, np, inputs, dw_probe, c, dev) -> dict:
    """The probe at one C, on inputs drawn as scripts/profile_pallas_dw.py's
    `run` draws them (x (8, 46, 82, C) and dwk (9, C), bf16): its two
    kernels, their plain versions and the library call computing the same
    function (never called by the port): cuDNN's depthwise conv
    (channels-last bf16) + ReLU for dw3x3_relu, `x + b` for copy_bias.
    Each kernel checked against its plain version on the card (dw3x3_relu
    within 1 bf16 unit, copy_bias bit-equal) in one launch; event and
    device ms, the kernels' max_abs_err, the bounds, shares."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((BATCH, *PROBE_HW, c)).astype(
        np.float32)).to(dev, torch.bfloat16)
    dwk = torch.from_numpy((rng.standard_normal((9, c)) * 0.1).astype(
        np.float32)).to(dev, torch.bfloat16)
    w_dw = dwk.t().reshape(c, 1, 3, 3).contiguous()
    x_nchw = x.permute(0, 3, 1, 2)        # NCHW channels-last view
    calls = {
        "dw": lambda: dw_probe.dw3x3_relu(x, dwk),
        "dw_plain": lambda: dw_probe.dw3x3_relu_plain(x, dwk),
        "dw_library": lambda: torch.relu(F.conv2d(x_nchw, w_dw, padding=1,
                                                  groups=c)),
        "copy": lambda: dw_probe.copy_bias(x, dwk),
        "copy_plain": lambda: dw_probe.copy_bias_plain(x, dwk),
        "copy_library": lambda: x + dwk[0],
    }
    out = {"shape": list(x.shape)}
    for key, name in (("dw", "dw3x3_relu"), ("copy", "copy_bias")):
        before = getattr(dw_probe, f"{name}_launches")
        y = calls[key]()
        out[f"{key}_launches"] = getattr(dw_probe, f"{name}_launches") - before
        ref = calls[f"{key}_plain"]()
        what = f"{name} C={c} vs plain (cuda)"
        if key == "copy":
            assert_bits_equal(torch, what, [y], [ref])
        else:
            units, same = inputs.bf16_mismatch(y.float().cpu().numpy(),
                                               ref.float().cpu().numpy())
            if not (units <= 1.0 and same >= MIN_IDENTICAL):
                raise AssertionError(f"{what}: {units} units, {same} "
                                     "identical")
        if out[f"{key}_launches"] != 1:
            raise AssertionError(f"{what}: {out[f'{key}_launches']} "
                                 "launches, expected 1")
        out[f"{key}_max_abs_err"] = max_abs_err(torch, [y], [ref])
    for key, fn in calls.items():
        out[f"{key}_ms"] = median_ms(torch, fn)
        out[f"{key}_device_ms"] = graph_ms(fn, dev)
    out["dw_bound_ms"], out["dw_bound_by"] = bound(
        io_bytes(x, dwk, x), 18 * x.numel() / F32_FLOPS)
    out["copy_bound_ms"], out["copy_bound_by"] = bound(
        io_bytes(x, dwk[0], x), x.numel() / F32_FLOPS)
    for key in ("dw", "copy"):
        out[f"{key}_pct_of_bound"] = (100.0 * out[f"{key}_bound_ms"]
                                      / out[f"{key}_device_ms"])
    out["dw_over_copy"] = out["dw_device_ms"] / out["copy_device_ms"]
    return out


def one_call_gather(torch, paf, sy, sx, chans):
    """sample_paf as one advanced-index gather (the library call it is
    timed against; never called by the port): (B, L, S, K, K, 2)."""
    b = paf.shape[0]
    bi = torch.arange(b, device=paf.device).view(b, 1, 1, 1, 1, 1)
    ys, xs = sy.long()[..., None], sx.long()[..., None]
    ch = chans.view(1, -1, 1, 1, 1, 2)
    return lambda: paf[bi, ys, xs, ch]


def sample_paf_bytes(torch, paf, sy, sx, chans) -> int:
    """The bytes sample_paf must move on these inputs: the distinct PAF
    elements the samples touch (a gather reads no other), the coordinates,
    the two outputs."""
    b, h, w, _ = paf.shape
    n_limbs = sy.shape[1]
    limb = torch.arange(n_limbs, device=sy.device).view(1, -1, 1, 1, 1)
    img = torch.arange(b, device=sy.device).view(-1, 1, 1, 1, 1)
    key = ((img * h + sy.long()) * w + sx.long()) * n_limbs + limb
    touched = int(torch.unique(key).numel()) * 2 * paf.element_size()
    return touched + io_bytes(sy, sx) + 2 * sy.numel() * paf.element_size()


def peaks_times(torch, nms, peaks, conf, post) -> dict:
    """find_peaks at the `post` decode's shape on `conf` (the head-scaled
    maps): the kernels' event and device time, the plain version's,
    `torch.topk` on the plain version's masked plane (the library call;
    never called by the port: it picks the same K, its tie order
    unspecified), the kernels checked bit-equal to the plain version on
    the card in one launch, their max_abs_err, the byte bound (the 18 part
    maps read once, the outputs written once; device times replay one
    input, so maps under the 50 MB L2 sit in it: `maps_fit_l2`), and the
    peaks a row on these maps."""
    smoothed = nms.upsample_smooth(conf.float(), post.upsample_factor,
                                   post.smooth_sigma)
    threshold, k = post.peak_threshold, post.max_peaks
    kern = lambda: peaks.find_peaks(smoothed, threshold, k)   # noqa: E731
    plain = lambda: nms.find_peaks_plain(smoothed, threshold, k)  # noqa
    (args, _), = record_calls(nms, "_topk_stable", plain)
    masked = args[0]
    library = lambda: torch.topk(masked, k, dim=-1)   # noqa: E731
    before = peaks.launches
    got = kern()
    torch.cuda.synchronize()
    rows = peaks.candidates.flatten().float().cpu()
    b, h, w = smoothed.shape[:3]
    maps = b * h * w * 18 * 4
    ref = [getattr(plain(), f) for f in peaks.FIELDS]
    what = f"find_peaks {b}x{h}x{w} K={k} vs plain (cuda)"
    assert_bits_equal(torch, what, got, ref)
    out = {"shape": [b, h, w], "k": k, "launches": peaks.launches - before,
           "peaks_a_row_max": int(rows.max()),
           "peaks_a_row_median": float(rows.median()),
           "maps_mb": maps / 1e6, "maps_fit_l2": maps <= 50e6,
           "max_abs_err": max_abs_err(torch, got, ref)}
    if out["launches"] != 1:
        raise AssertionError(f"{what}: {out['launches']} launches")
    for key, fn in (("", kern), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = median_ms(torch, fn)
        out[f"{key}device_ms"] = graph_ms(fn, smoothed.device)
    # the outputs: y, x, score, refined y and x of 4 bytes, valid of 1
    out["bound_ms"], out["bound_by"] = bound(maps + b * 18 * k * 21, 0.0)
    out["pct_of_bound"] = 100.0 * out["bound_ms"] / out["device_ms"]
    return out


def check_map_scale(torch, what, outs, refs, rel_tol) -> list:
    """max |out - ref| <= rel_tol * max |ref| per map; returns the ratios."""
    ratios = []
    for o, r in zip(outs, refs):
        scale = float(r.abs().max())
        err = float((o.float() - r.float()).abs().max())
        if not err <= rel_tol * scale:
            raise AssertionError(f"{what}: max_abs_err {err} > {rel_tol} x "
                                 f"{scale}")
        ratios.append(err / scale)
    return ratios


def check_forward32(torch, get_model, engine, images, dev, what) -> dict:
    """The engine's weights in a float32 model on the card and on the CPU,
    one image at full width (TF32 off for this comparison only): final maps
    within FORWARD32_REL_TOL of the CPU's map scale. Logs the bf16 engine's
    distance from the float32 CPU maps too; returns the errors."""
    cfg32 = dataclasses.replace(engine.config.model, compute_dtype="float32")
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
    errs = {}
    for key in ("conf", "paf"):
        ref = o_cpu[key][-1]
        scale = float(ref.abs().max())
        err32 = float((o_dev[key][-1].cpu() - ref).abs().max())
        err16 = float((o_bf16[key][-1].float().cpu() - ref).abs().max())
        log(f"{what}forward {key}: |ref|max {scale:.4g}, float32 card-vs-cpu "
            f"max_abs_err {err32:.3g}, bfloat16 card-vs-float32 cpu "
            f"{err16:.3g}")
        # float32, another accumulation order over ~20-40 conv layers
        if not err32 <= FORWARD32_REL_TOL * scale:
            raise AssertionError(f"{what}float32 forward {key} differs: "
                                 f"{err32}")
        errs[key] = err32 / scale
    return errs


def launches_during(torch, counted, fn):
    """fn() with every kernel count set to 0 just before it; returns
    (fn's result, {kernel: launches in the call})."""
    torch.cuda.synchronize()
    for module in counted.values():
        module.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: module.launches for name, module in counted.items()}


def check_launches(what, launches, at_least, fused_sepconv) -> None:
    for name in ("greedy_assign", "assemble", "sample_paf"):
        if launches[name] < at_least:
            raise AssertionError(f"{what}: {name} launched {launches[name]}"
                                 f" times, expected >= {at_least}")
    if launches["fused_sepconv"] != fused_sepconv:
        raise AssertionError(f"{what}: fused_sepconv launched "
                             f"{launches['fused_sepconv']} times, expected "
                             f"{fused_sepconv}")


def graph_bytes(torch, fn):
    """fn() (a call that captures a CUDA graph) and the device memory the
    graph keeps: the memory reserved after fn() less that before it, each
    read after `empty_cache` (a live graph's private pool stays
    reserved). Returns (fn's result, bytes)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, torch.cuda.memory_reserved() - before


def replayed_path(torch, counted, what, call, eager, at_least,
                  fused_sepconv) -> dict:
    """One path that a CUDA engine captures at its first call (flip-TTA, a
    scale search): the module function's eager call launches the kernels
    (`check_launches`); the engine's first call launches CAPTURE_WARMUP + 1
    times as many from Python (its warm-ups, then the capture, which
    records them) and keeps its graph's memory; the next call is a replay:
    no launch from Python. Both calls' HumanBatches equal the eager one bit
    for bit. Returns the replay's HumanBatch, the eager launches and the
    graph's bytes."""
    from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP

    with torch.inference_mode():
        ref, n = launches_during(torch, counted, eager)
    check_launches(f"{what}, eager", n, at_least, fused_sepconv)
    (first, n_first), nbytes = graph_bytes(
        torch, lambda: launches_during(torch, counted, call))
    k = CAPTURE_WARMUP + 1
    if n_first != {name: k * v for name, v in n.items()}:
        raise AssertionError(f"{what}: the capturing call launched "
                             f"{n_first}, expected {k} x the eager call's "
                             f"{n}")
    out, n_replay = launches_during(torch, counted, call)
    if any(n_replay.values()):
        raise AssertionError(f"{what}: the replay launched {n_replay} from "
                             "Python")
    assert_batches_equal(torch, f"{what}: capturing call vs eager", first,
                         ref)
    assert_batches_equal(torch, f"{what}: replay vs eager", out, ref)
    return {"out": out, "eager_launches": n, "graph_bytes": nbytes}


def assert_batches_equal(torch, what, a, b) -> None:
    for f in dataclasses.fields(a):
        if not torch.equal(getattr(a, f.name), getattr(b, f.name)):
            raise AssertionError(f"{what}: HumanBatch.{f.name} differs")


def check_humans(torch, what, out, rows, dev) -> None:
    """HumanBatch of (BATCH, rows) on dev, finite, valid rows first by
    descending score."""
    for f in dataclasses.fields(out):
        t = getattr(out, f.name)
        if tuple(t.shape[:2]) != (BATCH, rows) or t.device != dev:
            raise AssertionError(f"{what}: HumanBatch.{f.name} "
                                 f"{tuple(t.shape)} on {t.device}")
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: HumanBatch.{f.name} not finite")
    first = (torch.arange(rows, device=dev)[None]
             < out.num_humans[:, None])
    both = out.valid[:, 1:] & out.valid[:, :-1]
    if not (torch.equal(out.valid, first) and bool(
            (out.score[:, :-1] >= out.score[:, 1:])[both].all())):
        raise AssertionError(f"{what}: rows not compacted by score")


def compare_decodes(torch, what, on_dev, on_cpu, score_tol) -> None:
    """Masks equal; coords and part scores within 1e-5; mean scores within
    score_tol (float64 contractions in another order: ~1 ulp, which at
    fidelity()'s flat peak tops can move a PAF sample)."""
    for name in ("valid", "n_parts", "part_valid"):
        assert_equal(torch, f"{what} {name} card vs cpu",
                     [getattr(on_dev, name)], [getattr(on_cpu, name)])
    for name, tol in (("coords", 1e-5), ("part_scores", 1e-5),
                      ("score", score_tol)):
        err = float((getattr(on_dev, name).cpu()
                     - getattr(on_cpu, name)).abs().max())
        if not err <= tol:
            raise AssertionError(f"{what} {name} card vs cpu: {err} > {tol}")


def three_people(torch, np, scenes, mc):
    """phase 4's scene: three standing people, BATCH copies (CPU)."""
    people = [scenes.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                     0.93 + 0.1 * i) for i in range(3)]
    conf, paf = scenes.make_maps(people, mc.hout, mc.wout)
    return (torch.from_numpy(np.stack([conf] * BATCH)),
            torch.from_numpy(np.stack([paf] * BATCH)))


def truncated_people(torch, np, scenes, mc):
    """Two standing people without the neck and ears, BATCH copies (CPU):
    head, arms and legs are five disjoint fragments for the limb graph
    (tests/test_torch_quality.py's scene)."""
    people = []
    for cx, cy, s in ((13.37, 21.43, 1.0), (39.61, 22.1, 1.1)):
        person = scenes.standing_person(cx, cy, s)
        people.append({p: xy for p, xy in person.items()
                       if p not in (1, 16, 17)})
    conf, paf = scenes.make_maps(people, mc.hout, mc.wout)
    return (torch.from_numpy(np.stack([conf] * BATCH)),
            torch.from_numpy(np.stack([paf] * BATCH)))


def check_mirrored_scene(torch, np, scenes, flip, decode_maps, postproc,
                         mc, dev) -> None:
    """The three-person scene decoded from `mirror_maps` of its maps: card
    == CPU, and the same people with x -> 1 - x and left/right parts
    swapped within 1e-5 of the scene's own decode."""
    conf, paf = three_people(torch, np, scenes, mc)
    on_dev = decode_maps(*flip.mirror_maps(conf.to(dev), paf.to(dev)),
                         postproc)
    mirrored = decode_maps(*flip.mirror_maps(conf, paf), postproc)
    compare_decodes(torch, "mirrored scene", on_dev, mirrored, 1e-5)
    scene = decode_maps(conf, paf, postproc)
    swap = torch.as_tensor(flip._PART_SWAP[:18])
    for b in range(BATCH):
        n = int(scene.num_humans[b])
        if n != 3 or int(mirrored.num_humans[b]) != 3 or not bool(
                (mirrored.n_parts[b, :3] == 18).all()):
            raise AssertionError(
                f"mirrored scene: {int(mirrored.num_humans[b])} humans, "
                f"parts {mirrored.n_parts[b, :4].tolist()}")
        mean_x = mirrored.coords[b, :n, :, 0].mean(-1)
        for i in range(n):
            ref = scene.coords[b, i][swap]
            j = int((mean_x - (1 - ref[:, 0].mean())).abs().argmin())
            err = max(float((mirrored.coords[b, j, :, 0]
                             - (1 - ref[:, 0])).abs().max()),
                      float((mirrored.coords[b, j, :, 1]
                             - ref[:, 1]).abs().max()))
            if not err <= 1e-5:
                raise AssertionError(f"mirrored scene person {i}: {err}")


def accuracy_paths(torch, np, scenes, engines, images, counted, n_fused,
                   dev) -> None:
    """Phase 5 (module docstring)."""
    from openpose_plus_tpu_torch import engine as engine_mod
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.postproc import decode, flip

    engine = engines["default"]
    cfg = engine.config
    mc, m = cfg.model, cfg.postproc.max_humans
    s2d = common.space_to_depth(images)
    layouts = {"s2d": s2d, "s2d2": common.space_to_depth(s2d)}
    graphs = {}
    for label, eng in engines.items():
        # flip-TTA: the first call captures, later calls replay
        rec = replayed_path(
            torch, counted, f"{label} flip-TTA",
            lambda: eng.infer(images, flip_tta=True),
            lambda: engine_mod.infer_tta(eng.model, images,
                                         eng.config.postproc),
            1, 2 * n_fused if label == "fused" else 0)
        out, n = rec["out"], rec["eager_launches"]
        graphs[f"{label}_flip_tta"] = rec["graph_bytes"]
        check_humans(torch, f"{label} flip-TTA", out, m, dev)
        if not bool((out.num_humans > 0).all()):
            raise AssertionError(f"{label} flip-TTA decoded an image to no "
                                 "humans")
        for tta in (False, True):
            ref = eng.infer(images, flip_tta=tta)
            for name, x in layouts.items():
                assert_batches_equal(torch, f"{label} {name} flip_tta={tta}",
                                     eng.infer(x, flip_tta=tta), ref)
        log(f"accuracy ({label}): flip-TTA captured at its first call "
            f"({graphs[f'{label}_flip_tta']} bytes of graph), replayed == "
            f"eager, no Python launch; s2d and s2d^2 inputs equal to plain, "
            f"with and without flip-TTA; eager flip-TTA launches {n}, humans "
            f"per image {out.num_humans.tolist()}")
    conf, paf = engine.forward(images)
    twice = flip.mirror_maps(*flip.mirror_maps(conf, paf))
    if not (torch.equal(twice[0], conf) and torch.equal(twice[1], paf)):
        raise AssertionError("mirror_maps twice is not the identity")
    check_mirrored_scene(torch, np, scenes, flip, decode.decode_maps,
                         cfg.postproc, mc, dev)
    log("mirror_maps twice == identity on the card; mirrored scene decodes "
        "as the scene mirrored (x -> 1 - x, L/R swapped), card == cpu")

    # scale search, both combiners, both engines: captured at the first
    # call, replayed after
    for label, eng in engines.items():
        for combine, rows, at_least in (("avg", m, 1),
                                        ("dedup", m * len(SCALES), 3)):
            impl = (engine_mod.infer_multiscale_avg if combine == "avg"
                    else engine_mod.infer_multiscale_dedup)
            r = replayed_path(
                torch, counted, f"{label} scale search {combine}",
                lambda: eng.infer_multiscale(images, SCALES, flip_tta=True,
                                             combine=combine),
                lambda: impl(eng.model, images, eng.config.postproc, SCALES,
                             True, mc.stride),
                at_least, 6 * n_fused if label == "fused" else 0)
            out, n = r["out"], r["eager_launches"]
            graphs[f"{label}_multiscale_{combine}"] = r["graph_bytes"]
            check_humans(torch, f"{label} scale search {combine}", out, rows,
                         dev)
            log(f"scale search ({label}, {combine}, scales {SCALES} + "
                f"flip): replayed == eager, no Python launch "
                f"({r['graph_bytes']} bytes of graph); eager launches {n}, "
                f"humans per image {out.num_humans.tolist()}")
        # one scale with the flip is flip-TTA, operation for operation
        assert_batches_equal(
            torch, f"{label} scale search at (1.0,) + flip vs flip-TTA",
            eng.infer_multiscale(images, (1.0,), flip_tta=True),
            eng.infer(images, flip_tta=True))
        log(f"scale search ({label}) at scales (1.0,) + flip == "
            "infer(flip_tta=True)")
    x0 = engine_mod.preprocess_images(images)
    with torch.inference_mode():
        for s in SCALES:
            size = (engine_mod.scaled_size(mc.hin, s, mc.stride),
                    engine_mod.scaled_size(mc.win, s, mc.stride))
            xi = engine_mod.resize_linear(x0, size)
            maps = {}
            for label, eng in engines.items():
                out = eng.model(xi)
                maps[label] = (out["conf"][-1], out["paf"][-1])
            grid = tuple(maps["fused"][0].shape[1:3])
            if grid != (size[0] // mc.stride, size[1] // mc.stride):
                raise AssertionError(f"scale {s}: output grid {grid}")
            ratios = check_map_scale(torch, f"scale {s} fused vs unfused",
                                     maps["fused"], maps["default"], 2e-2)
            log(f"scale {s} ({grid[0]}x{grid[1]} grid): fused vs unfused "
                f"max_abs_err / scale conf {ratios[0]:.3g}, paf "
                f"{ratios[1]:.3g} (limit 2e-2)")

    # the quality decoder on truncated people: card vs cpu, merge fired
    quality = cfg.postproc.quality()
    fidelity = dataclasses.replace(quality, fragment_merge_rel=0.0)
    conf, paf = truncated_people(torch, np, scenes, mc)
    conf_dev, paf_dev = conf.to(dev), paf.to(dev)
    q_dev, n = launches_during(torch, counted, lambda: decode.decode_maps(
        conf_dev, paf_dev, quality))
    check_launches("quality decode", n, 1, 0)
    q_cpu = decode.decode_maps(conf, paf, quality)
    compare_decodes(torch, "quality decode", q_dev, q_cpu, 5e-3)
    f_dev = decode.decode_maps(conf_dev, paf_dev, fidelity)
    if not (bool((q_dev.num_humans < f_dev.num_humans).all())
            and int(q_dev.n_parts.max()) > int(f_dev.n_parts.max())):
        raise AssertionError(
            f"fragment merge did not fire: quality {q_dev.num_humans[0]} "
            f"humans of {q_dev.n_parts[0, :4].tolist()} parts, fidelity "
            f"{f_dev.num_humans[0]} of {f_dev.n_parts[0, :4].tolist()}")
    merged = decode.merge_dedup([q_dev, f_dev])
    assert_batches_equal(
        torch, "merge_dedup card vs cpu",
        decode.HumanBatch(**{f.name: getattr(merged, f.name).cpu()
                             for f in dataclasses.fields(merged)}),
        decode.merge_dedup([decode.HumanBatch(**{
            f.name: getattr(x, f.name).cpu()
            for f in dataclasses.fields(x)}) for x in (q_dev, f_dev)]))
    log(f"quality decode (K={quality.max_peaks}, {quality.upsample_factor}x,"
        f" fragment merge {quality.fragment_merge_rel}) on truncated people:"
        f" card == cpu, launches {n}; {int(q_dev.num_humans[0])} humans of "
        f"{q_dev.n_parts[0, :2].tolist()} parts vs fidelity() "
        f"{int(f_dev.num_humans[0])} of {f_dev.n_parts[0, :3].tolist()}...; "
        "merge_dedup card == cpu")
    # the fidelity() and quality() decoders inside the graphs, on phase 4's
    # weights: flip-TTA and the scale search without the flip
    from openpose_plus_tpu_torch import Engine

    for post in ("fidelity", "quality"):
        pcfg = getattr(cfg.postproc, post)()
        eng = Engine(cfg.replace(postproc=pcfg),
                     params=engine.model.state_dict(), device=dev)
        for what, call, eager, at_least in (
                ("flip-TTA", lambda: eng.infer(images, flip_tta=True),
                 lambda: engine_mod.infer_tta(eng.model, images, pcfg), 1),
                ("scale search dedup", lambda: eng.infer_multiscale(
                    images, SCALES, combine="dedup"),
                 lambda: engine_mod.infer_multiscale_dedup(
                     eng.model, images, pcfg, SCALES, False, mc.stride), 3)):
            r = replayed_path(torch, counted, f"{post}() {what}", call, eager,
                              at_least, 0)
            graphs[f"{post}_{what.replace(' ', '_')}"] = r["graph_bytes"]
        del eng
    log(f"accuracy: fidelity() and quality() flip-TTA and scale search "
        f"(dedup, no flip) replayed == eager; graph bytes {graphs}")


def zoo_paths(torch, images, counted, dev, gpu) -> None:
    """Phase 7 (module docstring): the rest of the zoo at full width."""
    from openpose_plus_tpu_torch import Engine, default_config
    from openpose_plus_tpu_torch.models import common, get_model

    s2d = common.space_to_depth(images)
    for name in ZOO:
        cfg = default_config(name)
        mc, m = cfg.model, cfg.postproc.max_humans
        engine = Engine(cfg, seed=0, device=dev)
        gains = scale_heads(torch, engine, images)
        engine.infer(images)                   # warm-up (cuDNN, allocator)
        out, n = launches_during(torch, counted, lambda: engine.infer(images))
        check_launches(f"zoo {name}", n, 1, 0)
        check_humans(torch, f"zoo {name}", out, m, dev)
        if not bool((out.num_humans > 0).all()):
            raise AssertionError(f"zoo {name} decoded an image to no humans")
        assert_batches_equal(torch, f"zoo {name} s2d vs plain",
                             engine.infer(s2d), out)
        log(f"zoo {name}: Engine.infer {tuple(images.shape)} "
            f"{mc.compute_dtype} {mc.n_stages} stages, head gains {gains}; "
            f"kernel launches {n}; humans per image "
            f"{out.num_humans.tolist()}; s2d input gives the same HumanBatch")
        errs = check_forward32(torch, get_model, engine, images, dev,
                               f"zoo {name} ")
        log(json.dumps({"zoo": {
            "model": name, "batch": BATCH, "hw": [mc.hin, mc.win],
            "dtype": mc.compute_dtype, "stages": mc.n_stages,
            "launches": n, "humans": out.num_humans.tolist(),
            "forward32_rel_err": errs, "gpu": gpu}}))


def scale_paf_first_heads(torch, engine, images) -> dict:
    """`scale_heads` for BODY_25, whose heatmap stages read the last PAFs:
    the last PAF prediction first, then the last heatmap prediction on the
    maps that follow, to max |paf| 5 and max |conf| 0.7 (both biases are
    zero)."""
    from openpose_plus_tpu_torch.models import body25

    stages = engine.model.stages
    heads = {"paf": getattr(stages, f"stage{body25.N_PAF_STAGES - 1}_L2"),
             "conf": getattr(stages, f"stage{body25.N_CONF_STAGES - 1}_L1")}
    gains = {}
    for key, peak in (("paf", 5.0), ("conf", 0.7)):
        conf, paf = engine.forward(images)
        gains[key] = peak / float((paf if key == "paf" else conf).abs().max())
        with torch.no_grad():
            heads[key].Mconv7.weight.mul_(gains[key])
    return gains


def body25_phase(torch, np, inputs, counted, dev, gpu,
                 size=(368, 656)) -> None:
    """Phase 7b (module docstring): BODY_25's served path at the
    body25.batch_bs8 cell's shapes (`size` the input's)."""
    from openpose_plus_tpu_torch import Engine, default_config, skeletons
    from openpose_plus_tpu_torch.postproc import decode_maps

    cfg = default_config("body25")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=size[0],
                                                win=size[1]))
    mc, post = cfg.model, cfg.postproc

    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(
        0, 256, (BATCH, mc.hin, mc.win, 3), dtype=np.uint8)).to(dev)
    engine = Engine(cfg, seed=0, device=dev)
    gains = scale_paf_first_heads(torch, engine, images)
    engine.infer(images)                   # warm-up (cuDNN, allocator)
    out, n = launches_during(torch, counted, lambda: engine.infer(images))
    for name in ("find_peaks", "greedy_assign", "assemble", "sample_paf"):
        if n[name] < 1:
            raise AssertionError(f"body25 infer: {name} launched {n[name]} "
                                 "times, expected >= 1")
    check_humans(torch, "body25 infer", out, post.max_humans, dev)
    if tuple(out.coords.shape[2:]) != (skeletons.BODY25.n_parts, 2):
        raise AssertionError(f"body25 infer: coords {tuple(out.coords.shape)}")
    # the served graph (`compile`) gives the eager call's people bit for bit
    engine.compile(BATCH)
    assert_batches_equal(torch, "body25 compiled vs eager",
                         engine.infer(images), out)
    # a scene of three BODY_25 people on the cell's 46 x 82 grid: the
    # card's decode equals the CPU's
    people = [inputs.standing_person_25(11.37 + 15.61 * i, 21.43 - 0.7 * i)
              for i in range(3)]
    conf, paf = (torch.from_numpy(np.stack([x] * BATCH)) for x in
                 inputs.make_maps(people, 46, 82, noise=0.05,
                                  skel=skeletons.BODY25))
    on_cpu = decode_maps(conf, paf, post)
    compare_decodes(torch, "body25 scene", decode_maps(
        conf.to(dev), paf.to(dev), post), on_cpu, 1e-5)
    if not bool((on_cpu.n_parts[:, :3] == skeletons.BODY25.n_parts).all()):
        raise AssertionError(f"body25 scene: parts {on_cpu.n_parts[:, :4]}")
    log(json.dumps({"body25": {
        "batch": BATCH, "hw": [mc.hin, mc.win], "dtype": mc.compute_dtype,
        "head_gains": gains, "launches": n,
        "humans": out.num_humans.tolist(),
        "infer_ms": median_ms(torch, lambda: engine.infer(images)),
        "gpu": gpu}}))


def bias_act_times(torch, np, inputs, bias_act, key, count, dev) -> dict:
    """One bias_act call shape of a forward, `key` ((B, C, H, W), PReLU,
    the dense block buffer's channels or 0, offset, pooled), which the
    forward makes `count` times, on `kernel_inputs.epilogue_inputs` in
    bf16: the kernel and its plain version (pooled: then `F.max_pool2d`)
    timed (`graph_ms`) on copies of the input rotated past twice the 50 MB
    L2, so each call reads from HBM as the byte bound assumes (in the
    forward the conv's output may still sit in L2): y read once, the
    output (pooled: a quarter of y, rounded down) and the buffer's
    channels written once."""
    (b, c, h, w), prelu, wide, offset, pool = key
    y, bias, slope = inputs.epilogue_inputs(
        np.random.default_rng(b + c + wide + offset), b, h, w, c)
    y = torch.from_numpy(y).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
    bias = torch.from_numpy(bias).to(dev)
    slope = torch.from_numpy(slope).to(dev) if prelu else None
    per = y.numel() * y.element_size()
    copies = max(1, min(TIMED_ITERS, math.ceil(2 * L2_BYTES / per)))
    ys = [y] + [y.clone() for _ in range(copies - 1)]

    def buffer():
        return None if not wide else torch.zeros(
            (b, wide, h, w), dtype=y.dtype, device=dev).contiguous(
                memory_format=torch.channels_last)

    intos = [buffer() for _ in range(copies)]
    turn = iter(range(1 << 30))

    def kernel():
        i = next(turn) % copies
        bias_act.bias_act(ys[i], bias, slope, intos[i], offset, pool)

    def plain():
        i = next(turn) % copies
        bias_act.bias_act_plain(ys[i], bias, slope, intos[i], offset, pool)

    written = (b * c * (h // 2) * (w // 2) * y.element_size() if pool
               else per)
    nbytes = per * (1 + bool(wide)) + written + 4 * c * (1 + prelu)
    out = {"shape": [b, c, h, w], "prelu": prelu, "buffer_channels": wide,
           "offset": offset, "pool": pool, "count": count, "copies": copies,
           "device_ms": graph_ms(kernel, dev),
           "plain_device_ms": graph_ms(plain, dev),
           "bound_ms": bound(nbytes, 0.0)[0]}
    out["pct_of_bound"] = 100.0 * out["bound_ms"] / out["device_ms"]
    out["tb_per_s"] = nbytes / out["device_ms"] / 1e9
    return out


def bias_act_forward(torch, np, inputs, bias_act, engine, images, calls,
                     dev) -> dict:
    """One engine's epilogue at one batch: one eager `infer` must launch
    the kernel `calls` times (the count set to 0 just before it); the
    forward's maps through the kernel must equal those with the op
    swapped for its plain version (dense blocks written in place either
    way), both forwards timed; each call shape of the forward is timed by
    `bias_act_times`."""
    engine.infer(images)                         # warm-up
    torch.cuda.synchronize()
    bias_act.launches = 0
    engine.infer(images)
    torch.cuda.synchronize()
    if bias_act.launches != calls:
        raise AssertionError(f"infer {tuple(images.shape)}: bias_act "
                             f"launched {bias_act.launches} times, expected "
                             f"{calls}")
    seen = record_calls(bias_act, "_bias_act_op",
                        lambda: engine.forward(images))
    if len(seen) != calls:
        raise AssertionError(f"forward {tuple(images.shape)}: {len(seen)} "
                             f"bias_act calls, expected {calls}")
    keys: dict = {}
    for (y, _, slope, into, offset, pool), _ in seen:
        key = (tuple(y.shape), slope is not None,
               0 if into is None else into.shape[1], offset, pool)
        keys[key] = keys.get(key, 0) + 1
    maps = engine.forward(images)
    forward_ms = {"kernel": graph_ms(lambda: engine.forward(images), dev)}
    op, bias_act._bias_act_op = bias_act._bias_act_op, bias_act.bias_act_plain
    try:
        plain_maps = engine.forward(images)
        forward_ms["plain"] = graph_ms(lambda: engine.forward(images), dev)
    finally:
        bias_act._bias_act_op = op
    if not all(torch.equal(a, p) for a, p in zip(maps, plain_maps,
                                                 strict=True)):
        raise AssertionError(f"forward {tuple(images.shape)} through the "
                             "kernel differs from the plain op's")
    cases = [bias_act_times(torch, np, inputs, bias_act, key, n, dev)
             for key, n in keys.items()]
    total = {k: sum(c["count"] * c[k] for c in cases)
             for k in ("device_ms", "plain_device_ms", "bound_ms")}
    total["pct_of_bound"] = 100.0 * total["bound_ms"] / total["device_ms"]
    return {"launches_per_infer": calls, "forward_device_ms": forward_ms,
            "sum": total, "shapes": cases}


def bias_act_phase(torch, np, inputs, dev, gpu) -> dict:
    """Phase 7c (module docstring): the conv epilogue on every engine of
    BIAS_ACT_CALLS at its cells' shapes. Returns {label: {batch: the
    `bias_act_forward` result}}."""
    from openpose_plus_tpu_torch import Engine, default_config
    from openpose_plus_tpu_torch.ops.cuda import bias_act

    rng = np.random.default_rng(24)
    results = {}
    for label, (name, fused, hw, batches, calls) in BIAS_ACT_CALLS.items():
        cfg = default_config(name)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, hin=hw[0], win=hw[1], fused_inference=fused))
        engine = Engine(cfg, seed=0, device=dev)
        results[label] = {}
        for batch in batches:
            images = torch.from_numpy(rng.integers(
                0, 256, (batch, *hw, 3), dtype=np.uint8)).to(dev)
            try:
                got = bias_act_forward(torch, np, inputs, bias_act, engine,
                                       images, calls, dev)
            except AssertionError as e:
                raise AssertionError(f"bias_act {label}: {e}") from e
            results[label][batch] = got
            log(json.dumps({"bias_act": {
                "model": label, "batch": batch, "hw": list(hw), **got,
                "gpu": gpu}}))
        del engine
        torch.cuda.empty_cache()
    return results


def conv_flops(torch, common, model, images) -> dict:
    """The convolutions' flops in one forward of `images`, by type: "bf16"
    for the compute-dtype convs (ConvRelu, SepConvRelu: the tensor cores),
    "f32" for the float32 prediction 1x1s (Conv1x1F32)."""
    counts = {"bf16": 0, "f32": 0}

    def hook(module, args, out):
        if isinstance(module, common.SepConvRelu):
            c = module.dw_weight.shape[0]
            px = out.numel() // out.shape[1]
            n = px * c * (2 * module.dw_weight[0].numel()
                          + 2 * module.pw_weight.shape[0])
        else:
            n = 2 * out.numel() * module.weight[0].numel()
        counts["f32" if isinstance(module, common.Conv1x1F32)
               else "bf16"] += n

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (common.ConvRelu, common.SepConvRelu,
                                 common.Conv1x1F32))]
    try:
        model(images.float() / 255.0 - 0.5)
    finally:
        for h in handles:
            h.remove()
    return counts


def oracle_phase(torch, counted, dev, gpu) -> None:
    """Phase 8 (module docstring): the GT-map oracle on the card against
    ap_benchmark.json's "oracle@368" record, and card vs CPU on the first
    ORACLE_CPU_IMAGES images."""
    from openpose_plus_tpu_torch import ap_oracle
    from openpose_plus_tpu_torch.eval_coco import evaluate_detections_full

    with open(os.path.join(HERE, "ap_benchmark.json")) as f:
        record = json.load(f)["oracle@368"]
    bank = ap_oracle.oracle_bank("serving")
    first = ap_oracle.oracle_bank("serving", limit=ORACLE_CPU_IMAGES)
    with torch.inference_mode():
        for variant in ap_oracle.VARIANTS:
            t0 = time.perf_counter()
            dets, n = launches_during(torch, counted, lambda: (
                ap_oracle.oracle_detections(bank, variant, dev)))
            res = evaluate_detections_full(dets, bank.gt_by_image)
            seconds = time.perf_counter() - t0
            want = record[variant]["ap"]
            line = {"variant": variant, "images": len(bank.samples),
                    **res.as_dict(), "recorded_ap": want,
                    "delta": res.ap - want, "tolerance": ORACLE_AP_TOL,
                    "seconds": seconds}
            if variant == "perfect":
                if res.ap != 1.0:
                    raise AssertionError(f"oracle perfect: AP {res.ap}")
            else:
                check_launches(f"oracle {variant}", n,
                               len(bank.samples) // ap_oracle.BATCH, 0)
                if not abs(res.ap - want) <= ORACLE_AP_TOL:
                    raise AssertionError(
                        f"oracle {variant}: AP {res.ap} on the card, "
                        f"recorded {want} (tolerance {ORACLE_AP_TOL})")
                # the same images on the CPU: the decoder's plain versions
                on_card, on_cpu = (evaluate_detections_full(
                    ap_oracle.oracle_detections(first, variant, where),
                    first.gt_by_image).ap for where in (dev, "cpu"))
                if not abs(on_card - on_cpu) <= ORACLE_CPU_TOL:
                    raise AssertionError(
                        f"oracle {variant}, first {ORACLE_CPU_IMAGES} "
                        f"images: AP {on_card} on the card, {on_cpu} on the "
                        f"CPU (tolerance {ORACLE_CPU_TOL})")
                line.update(
                    launches=n, first_images=ORACLE_CPU_IMAGES,
                    first_ap_card=on_card, first_ap_cpu=on_cpu)
            log(f"oracle {variant}: AP {res.ap:.4f} (recorded {want}, delta "
                f"{res.ap - want:+.5f}), {seconds:.2f} s")
            log(json.dumps({"oracle": {**line, "gpu": gpu}}))


def counting(torch, counted, module, name: str, seen: list):
    """A context in which every call of module.<name> runs between kernel
    counts set to 0 and read (`launches_during`); each call appends
    (its positional arguments, {kernel: launches}, seconds) to `seen`."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out, n = launches_during(torch, counted,
                                 lambda: original(*args, **kwargs))
        seen.append((args, n, time.perf_counter() - t0))
        return out

    @contextlib.contextmanager
    def patched():
        setattr(module, name, wrapper)
        try:
            yield seen
        finally:
            setattr(module, name, original)
    return patched()


def studies_oracle(torch, counted, dev, tmp, record, gpu) -> None:
    """Phase 17 (a)-(c): the oracle probes, the sweep and the audit, each
    decode counted, beside their records; the card against the CPU on the
    first ORACLE_CPU_IMAGES images."""
    from openpose_plus_tpu_torch import (analyze_oracle_misses, ap_bench,
                                         ap_oracle, tune_fragment_merge)

    decodes = []
    with counting(torch, counted, ap_oracle, "decode_detections", decodes):
        for tier, stride, sigma in STUDIES_PROBES:
            key = ap_oracle.oracle_key(tier, stride, sigma)
            batches = ap_oracle.GEOMETRIES[tier]["n_val"] // ap_oracle.BATCH
            decodes.clear()
            t0 = time.perf_counter()
            row = ap_bench.run_oracle(True, tier, stride, sigma, device=dev,
                                      bank_dir=tmp)
            seconds = time.perf_counter() - t0
            if row["perfect"]["ap"] != 1.0:
                raise AssertionError(f"studies {key}: perfect AP "
                                     f"{row['perfect']['ap']}")
            runs = dict(zip(STUDIES_MAP_VARIANTS, decodes))
            first = {where: ap_oracle.run_oracle(
                tier, STUDIES_MAP_VARIANTS, where, limit=ORACLE_CPU_IMAGES,
                out_stride=stride, label_sigma=sigma)
                for where in (dev, "cpu")}
            line = {}
            for v in STUDIES_MAP_VARIANTS:
                _, n, decode_s = runs[v]
                check_launches(f"studies {key} {v}", n, batches, 0)
                ap, want = row[v]["ap"], record[key][v]["ap"]
                card, cpu = first[dev][v].ap, first["cpu"][v].ap
                line[v] = {"ap": ap, "record_ap": want, "delta": ap - want,
                           "launches": n, "decode_seconds": decode_s,
                           "first_ap_card": card, "first_ap_cpu": cpu}
                if not abs(ap - want) <= ORACLE_AP_TOL:
                    raise AssertionError(
                        f"studies {key} {v}: AP {ap} on the card, recorded "
                        f"{want} (tolerance {ORACLE_AP_TOL})")
                if not abs(card - cpu) <= ORACLE_CPU_TOL:
                    raise AssertionError(
                        f"studies {key} {v}, first {ORACLE_CPU_IMAGES} "
                        f"images: AP {card} on the card, {cpu} on the CPU "
                        f"(tolerance {ORACLE_CPU_TOL})")
            log(json.dumps({"studies": {
                "study": "oracle", "key": key, "images": batches
                * ap_oracle.BATCH, "variants": line, "seconds": seconds,
                "tolerance": ORACLE_AP_TOL, "cpu_tolerance": ORACLE_CPU_TOL,
                "gpu": gpu}}))

        # (b) the sweep on the serving tier's train bank
        decodes.clear()
        t0 = time.perf_counter()
        sweep = tune_fragment_merge.sweep("serving", device=dev)
        seconds = time.perf_counter() - t0
        batches = ap_oracle.GEOMETRIES["serving"]["n_train"] // ap_oracle.BATCH
        line = {}
        for (rel, r), (_, n, decode_s) in zip(sweep.items(), decodes):
            check_launches(f"studies sweep rel={rel:g}", n, batches, 0)
            want = STUDIES_SWEEP_RECORD.get(rel)
            line[f"{rel:g}"] = {"ap": r.ap, "ap50": r.ap50, "ar": r.ar,
                                "record_ap": want, "launches": n,
                                "decode_seconds": decode_s}
            if want is not None and not abs(r.ap - want) <= ORACLE_AP_TOL:
                raise AssertionError(
                    f"studies sweep rel={rel:g}: AP {r.ap} on the card, "
                    f"recorded {want} (tolerance {ORACLE_AP_TOL})")
        log(json.dumps({"studies": {
            "study": "sweep", "bank": "train", "tier": "serving",
            "images": batches * ap_oracle.BATCH, "rels": line,
            "seconds": seconds, "tolerance": ORACLE_AP_TOL, "gpu": gpu}}))

        # (c) the miss audit, with and without the fragment-merge pass
        for frag_merge, want in STUDIES_AUDIT_RECORD.items():
            decodes.clear()
            t0 = time.perf_counter()
            counts = analyze_oracle_misses.audit("serving",
                                                 frag_merge=frag_merge,
                                                 device=dev)
            seconds = time.perf_counter() - t0
            (_, n, _), = decodes
            check_launches(f"studies audit frag_merge={frag_merge}", n,
                           ap_oracle.GEOMETRIES["serving"]["n_val"]
                           // ap_oracle.BATCH, 0)
            for name, value in want.items():
                if not abs(counts[name] - value) <= STUDIES_AUDIT_TOL:
                    raise AssertionError(
                        f"studies audit frag_merge={frag_merge}: {name} "
                        f"{counts[name]} on the card, recorded {value} "
                        f"(tolerance {STUDIES_AUDIT_TOL})")
            first = [analyze_oracle_misses.audit(
                "serving", frag_merge=frag_merge, device=where,
                limit=ORACLE_CPU_IMAGES) for where in (dev, "cpu")]
            whole = ("gt_people", "misses", "scattered", "disconnected")
            card, cpu = ({k: c[k] for k in whole} for c in first)
            if card != cpu:
                raise AssertionError(
                    f"studies audit frag_merge={frag_merge}, first "
                    f"{ORACLE_CPU_IMAGES} images: {first[0]} on the card, "
                    f"{first[1]} on the CPU")
            log(json.dumps({"studies": {
                "study": "audit", "frag_merge": frag_merge, **counts,
                "record": want, "record_recovery": (
                    None if frag_merge else STUDIES_AUDIT_RECOVERY),
                "tolerance": STUDIES_AUDIT_TOL, "launches": n,
                "first_card": first[0], "first_cpu": first[1],
                "seconds": seconds, "gpu": gpu}}))


def studies_models(torch, counted, dev, tmp, gpu) -> None:
    """Phase 17 (d): the convergence curve, the scale-set study and the
    val_large bank at full width with a few steps, every evaluation
    counted."""
    from openpose_plus_tpu_torch import ap_bench
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP

    serving = ap_bench.GEOMETRIES["serving"]
    batches = {tier: geo["n_val"] // BATCH
               for tier, geo in ap_bench.GEOMETRIES.items()}
    # the batch shapes an evaluation serves: a ragged last batch is another
    shapes = {tier: 1 + bool(geo["n_val"] % BATCH)
              for tier, geo in ap_bench.GEOMETRIES.items()}
    evals = []

    def check_evals(what, variants, tier):
        done = [args[2] for args, _, _ in evals]     # eval_variant's variant
        if done != list(variants):
            raise AssertionError(f"studies {what}: evaluated {done}, "
                                 f"expected {list(variants)}")
        for v, (_, n, s) in zip(done, evals):
            if "tta" not in v:       # eager infer: a decode a batch
                check_launches(f"studies {what} {v}", n, batches[tier], 0)
                continue
            # flip-TTA and the scale search: one graph a call, captured at
            # the first batch (its warm-ups and the capture launch from
            # Python), every later batch a replay
            decodes = (len(ap_bench.MS_SCALES[v]) if "msdd" in v else 1)
            want = {**dict.fromkeys(("greedy_assign", "assemble",
                                     "sample_paf", "find_peaks"),
                                    (CAPTURE_WARMUP + 1) * decodes
                                    * shapes[tier]),
                    "fused_sepconv": 0}
            if n != want:
                raise AssertionError(f"studies {what} {v}: launches {n}, "
                                     f"expected {want} (one capture, then "
                                     "replays)")
        return [{"variant": v, "launches": n, "seconds": s}
                for v, (_, n, s) in zip(done, evals)]

    def finite_rows(what, row, cells):
        for cell in cells:
            if not math.isfinite(row[cell]["ap"]):
                raise AssertionError(f"studies {what} {cell}: {row[cell]}")
        return {c: {k: row[c].get(k) for k in (
            "ap", "ap50", "ar", "record_ap", "eval_seconds", "train_seconds",
            "imgs_per_sec", "loss_first", "loss_last")} for c in cells}

    with counting(torch, counted, ap_bench, "eval_variant", evals):
        # the curve: snapshots under the JAX names, a second call reuses them
        t0 = time.perf_counter()
        row = ap_bench.run_curve("mobilenet_thin", STUDIES_CURVE,
                                 geometry="serving", device=dev,
                                 bank_dir=tmp)
        seconds = time.perf_counter() - t0
        line = {"rows": finite_rows("curve", row,
                                    [str(s) for s in STUDIES_CURVE]),
                "evals": check_evals("curve", ["fidelity_tta"] * 2,
                                     "serving"), "seconds": seconds}
        snaps = [ckpt.load_npz(ap_bench.snapshot_path(
            tmp, "mobilenet_thin", s, 1e-3, serving,
            schedule_steps=max(STUDIES_CURVE))) for s in STUDIES_CURVE]
        if not any((snaps[0][k] != snaps[1][k]).any() for k in snaps[0]):
            raise AssertionError("studies curve: the snapshots are equal")
        make_step = T.make_train_step_on_batch

        def no_training(cfg):
            raise AssertionError("studies curve: the second call trained")
        T.make_train_step_on_batch = no_training
        evals.clear()
        try:
            again = ap_bench.run_curve("mobilenet_thin", STUDIES_CURVE,
                                       force=True, geometry="serving",
                                       device=dev, bank_dir=tmp)
        finally:
            T.make_train_step_on_batch = make_step
        check_evals("curve again", ["fidelity_tta"] * 2, "serving")
        line["again_ap"] = {s: again[str(s)]["ap"] for s in STUDIES_CURVE}
        log(json.dumps({"studies": {"study": "curve", "key": (
            "mobilenet_thin@368#curve"), **line, "gpu": gpu}}))

        # the scale-set study at the serving tier: ms15 and msdd, no msup
        evals.clear()
        t0 = time.perf_counter()
        row = ap_bench.run_model("mobilenet_thin", STUDIES_STEPS, 1e-3, False,
                                 geometry="serving", device=dev,
                                 ms_study=True, bank_dir=tmp)
        variants = ap_bench.VARIANTS + ("fidelity_tta_ms15",
                                        "fidelity_tta_msdd")
        variants = ([v for v in variants if "ms" not in v]
                    + [v for v in variants if "ms" in v])
        log(json.dumps({"studies": {
            "study": "ms_study", "key": "mobilenet_thin@368",
            "steps": STUDIES_STEPS,
            "rows": finite_rows("ms_study", row, variants),
            "evals": check_evals("ms_study", variants, "serving"),
            "seconds": time.perf_counter() - t0, "gpu": gpu}}))

        # the val_large bank at the small tier: the seven variants
        evals.clear()
        t0 = time.perf_counter()
        row = ap_bench.run_large("mobilenet_thin", STUDIES_STEPS, device=dev,
                                 bank_dir=tmp)
        if row["fidelity_tta_msup"]["scales"] != [1.0, 1.5, 2.0]:
            raise AssertionError(f"studies large: {row['fidelity_tta_msup']}")
        log(json.dumps({"studies": {
            "study": "large", "key": "mobilenet_thin+large",
            "steps": STUDIES_STEPS,
            "rows": finite_rows("large", row, ap_bench.LARGE_VARIANTS),
            "evals": check_evals("large", ap_bench.LARGE_VARIANTS, "small"),
            "seconds": time.perf_counter() - t0, "gpu": gpu}}))


def studies_phase(torch, counted, dev, gpu) -> None:
    """Phase 17 (module docstring): the accuracy studies on the card."""
    import tempfile

    t_phase = time.perf_counter()
    with open(os.path.join(HERE, "ap_benchmark.json")) as f:
        record = json.load(f)
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".smoke_bank_studies_") as tmp:
        studies_oracle(torch, counted, dev, tmp, record, gpu)
        studies_models(torch, counted, dev, tmp, gpu)
        # (e), (f): the table and the end-to-end demo in fresh processes
        t0 = time.perf_counter()
        table = subprocess.run(
            [sys.executable, "-m", "openpose_plus_tpu_torch.ap_bench",
             "--table", "--bank-dir", tmp], cwd=HERE, capture_output=True,
            text=True, timeout=300)
        table_s = time.perf_counter() - t0
        if table.returncode != 0 or not all(key in table.stdout for key in (
                "oracle@368#s4", "oracle@368#sig4", "serving tier",
                "val_large bank", "mobilenet_thin@368#curve")):
            raise AssertionError(f"studies --table: rc {table.returncode}\n"
                                 f"{table.stdout}\n{table.stderr}")
        log(table.stdout)
        t0 = time.perf_counter()
        e2e = subprocess.run(
            [sys.executable, "-m", "openpose_plus_tpu_torch.synthetic_e2e",
             "--steps", "50", "--n-images", "16", "--workdir",
             os.path.join(tmp, "e2e")], cwd=HERE, capture_output=True,
            text=True, timeout=600)
        e2e_s = time.perf_counter() - t0
        if e2e.returncode != 0:
            raise AssertionError(f"studies synthetic_e2e: rc "
                                 f"{e2e.returncode}\n{e2e.stdout}\n"
                                 f"{e2e.stderr}")
        demo = json.loads(e2e.stdout.strip().splitlines()[-1])
        if not all(math.isfinite(demo[k]) for k in (
                "ap_before", "ap_after", "loss_first", "loss_last")):
            raise AssertionError(f"studies synthetic_e2e: {demo}")
    log(json.dumps({"studies": {
        "study": "processes", "table_seconds": table_s,
        "synthetic_e2e": demo, "synthetic_e2e_seconds": e2e_s,
        "phase_seconds": time.perf_counter() - t_phase, "gpu": gpu}}))


def eval_phase(torch, engine, counted, gpu):
    """Phase 9 (module docstring): `evaluate_engine` through the pooled
    loader over a seeded val bank of EVAL_IMAGES serving-size images, on
    the card and on the CPU, then on EVAL_TIMED_IMAGES images on the card;
    returns the card's EvalResult on the first bank."""
    import math
    import tempfile

    from openpose_plus_tpu_torch import Engine, loader
    from openpose_plus_tpu_torch.ap_oracle import GEOMETRIES
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine

    mc = engine.config.model
    size = GEOMETRIES["serving"]["size"]
    line = {"model": mc.name, "dtype": mc.compute_dtype,
            "input": [mc.hin, mc.win], "batch": BATCH, "bank_size": size,
            "tolerance": EVAL_CPU_TOL}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_bank_") as tmp:
        ann, imgs = make_scene_bank(tmp, "val", EVAL_TIMED_IMAGES, size)
        dataset = CocoPoseDataset(ann, imgs)
        line["plane"] = list(loader.decode(dataset[0].image_path, mc.hin,
                                           mc.win)[0].shape)
        cpu_engine = Engine(engine.config, params=engine.model.state_dict(),
                            device="cpu")
        runs = []
        for eng, limit in ((engine, EVAL_IMAGES), (cpu_engine, EVAL_IMAGES),
                           (engine, EVAL_TIMED_IMAGES)):
            t0 = time.perf_counter()
            res, n = launches_during(torch, counted, lambda: evaluate_engine(
                eng, dataset, batch_size=BATCH, limit=limit))
            runs.append((res, n, time.perf_counter() - t0))
    (card, card_n, card_s), (cpu, _, cpu_s), (timed, timed_n, timed_s) = runs
    for what, res, n, images in (("card", card, card_n, EVAL_IMAGES),
                                 ("timed", timed, timed_n,
                                  EVAL_TIMED_IMAGES)):
        if not (res.n_images == images and res.n_dets > 0
                and math.isfinite(res.ap)):
            raise AssertionError(f"evaluate_engine ({what}): {res}")
        check_launches(f"evaluate_engine ({what})", n,
                       -(-images // BATCH), 0)
    if not abs(card.ap - cpu.ap) <= EVAL_CPU_TOL:
        raise AssertionError(f"evaluate_engine: AP {card.ap} on the card, "
                             f"{cpu.ap} on the CPU (tolerance "
                             f"{EVAL_CPU_TOL})")
    d = loader.dct_reduction(size, size, mc.hin, mc.win)
    if d == 1 or line["plane"] != [-(-size // d)] * 2 + [3]:
        raise AssertionError(f"the loader decoded a {size}px JPEG to "
                             f"{line['plane']}, expected a 1/{d} plane")
    log(json.dumps({"evaluate_engine": {
        **line, "images": EVAL_IMAGES, "card": card.as_dict(),
        "cpu": cpu.as_dict(), "card_seconds": card_s, "cpu_seconds": cpu_s,
        "launches": card_n, "timed": {
            "images": EVAL_TIMED_IMAGES, **timed.as_dict(),
            "seconds": timed_s, "launches": timed_n}, "gpu": gpu}}))
    return card


def legacy_checkpoint(torch, engine, images, dev, gpu) -> None:
    """Phase 9's legacy checkpoint layout (module docstring): the card
    engine's weights as a pre-flattening npz and as the current one, each
    served through `Engine(params=load_npz(path))`: both HumanBatches equal
    the card engine's bit for bit."""
    import tempfile

    import numpy as np

    from openpose_plus_tpu_torch import Engine
    from openpose_plus_tpu_torch import checkpoint as ckpt

    flat = ckpt.to_flax(engine.model.state_dict())
    legacy = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[-1] in ("kernel", "bias") and "ConvRelu" in parts[-2]:
            key = "/".join(parts[:-1] + ["Conv_0", parts[-1]])
        legacy[key] = value
    renamed = len(set(legacy) - set(flat))
    want = engine.infer(images)
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".smoke_bank_npz_") as tmp:
        for label, layout in (("legacy", legacy), ("current", flat)):
            path = os.path.join(tmp, f"{label}.npz")
            np.savez(path, **layout)
            t0 = time.perf_counter()
            served = Engine(engine.config, params=ckpt.load_npz(path),
                            device=dev)
            load_s = time.perf_counter() - t0
            assert_batches_equal(torch, f"{label} npz engine",
                                 served.infer(images), want)
            log(f"{label} npz: {len(layout)} keys ({renamed} renamed in the "
                f"legacy layout), loaded in {load_s:.2f} s, HumanBatch == "
                "the card engine's")
    log(json.dumps({"legacy_checkpoint": {
        "model": engine.config.model.name, "keys": len(flat),
        "renamed": renamed, "batch": list(images.shape),
        "humans_equal": True, "gpu": gpu}}))


def _rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b|| (0 when both are zero)."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def train_step_card_vs_cpu(torch, T, cfg, batch, dev) -> dict:
    """Phase 10.1: one step of make_train_step_on_batch from the same
    seeded parameters on the same TRAIN_CPU_BATCH images, on the card and
    on the CPU: the loss, every gradient leaf and every updated
    parameter."""
    small = {k: v[:TRAIN_CPU_BATCH] for k, v in batch.items()}
    out = {}
    for where in (dev, "cpu"):
        state = T.create_train_state(cfg, seed=0, device=where)
        before = {n: p.detach().cpu().clone()
                  for n, p in state.model.named_parameters()}
        state, m = T.make_train_step_on_batch(cfg)(state, small)
        out[where] = (float(m["loss"]), before,
                      {n: p.grad.detach().cpu()
                       for n, p in state.model.named_parameters()},
                      {n: p.detach().cpu()
                       for n, p in state.model.named_parameters()})
    (loss, p0, grads, params), (loss_c, p0_c, grads_c, params_c) = (
        out[dev], out["cpu"])
    for n in p0:
        if not torch.equal(p0[n], p0_c[n]):
            raise AssertionError(f"train: seeded parameter {n} differs "
                                 "between the card and the CPU")
    leaf = {n: _rel_l2(torch, grads[n], grads_c[n]) for n in grads}
    every = _rel_l2(torch, torch.cat([g.flatten() for g in grads.values()]),
                    torch.cat([g.flatten() for g in grads_c.values()]))
    worst = max(leaf, key=leaf.get)
    # Adam's first step moves an element by at most ~lr, whatever its
    # gradient: two proper first steps from equal parameters lie within 2 lr
    step_bound = 2 * cfg.train.lr_init * (1 + 1e-3)
    param_err = max(float((params[n] - params_c[n]).abs().max())
                    for n in params)
    same_sign = float(torch.cat([
        ((params[n] - p0[n]).sign() == (params_c[n] - p0[n]).sign()
         ).flatten().float() for n in params]).mean())
    res = {"loss_card": loss, "loss_cpu": loss_c,
           "loss_rel_err": abs(loss - loss_c) / abs(loss_c),
           "grad_rel_l2_all": every, "grad_rel_l2_worst_leaf": leaf[worst],
           "grad_worst_leaf": worst,
           "grad_rel_l2_median_leaf": statistics.median(leaf.values()),
           "param_max_abs_err": param_err, "param_bound": step_bound,
           "update_same_sign_share": same_sign}
    if not (math.isfinite(loss) and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and leaf[worst] <= TRAIN_LEAF_RTOL and every <= TRAIN_ALL_RTOL
            and param_err <= step_bound):
        raise AssertionError(f"train step, card vs CPU: {res} (tolerances: "
                             f"loss {TRAIN_LOSS_RTOL}, leaf "
                             f"{TRAIN_LEAF_RTOL}, all {TRAIN_ALL_RTOL})")
    return res


def _csv_rows(path) -> list[dict]:
    import csv
    with open(path) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def check_full_width(cfg) -> None:
    """Phase 10 trains MobileNet-thin at its served width: 368x432, width
    0.75, 6 stages, bf16, batch 8."""
    mc = cfg.model
    if (mc.name, mc.hin, mc.win, mc.width_multiplier, mc.n_stages,
            mc.compute_dtype, cfg.train.batch_size) != (
            "mobilenet_thin", 368, 432, 0.75, 6, "bfloat16", BATCH):
        raise AssertionError(f"train: not the full-width config {cfg}")


def train_phase(torch, np, counted, dev, gpu) -> None:
    """Phase 10 (module docstring): training MobileNet-thin at full width
    on the card."""
    import tempfile

    from openpose_plus_tpu_torch import Engine, ap_bench
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.pipeline import TrainPipeline
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank
    from openpose_plus_tpu_torch.models import common

    geo = ap_bench.GEOMETRIES["serving"]
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_bank_") as tmp:
        t0 = time.perf_counter()
        ann, imgs = make_scene_bank(tmp, "train", TRAIN_IMAGES, geo["size"])
        bank_s = time.perf_counter() - t0
        base = ap_bench.build_config("mobilenet_thin", ann, imgs,
                                     TRAIN_STEPS, TRAIN_LR, geo)
        mc = base.model
        check_full_width(base)
        cfg = base.replace(train=dataclasses.replace(
            base.train, log_every=1, checkpoint_every=TRAIN_CKPT,
            checkpoint_dir=os.path.join(tmp, "ck"),
            metrics_csv=os.path.join(tmp, "metrics.csv")))
        dataset = CocoPoseDataset(ann, imgs)
        pipe = TrainPipeline(dataset, cfg, seed=0)
        batch = next(iter(pipe))
        pipe.stop()

        # 1. card against CPU
        vs_cpu = train_step_card_vs_cpu(torch, T, cfg, batch, dev)
        log(f"train step card vs CPU (batch {TRAIN_CPU_BATCH}, bf16): "
            f"{vs_cpu}")

        # 2. train_loop with the pipeline, a checkpoint, the resume
        logs = []
        for module in counted.values():
            module.launches = 0
        t0 = time.perf_counter()
        state = T.train_loop(cfg, n_steps=TRAIN_STEPS, log=logs.append,
                             device=dev)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        loop_launches = {n: m.launches for n, m in counted.items()}
        if any(loop_launches.values()):   # cuDNN and autograd only
            raise AssertionError(f"train_loop launched hand kernels "
                                 f"{loop_launches}")
        rows = _csv_rows(cfg.train.metrics_csv)
        losses = [r["loss"] for r in rows]
        saved = sorted(int(d) for d in os.listdir(cfg.train.checkpoint_dir)
                       if d.isdigit())
        if not (len(losses) == TRAIN_STEPS and state.step == TRAIN_STEPS
                and all(map(math.isfinite, losses))):
            raise AssertionError(f"train_loop: {len(losses)} logged losses, "
                                 f"step {state.step}, non-finite: "
                                 f"{[x for x in losses if not math.isfinite(x)][:5]}")
        first, last = statistics.mean(losses[:10]), statistics.mean(
            losses[-50:])
        if not last < TRAIN_FALL * first:
            raise AssertionError(f"train_loop: loss {first} (first 10) -> "
                                 f"{last} (last 50), not below "
                                 f"{TRAIN_FALL} x")
        if saved != [TRAIN_CKPT, TRAIN_STEPS]:
            raise AssertionError(f"train_loop checkpoints {saved}")
        if [type(g).__name__ for g in state.graphs.values()] != ["_Captured"]:
            raise AssertionError(f"train_loop's steps: {state.graphs}, "
                                 "expected one captured step")
        state = T.train_loop(cfg, n_steps=TRAIN_RESUME_TO, log=logs.append,
                             device=dev)
        resumed_to = state.step
        # the resumed run restored, warmed up and captured again
        if [type(g).__name__ for g in state.graphs.values()] != ["_Captured"]:
            raise AssertionError(f"resumed train_loop's steps: "
                                 f"{state.graphs}, expected one captured "
                                 "step")
        if (f"resumed from step {TRAIN_STEPS}" not in logs
                or state.step != TRAIN_RESUME_TO
                or len(_csv_rows(cfg.train.metrics_csv)) != TRAIN_RESUME_TO
                or ckpt.latest_step(cfg.train.checkpoint_dir)
                != TRAIN_STEPS):
            raise AssertionError(f"train_loop resume: step {state.step}, "
                                 f"logs {logs[-3:]}")
        log(f"train_loop: {TRAIN_STEPS} steps in {loop_s:.1f} s, loss "
            f"{first:.1f} (first 10) -> {last:.2f} (last 50), checkpoints "
            f"{saved}, resumed from step {TRAIN_STEPS} to {resumed_to}; "
            f"hand-kernel launches in the loop {loop_launches}")

        # 3. the trained weights served by an Engine
        images = torch.as_tensor(batch["images"]).to(dev)
        engine = Engine(base, params=state.model.state_dict(), device=dev)
        humans, n = launches_during(torch, counted,
                                    lambda: engine.infer(images))
        check_launches("train handoff", n, 1, 0)
        check_humans(torch, "train handoff", humans,
                     base.postproc.max_humans, dev)

        # 4. timings: the step on a batch on the card, eager and replayed
        # (the state's captured step: the batch has the pipeline's shapes),
        # the loop with the pipeline, the pipeline alone, memory and the
        # FLOP bound
        step_fn = T.make_train_step_on_batch(cfg)
        targets = T.batch_on_device(cfg)
        on_card = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

        def eager_step():
            return T._update(state, *targets(state, on_card))

        def graph_step():
            return step_fn(state, on_card)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager_ms = median_ms(torch, eager_step)
        peak = torch.cuda.max_memory_allocated()
        step_ms = median_ms(torch, graph_step)
        trace = replay_trace(torch, {
            f"{kind}_{i}": fn for i in range(PROFILED_CALLS)
            for kind, fn in (("eager", eager_step), ("graph", graph_step))},
            gap_s=TRAIN_TRACE_GAP_S)
        busy = {(kind, key): statistics.mean(
            trace[f"{kind}_{i}"][key] for i in range(PROFILED_CALLS))
            for kind in ("eager", "graph")
            for key in ("busy_ms", "device_events")}
        busy_ms, kernels = busy["graph", "busy_ms"], busy["graph",
                                                          "device_events"]
        spread = train_graph_spread(torch, T, cfg, on_card, dev)
        timed = cfg.replace(train=dataclasses.replace(
            cfg.train, log_every=100, checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(tmp, "ck_timed"),
            metrics_csv=os.path.join(tmp, "timed.csv")))
        T.train_loop(timed, n_steps=TRAIN_STEPS, log=lambda _: None,
                     device=dev)
        loop_imgs = statistics.mean(
            r["imgs_per_sec"] for r in _csv_rows(timed.train.metrics_csv)[1:])
        pipe = TrainPipeline(dataset, cfg, seed=1)
        it = iter(pipe)
        for _ in range(5):
            next(it)
        t0 = time.perf_counter()
        for _ in range(TRAIN_PIPELINE_BATCHES):
            next(it)
        pipe_bps = TRAIN_PIPELINE_BATCHES / (time.perf_counter() - t0)
        pipe.stop()
        with torch.no_grad():
            state.model.eval()
            flops = conv_flops(torch, common, state.model, on_card["images"])
            state.model.train()
        step_flops = 3 * (flops["bf16"] + flops["f32"])
        bound_ms = step_flops / BF16_FLOPS * 1e3
        step_imgs = BATCH * 1000.0 / step_ms
        log(json.dumps({"train": {
            "model": mc.name, "batch": BATCH, "hw": [mc.hin, mc.win],
            "dtype": mc.compute_dtype, "stages": mc.n_stages,
            "lr": TRAIN_LR, "optimizer": cfg.train.optimizer,
            "bank_images": TRAIN_IMAGES, "bank_seconds": bank_s,
            "card_vs_cpu": vs_cpu, "loss_first10": first,
            "loss_last50": last, "loop_steps": TRAIN_STEPS,
            "loop_seconds_log_every_1": loop_s, "resumed_to": resumed_to,
            "loop_launches": loop_launches,
            "handoff_humans": humans.num_humans.tolist(),
            "step_ms": step_ms, "step_imgs_per_sec": step_imgs,
            "step_device_busy_ms": busy_ms,
            "step_device_idle_share": 1.0 - busy_ms / step_ms,
            "step_kernels": kernels, "step_replays_a_graph": True,
            "loop_imgs_per_sec": loop_imgs,
            "pipeline_batches_per_sec": pipe_bps,
            "pipeline_imgs_per_sec": pipe_bps * BATCH,
            "paced_by": ("step" if step_imgs < pipe_bps * BATCH
                         else "pipeline"),
            "peak_memory_bytes": peak,
            "forward_flops": flops, "step_flops": step_flops,
            "step_bound_ms": bound_ms, "step_bound_by": "operations",
            "step_pct_of_bound": 100.0 * bound_ms / step_ms,
            "gpu": gpu}}))
        log(json.dumps({"train_graph": {
            "model": mc.name, "batch": BATCH, "hw": [mc.hin, mc.win],
            "optimizer": cfg.train.optimizer,
            "eager_step_ms": eager_ms, "graph_step_ms": step_ms,
            "eager_over_graph": eager_ms / step_ms,
            "eager_busy_ms": busy["eager", "busy_ms"],
            "graph_busy_ms": busy["graph", "busy_ms"],
            "eager_idle_share": 1.0 - busy["eager", "busy_ms"] / eager_ms,
            "graph_idle_share": 1.0 - busy["graph", "busy_ms"] / step_ms,
            "eager_device_events": busy["eager", "device_events"],
            "graph_device_events": busy["graph", "device_events"],
            "loop_imgs_per_sec": loop_imgs,
            "pipeline_batches_per_sec": pipe_bps,
            "pipeline_imgs_per_sec": pipe_bps * BATCH,
            "eager_peak_memory_bytes": peak, **spread,
            "loop_and_resume_through_graph": True, "gpu": gpu}}))


def train_graph_spread(torch, T, cfg, batch, dev) -> dict:
    """Phase 10's graph against eager: two eager runs and one graphed run
    (CAPTURE_WARMUP eager steps, the capture, replays) of
    TRAIN_SPREAD_STEPS steps from the seeded state on the same batch; the
    graphed run's parameters must lie within the eager runs' spread
    (cuDNN's backward is not bit-reproducible). Also the memory the
    captured step's graph keeps."""
    from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP

    targets = T.batch_on_device(cfg)
    out = {}

    def run(graphed: bool):
        state = T.create_train_state(cfg, seed=0, device=dev)
        step = T.make_train_step_on_batch(cfg)
        for i in range(TRAIN_SPREAD_STEPS):
            if not graphed:
                T._update(state, *targets(state, batch))
            elif i == CAPTURE_WARMUP:
                _, out["graph_bytes"] = graph_bytes(
                    torch, lambda: step(state, batch))
            else:
                step(state, batch)
        torch.cuda.synchronize()
        if state.step != TRAIN_SPREAD_STEPS:
            raise AssertionError(f"train: {state.step} updates in "
                                 f"{TRAIN_SPREAD_STEPS} steps")
        return {n: p.detach().float().clone()
                for n, p in state.model.named_parameters()}

    def max_diff(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a)

    eager = [run(False), run(False)]
    graphed = run(True)
    out.update(spread_steps=TRAIN_SPREAD_STEPS,
               eager_vs_eager_max_abs=max_diff(*eager),
               graph_vs_eager_max_abs=max_diff(graphed, eager[0]))
    if out["graph_vs_eager_max_abs"] > out["eager_vs_eager_max_abs"]:
        raise AssertionError(f"train step, graph vs eager: {out}")
    return out


def int8_layers(common, model) -> tuple[int, int]:
    """(int8 convs, quantize passes) of one forward of `model` in int8:
    every ConvRelu and SepConvRelu is one int8 conv; a separable model
    quantizes the float input of each (the image, the bf16 output of each
    depthwise, a projection's bf16 input), a dense one the image and each
    later stage's input, the rest of its chain staying int8."""
    convs = sum(isinstance(m, (common.ConvRelu, common.SepConvRelu))
                for m in model.modules())
    if any(isinstance(m, common.SepConvRelu) for m in model.modules()):
        return convs, convs
    return convs, 1 + model.stages.n_stages - 1


def int8_flops(torch, common, model, images) -> dict:
    """The convolutions' operations in one int8 forward of `images`, by
    the type they run in: "int8" (the int8 convs: ConvRelu, a
    SepConvRelu's pointwise), "bf16" (the depthwise convs), "f32" (the
    prediction 1x1s); 2 per multiply-add."""
    counts = {"int8": 0, "bf16": 0, "f32": 0}

    def hook(module, args, out):
        out = out.q if isinstance(out, common.QAct) else out
        px = out.numel() // out.shape[1]
        if isinstance(module, common.SepConvRelu):
            c = module.dw_weight.shape[0]
            counts["bf16"] += 2 * px * c * module.dw_weight[0].numel()
            counts["int8"] += 2 * px * c * module.pw_weight.shape[0]
        elif isinstance(module, common.Conv1x1F32):
            counts["f32"] += 2 * out.numel() * module.weight[0].numel()
        else:
            counts["int8"] += 2 * out.numel() * module.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (common.ConvRelu, common.SepConvRelu,
                                 common.Conv1x1F32))]
    try:
        with torch.inference_mode():
            model(images.float() / 255.0 - 0.5)
    finally:
        for h in handles:
            h.remove()
    return counts


def int8_bound(q, cin, kernel, out) -> tuple[float, str]:
    """int8_conv's bound for a conv over `cin` channels (q may carry zero
    channels past them, the packed weights do): the input's Cin channels,
    the Cout * kernel^2 * Cin weights, rescale, bias and the output moved
    once, against 2 * M * N * K int8 operations (K = kernel^2 * Cin) at
    the int8 tensor-core peak; the channel padding counted nowhere."""
    cout = out.shape[-1]
    m = out.numel() // cout
    ops = 2 * m * cout * kernel * kernel * cin
    nbytes = (q.numel() // q.shape[-1] * cin + cout * kernel * kernel * cin
              + io_bytes(out) + 8 * cout)
    return bound(nbytes, ops / INT8_OPS_PER_S)


def record_outputs(module, names, fn) -> dict:
    """fn() with module.<name> for each of `names` recording its calls'
    (args, output); returns {name: [(args, output), ...]}."""
    calls = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args):
            out = originals[name](*args)
            calls[name].append((args, out))
            return out
        return call
    for name in names:
        setattr(module, name, recorder(name))
    try:
        fn()
    finally:
        for name, original in originals.items():
            setattr(module, name, original)
    return calls


def to_plain(ops, fn):
    """fn() with each (module, name) of `ops` sent to its plain version,
    module.<name>_plain (on the card)."""
    saved = [(module, name, getattr(module, name)) for module, name in ops]
    for module, name in ops:
        setattr(module, name, getattr(module, name + "_plain"))
    try:
        return fn()
    finally:
        for module, name, kernel in saved:
            setattr(module, name, kernel)


def routed_plain(module, fn):
    """fn() with the int8 conv and the quantize pass sent to their plain
    versions (on the card)."""
    return to_plain(((module, "int8_conv"), (module, "quantize_act")), fn)


def int8_engines(torch, name, images, dev) -> tuple:
    """Phase 11's engines of `name` at full width from `default_config`:
    the bf16 engine (seeded, heads scaled as phase 4 scales them) and the
    int8 engine on its weights, not yet calibrated; (bf16, int8, gains)."""
    from openpose_plus_tpu_torch import Engine, default_config
    cfg = default_config(name)
    bf16 = Engine(cfg, seed=0, device=dev)
    gains = scale_heads(torch, bf16, images)
    cfg8 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype="int8"))
    return bf16, Engine(cfg8, params=bf16.model.state_dict(),
                        device=dev), gains


def int8_forward_calls(torch, common, int8_conv, engine, images) -> tuple:
    """One int8 forward of `images` with its int8_conv and quantize_act
    calls recorded ({name: [(args, output), ...]}), and the input channels
    of each int8_conv call's layer (its q may carry zero channels past
    them), in call order."""
    cins = []

    def hook(module, args):
        weight = (module.pw_weight if isinstance(module, common.SepConvRelu)
                  else module.weight)
        cins.append(weight.shape[1])
    handles = [m.register_forward_pre_hook(hook)
               for m in engine.model.modules()
               if isinstance(m, (common.ConvRelu, common.SepConvRelu))]
    try:
        with torch.inference_mode():
            calls = record_outputs(int8_conv, ("int8_conv", "quantize_act"),
                                   lambda: engine.forward(images))
    finally:
        for h in handles:
            h.remove()
    if len(cins) != len(calls["int8_conv"]):
        raise AssertionError(f"{len(cins)} int8 layers ran "
                             f"{len(calls['int8_conv'])} int8_conv calls")
    return calls, cins


def int8_groups(calls, cins) -> dict:
    """A forward's int8_conv calls by shape: {(q shape, Cin, Cout,
    kernel, stride, bf16 out): [args, output, layers]}."""
    groups: dict = {}
    for (args, out), cin in zip(calls["int8_conv"], cins):
        q, k, stride, s_out = args[0], args[2], args[5], args[7]
        key = (tuple(q.shape), cin, out.shape[-1], k, stride, s_out is None)
        groups.setdefault(key, [args, out, 0])[2] += 1
    return groups


def int8_phase(torch, np, images, counted, dev, gpu) -> dict:
    """Phase 11 (module docstring): calibrated int8 serving at full width;
    returns the kernels line's entries of int8_conv and quantize_act."""
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.ops.cuda import int8_conv

    worst = {"int8_conv": 0.0, "quantize_act": 0.0}
    checked = set()

    def check_kernel(name, args):
        """kernel vs plain on the card on `args`: bit-equal."""
        key = (name, tuple(tuple(a.shape) if hasattr(a, "shape") else a
                           for a in args))
        if key in checked:
            return
        checked.add(key)
        fn = getattr(int8_conv, name)
        with torch.inference_mode():
            out, ref = fn(*args), getattr(int8_conv, name + "_plain")(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} {key[1]} differs from its plain "
                                 "version")
        worst[name] = max(worst[name], float((out.float() - ref.float())
                                             .abs().max()))

    line = {}
    for name in INT8_MODELS:
        bf16, engine, gains = int8_engines(torch, name, images, dev)
        mc, m = engine.config.model, engine.config.postproc.max_humans
        scales = torch.stack(engine._calib)    # every calib buffer
        if bool(scales.any()):
            raise AssertionError(f"int8 {name}: scales before calibration")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.calibrate(images)
        torch.cuda.synchronize()
        calib_ms = (time.perf_counter() - t0) * 1e3
        scales = torch.stack(engine._calib)
        if not bool(scales.min() > 0):
            raise AssertionError(f"int8 {name}: "
                                 f"{int((scales <= 0).sum())} of "
                                 f"{scales.numel()} scales are still 0 "
                                 "after calibration")
        n_convs, n_quant = int8_layers(common, engine.model)

        # every int8 conv of a forward through the kernel; the main path
        engine.infer(images)                   # warm-up (weights cached)
        torch.cuda.synchronize()
        int8_conv.launches = int8_conv.quantize_launches = 0
        out, n = launches_during(torch, counted, lambda: engine.infer(images))
        n.update(int8_conv=int8_conv.launches,
                 quantize_act=int8_conv.quantize_launches)
        check_launches(f"int8 {name}", n, 1, 0)
        if (n["int8_conv"], n["quantize_act"]) != (n_convs, n_quant):
            raise AssertionError(
                f"int8 {name}: {n['int8_conv']} int8_conv and "
                f"{n['quantize_act']} quantize_act launches, expected "
                f"{n_convs} and {n_quant}")
        check_humans(torch, f"int8 {name}", out, m, dev)
        ref_out = bf16.infer(images)
        missing = (ref_out.num_humans > 0) & (out.num_humans == 0)
        if bool(missing.any()):
            raise AssertionError(f"int8 {name}: no humans where bf16 finds "
                                 f"{ref_out.num_humans.tolist()}")

        # kernel forward == plain-routed forward, and every layer's kernel
        # call == its plain version on the same inputs
        names = ("int8_conv", "quantize_act")
        kern, cins = int8_forward_calls(torch, common, int8_conv, engine,
                                        images)
        with torch.inference_mode():
            plain = routed_plain(int8_conv, lambda: record_outputs(
                int8_conv, names, lambda: engine.forward(images)))
        for key in names:
            if len(kern[key]) != len(plain[key]):
                raise AssertionError(f"int8 {name}: {key} calls differ")
            for (args, o), (_, r) in zip(kern[key], plain[key]):
                if not torch.equal(o, r):
                    raise AssertionError(f"int8 {name}: a {key} output of "
                                         "the forward differs from the "
                                         "plain-routed one")
                check_kernel(key, args)
        maps = engine.forward(images)
        ratios = check_map_scale(torch, f"int8 {name} kernel vs plain",
                                 maps, routed_plain(
                                     int8_conv, lambda: engine.forward(
                                         images)), INT8_PLAIN_TOL)
        conf8, conf16 = maps[0].flatten(), bf16.forward(images)[0].flatten()
        cosine = float(conf8 @ conf16 / (conf8.norm() * conf16.norm()))
        if not cosine > INT8_COSINE:
            raise AssertionError(f"int8 {name}: conf cosine {cosine} vs "
                                 "bf16")
        log(f"int8 {name}: {n_convs} int8 layers, launches {n}; humans "
            f"{out.num_humans.tolist()} (bf16 "
            f"{ref_out.num_humans.tolist()}); forward == plain-routed "
            f"({len(kern['int8_conv'])} int8_conv and "
            f"{len(kern['quantize_act'])} quantize_act outputs equal, maps "
            f"{ratios}); conf cosine vs bf16 {cosine:.5f}")

        # timings: the forwards, infer, calibration, the bound
        flops = int8_flops(torch, common, engine.model, images)
        fwd8 = graph_ms(lambda: engine.forward(images), dev)
        fwd16 = graph_ms(lambda: bf16.forward(images), dev)
        bound_ms, bound_by = bound(io_bytes(images), flops["int8"]
                                   / INT8_OPS_PER_S + flops["bf16"]
                                   / BF16_FLOPS + flops["f32"] / F32_FLOPS)
        log(json.dumps({"int8": {
            "model": name, "batch": BATCH, "hw": [mc.hin, mc.win],
            "stages": mc.n_stages, "int8_layers": n_convs,
            "quantize_passes": n_quant, "launches": n,
            "humans": out.num_humans.tolist(),
            "humans_bf16": ref_out.num_humans.tolist(),
            "conf_cosine_vs_bf16": cosine, "head_gains": gains,
            "forward_device_ms": fwd8, "bf16_forward_device_ms": fwd16,
            "forward_over_bf16": fwd8 / fwd16,
            "infer_ms": median_ms(torch, lambda: engine.infer(images)),
            "bf16_infer_ms": median_ms(torch, lambda: bf16.infer(images)),
            "calibrate_ms": calib_ms, "forward_flops": flops,
            "forward_bound_ms": bound_ms, "forward_bound_by": bound_by,
            "forward_pct_of_bound": 100.0 * bound_ms / fwd8,
            "gpu": gpu}}))

        # per shape group: the kernel, its plain version, torch._int_mm
        # (1x1 layers where K and N are multiples of 8) and the bf16 cuDNN
        # conv that the int8 layer replaces
        groups = int8_groups(kern, cins)
        totals = {key: 0.0 for key in ("ms", "plain_ms", "device_ms",
                                       "bound_ms", "library_ms",
                                       "library_device_ms", "cudnn_ms",
                                       "cudnn_device_ms")}
        totals["library_layers"] = 0
        # int8_conv's own device time on the layers torch._int_mm was timed
        # on, the pair per shape group: [q, Cout, layers, kernel, _int_mm]
        totals["library_layers_kernel_device_ms"] = 0.0
        library_pairs = []
        for (shape, cin, cout, k, stride, bf16_out), (args, o, count) in (
                sorted(groups.items())):
            t = time_int8_group(torch, common, int8_conv, args, o, cin)
            log(json.dumps({"kernel_times": {
                "name": "int8_conv", "model": name, "batch": BATCH,
                "q": [*shape[:3], cin], "q_channels": shape[3],
                "cout": cout, "kernel": k,
                "stride": stride, "out": "bf16" if bf16_out else "int8",
                "layers": count, **t, "gpu": gpu}}))
            for key in totals:
                if t.get(key) is not None:
                    totals[key] += count * t[key]
            if t["library_ms"] is not None:
                totals["library_layers"] += count
                totals["library_layers_kernel_device_ms"] += (
                    count * t["device_ms"])
                library_pairs.append([[*shape[:3], cin], cout, count,
                                      t["device_ms"],
                                      t["library_device_ms"]])
        quant = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                 "bound_ms": 0.0}
        for args, _ in kern["quantize_act"]:
            t = time_quantize(torch, int8_conv, args)
            for key in quant:
                quant[key] += t[key]
        log(json.dumps({"int8_forward_layers": {
            "model": name, "batch": BATCH, "layers": n_convs,
            "groups": len(groups), **totals,
            "library_pairs": library_pairs,
            "pct_of_bound": 100.0 * totals["bound_ms"]
            / totals["device_ms"], "quantize_act": quant, "gpu": gpu}}))
        if name == INT8_MODELS[0]:
            line = {
                "int8_conv": dict(
                    totals, launches=n["int8_conv"],
                    max_abs_err=worst["int8_conv"], bound_by="operations",
                    library_ms=None,
                    shape=f"the {n_convs} layers of one batch-{BATCH} "
                          f"{name} int8 forward (no one PyTorch call "
                          "computes an int8 conv; torch._int_mm and the "
                          "bf16 cuDNN conv are in the per-shape lines)"),
                "quantize_act": dict(
                    quant, launches=n["quantize_act"],
                    max_abs_err=worst["quantize_act"], bound_by="bytes",
                    library_ms=None,
                    shape=f"the {n_quant} passes of one batch-{BATCH} "
                          f"{name} int8 forward")}
        del engine, bf16
        torch.cuda.empty_cache()
    line["int8_conv"]["max_abs_err"] = worst["int8_conv"]
    line["quantize_act"]["max_abs_err"] = worst["quantize_act"]
    return line


def time_int8_group(torch, common, int8_conv, args, out, cin) -> dict:
    """One int8_conv shape, a conv over `cin` channels: the kernel (event
    and device ms), its plain version (event ms), the bound; torch._int_mm
    on the same int32 product where the layer is a 1x1 and K and N are
    multiples of 8 (`library_*`), and the bf16 cuDNN conv of the same
    shape, channels-last, that the int8 layer replaces (`cudnn_*`); the
    yardsticks without the channel padding."""
    q, wp, k, rs, bias, stride, pads, s_out = args
    cout = out.shape[-1]
    calls = {"": lambda: int8_conv.int8_conv(*args),
             "plain_": lambda: int8_conv.int8_conv_plain(*args)}
    x16 = q[..., :cin].to(torch.bfloat16).permute(0, 3, 1, 2)
    w16 = wp.view(cout, k, k, -1)[..., :cin].permute(0, 3, 1, 2).to(
        torch.bfloat16)
    calls["cudnn_"] = lambda: common.conv2d_same(x16, w16, stride)
    mat = k == 1 and cin % 8 == 0 and cout % 8 == 0 and q.numel() > 16 * cin
    if mat:
        a2 = q[..., :cin].reshape(-1, cin)
        b2 = wp[:, :cin].contiguous().t()  # (Cin, Cout), column-major
        calls["library_"] = lambda: torch._int_mm(a2, b2)
    t = {}
    for key, fn in calls.items():
        t[f"{key}ms"] = median_ms(torch, fn)
        if key != "plain_":
            t[f"{key}device_ms"] = graph_ms(fn, q.device)
    if not mat:
        t["library_ms"] = t["library_device_ms"] = None
    t["bound_ms"], t["bound_by"] = int8_bound(q, cin, k, out)
    t["pct_of_bound"] = 100.0 * t["bound_ms"] / t["device_ms"]
    t["plan"] = plan_of(int8_conv, args)
    return t


def plan_times(torch, int8_conv, args) -> dict:
    """{"BMxBN": device ms} of the int8_conv call `args` under each tile
    plan of the port's `PLANS` (the wrapper's `tile_plan` replaced for the
    call), each output checked equal to the chosen plan's; {} for a port
    without plans."""
    plans = getattr(int8_conv, "PLANS", ())
    if not plans:
        return {}
    chosen, times = int8_conv.tile_plan, {}
    with torch.inference_mode():
        ref = int8_conv.int8_conv(*args)
        for plan in plans:
            int8_conv.tile_plan = lambda *a, _plan=plan: _plan
            try:
                if not torch.equal(int8_conv.int8_conv(*args), ref):
                    raise AssertionError(f"int8_conv under plan {plan} "
                                         "differs from the chosen plan's")
                times["x".join(map(str, plan))] = graph_ms(
                    lambda: int8_conv.int8_conv(*args), args[0].device)
            finally:
                int8_conv.tile_plan = chosen
    return times


def plan_of(int8_conv, args):
    """The tile plan [block_m, block_n] the int8_conv wrapper takes for
    these arguments (None for a port without `tile_plan`)."""
    tile_plan = getattr(int8_conv, "tile_plan", None)
    if tile_plan is None:
        return None
    q, wp, k, _, _, stride, pads = args[:7]
    b, h, w, c = q.shape
    return list(tile_plan(b, h, w, int8_conv.padded(c), wp.shape[0], k,
                          stride, pads))


def quantize_bound(x, padded) -> float:
    """quantize_act's bound on x: 2 bytes read an element, and its int8
    output written, the channel padding's zeros included (rows of
    `padded` channels)."""
    rows = x.numel() // x.shape[-1]
    return bound(io_bytes(x) + rows * padded, 4 * x.numel() / F32_FLOPS)[0]


def time_quantize(torch, int8_conv, args) -> dict:
    """One quantize_act call: kernel event and device ms, plain event ms,
    the bound (`quantize_bound`)."""
    t = {"ms": median_ms(torch, lambda: int8_conv.quantize_act(*args)),
         "plain_ms": median_ms(
             torch, lambda: int8_conv.quantize_act_plain(*args)),
         "device_ms": graph_ms(lambda: int8_conv.quantize_act(*args),
                               args[0].device)}
    x = args[0]
    t["bound_ms"] = quantize_bound(x, int8_conv.padded(x.shape[-1]))
    return t


def int8_kernels_of(torch, np, tree, dev, gpu) -> None:
    """--int8-kernels-of: the int8_conv and quantize_act kernels of the
    port in `tree` (imported) at every shape group of its own calibrated
    full-width int8 forwards of INT8_MODELS (phase 11's engines, on seeded
    images), each group checked bit-equal to its plain version, then timed
    by CUDA-graph replay; one `int8_kernels` line a model: each conv group
    [q, Cout, kernel, stride, out, layers, device ms, tile plan, {plan:
    device ms} of every plan of the tree's `PLANS`] and each quantize group
    [x shape, passes, device ms, bound ms], the layers' and the passes'
    device ms summed over a forward."""
    from openpose_plus_tpu_torch import default_config
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.ops.cuda import int8_conv

    for name in INT8_MODELS:
        mc = default_config(name).model
        images = torch.from_numpy(np.random.default_rng(11).integers(
            0, 256, (BATCH, mc.hin, mc.win, 3), dtype=np.uint8)).to(dev)
        bf16, engine, _ = int8_engines(torch, name, images, dev)
        engine.calibrate(images)
        calls, cins = int8_forward_calls(torch, common, int8_conv, engine,
                                         images)
        groups, total = [], 0.0
        for (shape, cin, cout, k, stride, bf16_out), (args, _, count) in (
                sorted(int8_groups(calls, cins).items())):
            with torch.inference_mode():
                if not torch.equal(int8_conv.int8_conv(*args),
                                   int8_conv.int8_conv_plain(*args)):
                    raise AssertionError(f"{tree} {name} {shape} -> {cout}:"
                                         " kernel differs from its plain "
                                         "version")
            ms = graph_ms(lambda: int8_conv.int8_conv(*args), dev)
            groups.append([[*shape[:3], cin], cout, k, stride,
                           "bf16" if bf16_out else "int8", count, ms,
                           plan_of(int8_conv, args),
                           plan_times(torch, int8_conv, args)])
            total += count * ms
        quant: dict = {}
        for args, _ in calls["quantize_act"]:
            quant.setdefault(tuple(args[0].shape), [args, 0])[1] += 1
        q_groups, q_total = [], 0.0
        for shape, (args, count) in sorted(quant.items()):
            with torch.inference_mode():
                if not torch.equal(int8_conv.quantize_act(*args),
                                   int8_conv.quantize_act_plain(*args)):
                    raise AssertionError(f"{tree} {name} quantize {shape}: "
                                         "kernel differs from its plain "
                                         "version")
            ms = graph_ms(lambda: int8_conv.quantize_act(*args), dev)
            q_groups.append([list(shape), count, ms, quantize_bound(
                args[0], int8_conv.padded(shape[-1]))])
            q_total += count * ms
        log(json.dumps({"int8_kernels": {
            "tree": tree, "model": name, "batch": BATCH, "groups": groups,
            "layers": len(cins), "layers_device_ms": total,
            "quantize_groups": q_groups,
            "passes": len(calls["quantize_act"]),
            "quantize_device_ms": q_total, "gpu": gpu}}))
        del bf16, engine, calls
        torch.cuda.empty_cache()


def mma_ceiling(build) -> None:
    """--mma-ceiling: builds and runs probes/mma_ceiling.cu, the TOPS of
    `mma.sync` m16n8k32 s8 and m16n8k16 bf16 issued from registers with no
    memory traffic, at 4, 8 and 16 warps a block, and of `wgmma`
    m64n128k32 s8 and m64n128k16 bf16 from shared memory at 1, 2 and 3
    warpgroups a block, one block an SM."""
    out_dir = build.BUILD_ROOT / "mma_ceiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "mma_ceiling"
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe),
                    os.path.join(HERE, "probes", "mma_ceiling.cu")],
                   check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True)
    for line in run.stdout.splitlines():
        log(f"mma ceiling: {line}")


def int8_phases(torch, np, build, int8_conv, inputs, dev, gpu) -> None:
    """--int8-phases: where a block of the int8 conv spends its time.
    Builds csrc/int8_conv.cu alone with INT8_CONV_PHASES defined (clock64
    stamps at five points of every block, read back by
    `int8_conv_phases`), runs the wrapper on that library at each of
    INT8_PHASE_SHAPES (seeded inputs, the output checked equal to the plain
    version) and prints one `int8_phases` line a shape: the tile plan, the
    blocks, the SM clocks from a block's start to each phase (set-up, first
    stage arrived, products done, tile staged, rows stored) at the 10th,
    50th and 90th percentile over the first 4096 blocks of one launch, and
    the device ms of the stamped and of the regular build."""
    import ctypes

    out_dir = build.BUILD_ROOT / "int8_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libint8_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DINT8_CONV_PHASES",
                    "-shared", "-o", str(so),
                    str(build.CSRC / "int8_conv.cu")],
                   check=True, capture_output=True)
    stamped = ctypes.CDLL(str(so))
    stamped.int8_conv_launch.argtypes = build._SIGNATURES["int8_conv_launch"]
    stamped.int8_conv_phases.argtypes = [ctypes.c_void_p]
    stamped.int8_conv_launch.restype = ctypes.c_int
    stamped.int8_conv_phases.restype = ctypes.c_int
    regular = build.load
    stamps = np.zeros((4096, 6), np.int64)
    rng = np.random.default_rng(0)
    for b, h, w, cin, cout, k, quant in INT8_PHASE_SHAPES:
        q, weight, bias, s_in, s_out = inputs.int8_conv_inputs(
            rng, b, h, w, cin, cout, k)
        qw, wmax = int8_conv.quantize_weight(torch.from_numpy(weight))
        pads = (k // 2, k // 2)
        args = [torch.from_numpy(q).to(dev),
                int8_conv.pack_weight(qw).to(dev), k,
                int8_conv.rescale(torch.tensor(s_in, device=dev),
                                  wmax.to(dev)),
                torch.from_numpy(bias).to(dev), 1, pads,
                torch.tensor(s_out, device=dev) if quant else None]

        def call():
            return int8_conv.int8_conv(*args)

        with torch.inference_mode():
            ms = graph_ms(call, dev)
            ref = int8_conv.int8_conv_plain(*args)
            build.load = lambda: stamped
            try:
                if not torch.equal(call(), ref):
                    raise AssertionError(f"int8 phases {b, h, w, cin, cout, k}"
                                         ": the stamped kernel differs")
                stamped_ms = graph_ms(call, dev)
                call()
                torch.cuda.synchronize()
            finally:
                build.load = regular
        if stamped.int8_conv_phases(stamps.ctypes.data) != 0:
            raise RuntimeError("int8_conv_phases: copy failed")
        plan = int8_conv.tile_plan(b, h, w, cin, cout, k, 1, pads)
        blocks = -(-b * h * w // plan[0]) * -(-cout // plan[1])
        st = stamps[:min(blocks, len(stamps))]
        clocks = {name: np.percentile(st[:, i] - st[:, 0],
                                      [10, 50, 90]).tolist()
                  for i, name in enumerate(("setup", "first_stage",
                                            "products", "staged", "stored"),
                                           start=1)}
        log(json.dumps({"int8_phases": {
            "shape": [b, h, w, cin, cout, k, "int8" if quant else "bf16"],
            "plan": list(plan), "blocks": blocks,
            "clocks_from_start_p10_50_90": clocks, "device_ms": ms,
            "stamped_device_ms": stamped_ms, "max_sm_mhz": max_sm_mhz(),
            "gpu": gpu}}))
        del args, ref
        torch.cuda.empty_cache()


# a fresh process: load the artifacts phase 12 exported, serve the batch
# (the first call captures, the next replays) and trace one replay of each
# artifact in this process's only profiler session
_LOAD_ARTIFACTS = """
import json, sys, time
import numpy as np
import torch
from chip_smoke import graph_bytes, replay_trace
from openpose_plus_tpu_torch import export
from openpose_plus_tpu_torch.ops.cuda import (greedy, int8_conv, merge,
                                              paf_sample, sepconv)
tmp = sys.argv[1]
images = torch.from_numpy(np.load(tmp + "/images.npy"))
counted = {"greedy_assign": greedy, "assemble": merge,
           "sample_paf": paf_sample, "fused_sepconv": sepconv,
           "int8_conv": int8_conv}


def launches(fn):
    torch.cuda.synchronize()
    for module in counted.values():
        module.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: m.launches for k, m in counted.items()}


res, engines = {}, {}
for label in sys.argv[2:]:
    t0 = time.perf_counter()
    engine = engines[label] = export.load_engine(tmp + "/" + label)
    load_s = time.perf_counter() - t0
    x = images.to(engine.device)
    (out, n), nbytes = graph_bytes(torch, lambda: launches(
        lambda: engine.infer(x)))
    again, n_replay = launches(lambda: engine.infer(x))
    ref = np.load(tmp + "/" + label + "/eager.npz")
    res[label] = {
        "load_s": load_s, "launches": n, "replay_launches": n_replay,
        "equal": all(np.array_equal(getattr(out, f).cpu().numpy(), ref[f])
                     for f in export.FIELDS),
        "equal_replay": all(np.array_equal(getattr(again, f).cpu().numpy(),
                                           ref[f]) for f in export.FIELDS),
        "graph_bytes": nbytes}
on_device = {label: images.to(e.device) for label, e in engines.items()}
trace = replay_trace(torch, {label: (lambda e=e, x=on_device[label]:
                                     e.infer(x))
                             for label, e in engines.items()})
for label, got in trace.items():
    res[label].update(kernels_per_replay=got["kernels"],
                      device_events_per_replay=got["device_events"],
                      busy_ms=got["busy_ms"])
res["port_modules"] = sorted(
    m for m in sys.modules if m.startswith(("openpose_plus_tpu_torch.models",
                                            "openpose_plus_tpu_torch.engine")))
print(json.dumps(res))
"""


REPLAY_KERNELS = ("greedy_assign_kernel", "assemble_kernel",
                  "sample_paf_kernel", "fused_sepconv_kernel",
                  "int8_conv_kernel", "quantize")


def replay_trace(torch, calls: dict, gap_s: float = TRACE_GAP_S) -> dict:
    """One torch.profiler session over one call of each of `calls` ({label:
    fn}), `gap_s` apart on an idle card, so each call's device events form
    one cluster of the timeline (one session: records went missing in
    later sessions of one process). Per label: {"kernels": {name: device
    kernels whose name contains it, for REPLAY_KERNELS}, "busy_ms": the
    union of its device intervals, "device_events": their count}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            time.sleep(gap_s)
            fn()
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    clusters, end = [], float("-inf")
    for a, b, name in spans:                # time_range in microseconds
        if a - end > gap_s * 1e6 / 2:
            clusters.append([])
        clusters[-1].append((a, b, name))
        end = max(end, b)
    if len(clusters) != len(calls):
        raise AssertionError(f"replay trace: {len(clusters)} clusters of "
                             f"device events for {len(calls)} calls")
    out = {}
    for label, cluster in zip(calls, clusters):
        busy_us, end = 0.0, float("-inf")
        for a, b, _ in cluster:             # union of intervals
            busy_us += max(0.0, b - max(a, end))
            end = max(end, b)
        out[label] = {
            "kernels": {k: sum(k in name for _, _, name in cluster)
                        for k in REPLAY_KERNELS},
            "busy_ms": busy_us / 1e3, "device_events": len(cluster),
            "span_ms": (end - cluster[0][0]) / 1e3}
    return out


def compiled_case(torch, label, engine, images, other) -> dict:
    """Phase 12 on one engine: eager `infer`, `compile` at the batch of
    `images`, the replay against the eager HumanBatch with no Python
    launch, a held result across the next call; returns the compile's
    seconds and its graph's bytes."""
    from openpose_plus_tpu_torch.engine import infer_step
    from openpose_plus_tpu_torch.ops.cuda import (greedy, int8_conv, merge,
                                                  paf_sample, sepconv)

    counted = (greedy, merge, paf_sample, sepconv, int8_conv)
    eager = engine.infer(images)
    with torch.inference_mode():
        eager_other = infer_step(engine.model, other,
                                 engine.config.postproc)
    t0 = time.perf_counter()
    _, nbytes = graph_bytes(torch, lambda: engine.compile(images.shape[0]))
    compile_s = time.perf_counter() - t0
    for module in counted:
        module.launches = 0
    int8_conv.quantize_launches = 0
    out = engine.infer(images)
    torch.cuda.synchronize()
    python_launches = sum(m.launches for m in counted) + (
        int8_conv.quantize_launches)
    if python_launches:
        raise AssertionError(f"deploy {label}: the replay launched "
                             f"{python_launches} kernels from Python")
    assert_batches_equal(torch, f"deploy {label}: replay vs eager", out,
                         eager)
    held = engine.infer(images)
    snapshot = {f.name: getattr(held, f.name).clone()
                for f in dataclasses.fields(held)}
    assert_batches_equal(torch, f"deploy {label}: replay of other images",
                         engine.infer(other), eager_other)
    torch.cuda.synchronize()
    for name, t in snapshot.items():
        if not torch.equal(getattr(held, name), t):
            raise AssertionError(f"deploy {label}: a held result's {name} "
                                 "changed at the next call")
    log(f"deploy {label}: compiled replay == eager, no Python launch, held "
        "result intact")
    return {"compile_s": compile_s, "graph_bytes": nbytes}


def deploy_phase(torch, np, engine, fused_engine, images, n_fused, dev,
                 gpu) -> None:
    """Phase 12 (module docstring): compile, export, stream and the CLI on
    the card."""
    import tempfile

    import cv2

    from openpose_plus_tpu_torch import Engine, export, host, stream
    from openpose_plus_tpu_torch import engine as engine_mod
    from openpose_plus_tpu_torch.data.augment import letterbox
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.ops.cuda import (greedy, int8_conv, merge,
                                                  paf_sample, sepconv)

    rng = np.random.default_rng(12)
    other = torch.from_numpy(rng.integers(0, 256, tuple(images.shape),
                                          dtype=np.uint8)).to(dev)
    # copies on the same weights: the phase 4 engines stay eager
    default, fused = (Engine(e.config, params=e.model.state_dict(),
                             device=dev) for e in (engine, fused_engine))
    _, int8, _ = int8_engines(torch, "vgg19", images, dev)
    int8.calibrate(images)
    n_convs, n_quant = int8_layers(common, int8.model)
    mc = default.config.model
    line = {"model": mc.name, "hw": [mc.hin, mc.win],
            "dtype": mc.compute_dtype, "stages": mc.n_stages}
    cases = {"batch8": (default, images, {}),
             "batch1": (default, images[:1], {}),
             "fused_batch8": (fused, images,
                              {"fused_sepconv_kernel": n_fused}),
             "int8_vgg19_batch8": (int8, images, {"int8_conv_kernel": n_convs,
                                                  "quantize": n_quant})}
    for label, (eng, imgs, _) in cases.items():
        line[label] = compiled_case(torch, label, eng, imgs,
                                    other[:imgs.shape[0]])
    # the int8 engine's flip-TTA: captured at its first call, replayed
    # bit-equal to the eager call, launching nothing from Python
    int8_counted = {"greedy_assign": greedy, "assemble": merge,
                    "sample_paf": paf_sample, "fused_sepconv": sepconv,
                    "int8_conv": int8_conv}
    rec = replayed_path(
        torch, int8_counted, "int8 VGG19 flip-TTA",
        lambda: int8.infer(images, flip_tta=True),
        lambda: engine_mod.infer_tta(int8.model, images,
                                     int8.config.postproc), 1, 0)
    if rec["eager_launches"]["int8_conv"] != 2 * n_convs:
        raise AssertionError(f"int8 VGG19 flip-TTA launches "
                             f"{rec['eager_launches']}")
    line["int8_vgg19_flip_tta"] = {"graph_bytes": rec["graph_bytes"]}
    # the kernels of one replay of each graph, by name, in one trace: the
    # compiled engines, and phase 5's flip-TTA and scale-search graphs of
    # phase 4's engines (phase 5 captured them) and the int8 flip-TTA
    per_decode = dict.fromkeys(REPLAY_KERNELS[:3], 1)
    accuracy = {
        "flip_tta_default": (lambda: engine.infer(images, flip_tta=True),
                             per_decode),
        "flip_tta_fused": (lambda: fused_engine.infer(images, flip_tta=True),
                           {**per_decode,
                            "fused_sepconv_kernel": 2 * n_fused}),
        "multiscale_avg_fused": (lambda: fused_engine.infer_multiscale(
            images, SCALES, flip_tta=True, combine="avg"),
            {**per_decode, "fused_sepconv_kernel": 6 * n_fused}),
        "multiscale_dedup_fused": (lambda: fused_engine.infer_multiscale(
            images, SCALES, flip_tta=True, combine="dedup"),
            {**dict.fromkeys(REPLAY_KERNELS[:3], len(SCALES)),
             "fused_sepconv_kernel": 6 * n_fused}),
        "int8_vgg19_flip_tta": (lambda: int8.infer(images, flip_tta=True),
                                {**per_decode,
                                 "int8_conv_kernel": 2 * n_convs,
                                 "quantize": 2 * n_quant})}
    trace = replay_trace(torch, {
        **{label: functools.partial(eng.infer, imgs)
           for label, (eng, imgs, _) in cases.items()},
        **{label: fn for label, (fn, _) in accuracy.items()}})
    expected = {**{label: expect for label, (_, _, expect) in cases.items()},
                **{label: expect for label, (_, expect) in accuracy.items()}}
    for label, expect in expected.items():
        want = {**dict.fromkeys(REPLAY_KERNELS[:3], 1),
                **dict.fromkeys(REPLAY_KERNELS[3:], 0), **expect}
        got = trace[label]
        if got["kernels"] != want:
            raise AssertionError(f"deploy {label}: kernels of one replay "
                                 f"{got['kernels']}, expected {want}")
        line.setdefault(label, {}).update(
            kernels_per_replay=got["kernels"],
            device_events_per_replay=got["device_events"],
            busy_ms=got["busy_ms"])
    log(f"deploy: one replay of each graph traced, kernels by name "
        f"{ {k: v['kernels'] for k, v in trace.items()} }")
    del cases
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=HERE)
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".smoke_bank_deploy_") as tmp:
        # export at batch 8 (the int8 engine calibrated), reload in a fresh
        # process; each reloaded artifact is held against the compiled
        # engine's HumanBatch
        line["export"] = {}
        labels = {"default": (default, {}),
                  "fused": (fused, {"fused_sepconv": n_fused}),
                  "int8_vgg19": (int8, {"int8_conv": n_convs})}
        for label, (eng, _) in labels.items():
            t0 = time.perf_counter()
            export.save_engine(eng, os.path.join(tmp, label),
                               batch_size=BATCH)
            line["export"][label] = {"export_s": time.perf_counter() - t0}
            out = eng.infer(images)
            np.savez(os.path.join(tmp, label, "eager.npz"),
                     **{f: getattr(out, f).cpu().numpy()
                        for f in export.FIELDS})
        np.save(os.path.join(tmp, "images.npy"), images.cpu().numpy())
        proc = subprocess.run(
            [sys.executable, "-c", _LOAD_ARTIFACTS, tmp, *labels],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"loading the artifacts failed:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        if loaded.pop("port_modules"):
            raise AssertionError("loading an artifact imported the model "
                                 "code")
        from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP

        k = CAPTURE_WARMUP + 1
        for label, (_, expect) in labels.items():
            got = loaded[label]
            n = got["launches"]
            want = {**{name: k for name in ("greedy_assign", "assemble",
                                            "sample_paf")},
                    "fused_sepconv": 0, "int8_conv": 0,
                    **{name: k * v for name, v in expect.items()}}
            if not (got["equal"] and got["equal_replay"]) or n != want or any(
                    got["replay_launches"].values()):
                raise AssertionError(f"artifact {label} in a fresh process: "
                                     f"{got}, expected first-call launches "
                                     f"{want} and none in the replay")
            compiled = line[{"default": "batch8", "fused": "fused_batch8",
                             "int8_vgg19": "int8_vgg19_batch8"}[label]]
            got["compiled_device_events_per_replay"] = compiled[
                "device_events_per_replay"]
            if got["kernels_per_replay"] != compiled["kernels_per_replay"]:
                raise AssertionError(f"artifact {label}: kernels of one "
                                     f"replay {got['kernels_per_replay']}, "
                                     f"the compiled engine's "
                                     f"{compiled['kernels_per_replay']}")
            line["export"][label].update(got)
        log(f"deploy: artifacts reloaded in a fresh process replay one graph "
            f"a call equal to the compiled engines', first-call launches "
            f"{[loaded[k]['launches'] for k in labels]}, no model code "
            "imported")

        # run_frames: every batch equals infer on its letterboxed batch
        est = stream.StreamEstimator(default, batch=BATCH)
        frames = [rng.integers(0, 256, (int(rng.integers(48, 721)),
                                        int(rng.integers(48, 1281)), 3),
                               dtype=np.uint8) for _ in range(DEPLOY_FRAMES)]
        results = list(est.run_frames(frames))
        sizes = [min(BATCH, DEPLOY_FRAMES - i)
                 for i in range(0, DEPLOY_FRAMES, BATCH)]
        if [r.n for r in results] != sizes:
            raise AssertionError(f"run_frames batches {[r.n for r in results]}"
                                 f", expected {sizes}")
        for r in results:
            boxes = [letterbox(frames[i], mc.hin, mc.win) for i in r.indices]
            served = np.zeros(est.shape, np.uint8)
            served[:r.n] = [host.pack(b[0], est.s2d) for b in boxes]
            np.testing.assert_array_equal(r.scales, np.asarray(
                [b[1] for b in boxes], np.float32))
            np.testing.assert_array_equal(r.pads, np.asarray(
                [b[2] for b in boxes], np.float32))
            assert_batches_equal(torch, "run_frames vs infer", r.humans,
                                 default.infer(torch.from_numpy(served)
                                               .to(dev)))
        log(f"deploy: run_frames over {DEPLOY_FRAMES} frames of mixed sizes "
            "== infer on each letterboxed batch")

        # the CLI in fresh processes, on cv2-written JPEGs
        jpgs = []
        for i in range(3):
            jpgs.append(os.path.join(tmp, f"cli{i}.jpg"))
            cv2.imwrite(jpgs[-1], rng.integers(0, 256, (*DEPLOY_FRAME_HW, 3),
                                               dtype=np.uint8))
        art = os.path.join(tmp, "cli_engine")
        line["cli_s"] = {}
        for label, argv in (
                ("infer", ["infer", "--images", *jpgs, "--batch", "2"]),
                ("export", ["export", "--out", art, "--batch", "2"]),
                ("infer_engine_dir", ["infer", "--images", *jpgs,
                                      "--engine-dir", art])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "openpose_plus_tpu_torch", *argv],
                cwd=HERE, env=env, capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"python -m openpose_plus_tpu_torch "
                                     f"{label}: rc {proc.returncode}\n"
                                     f"{proc.stdout}\n{proc.stderr}")
            line["cli_s"][label] = time.perf_counter() - t0
        log(f"deploy: python -m openpose_plus_tpu_torch infer, export, infer "
            f"--engine-dir: rc 0 ({line['cli_s']})")
    log(json.dumps({"deploy": {**line, "gpu": gpu}}))


def stream_files(np, cv2, tmp) -> tuple[list, list, str]:
    """Phase 13's files in `tmp`: STREAM_JPEGS 640x480 JPEGs of seeded
    photo-like content (smooth colour fields and sensor-like noise),
    STREAM_PNGS PNGs of mixed sizes and one unreadable file."""
    rng = np.random.default_rng(13)

    def picture(h, w):
        coarse = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
        smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        noise = rng.normal(0.0, 4.0, (h, w, 3))
        return np.clip(smooth + noise, 0, 255).astype(np.uint8)

    jpgs, pngs = [], []
    for i in range(STREAM_JPEGS):
        jpgs.append(os.path.join(tmp, f"photo{i:03d}.jpg"))
        cv2.imwrite(jpgs[-1], picture(*DEPLOY_FRAME_HW),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    for i, hw in enumerate(((300, 500), (720, 1280), (368, 432), (97, 61))):
        pngs.append(os.path.join(tmp, f"still{i}.png"))
        cv2.imwrite(pngs[-1], picture(*hw))
    bad = os.path.join(tmp, "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    return jpgs, pngs, bad


def oracle_matches(np, what, o_humans, batch, b) -> None:
    """Row b of a HumanBatch against the oracle's humans, by
    tests/test_postproc_parity.py's criteria: the same count, and each
    oracle human matched once by part set and count, mean score and every
    part's coordinates and score within 1e-3."""
    valid = batch.valid[b].cpu().numpy()
    rows = []
    for m in np.flatnonzero(valid):
        pv = batch.part_valid[b, m].cpu().numpy()
        vals = np.concatenate([batch.coords[b, m].cpu().numpy(),
                               batch.part_scores[b, m].cpu().numpy()[:, None]],
                              axis=1)
        rows.append(({p: vals[p] for p in np.flatnonzero(pv)},
                     float(batch.score[b, m]), int(batch.n_parts[b, m])))
    if len(rows) != len(o_humans):
        raise AssertionError(f"{what}: {len(rows)} humans on the card, "
                             f"{len(o_humans)} from the oracle")
    unmatched = list(range(len(rows)))
    for oh in o_humans:
        hit = next((i for i in unmatched
                    if rows[i][2] == oh.n_parts
                    and set(rows[i][0]) == set(oh.parts)
                    and abs(rows[i][1] - oh.score / oh.n_parts) <= 1e-3
                    and all(abs(rows[i][0][p][k] - oh.parts[p][k]) < 1e-3
                            for p in oh.parts for k in range(3))), None)
        if hit is None:
            raise AssertionError(f"{what}: no card human matches the "
                                 f"oracle's {oh}")
        unmatched.remove(hit)


def stream_phase(torch, np, engine, scenes, dev, gpu) -> None:
    """Phase 13 (module docstring): the file stream and the grouping oracle
    on the card."""
    import tempfile

    import cv2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from openpose_plus_tpu_torch import Engine, loader, stream
    from openpose_plus_tpu_torch.ops.cuda import greedy, merge, paf_sample
    from openpose_plus_tpu_torch.postproc import decode_maps, nms
    from openpose_plus_tpu_torch.postproc.oracle import decode_oracle

    post = engine.config.postproc
    mc = engine.config.model
    # the grouping oracle on the card's preprocessed maps
    conf, paf = three_people(torch, np, scenes, mc)
    scenes_maps = {"three people": (conf, paf)}
    people = [scenes.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                     0.93 + 0.1 * i) for i in range(3)]
    for seed in STREAM_NOISY_SEEDS:
        c, p = scenes.make_maps(people, mc.hout, mc.wout,
                                noise=STREAM_SCENE_NOISE, seed=seed)
        scenes_maps[f"noisy seed {seed}"] = (
            torch.from_numpy(np.stack([c] * BATCH)),
            torch.from_numpy(np.stack([p] * BATCH)))
    oracle_humans = {}
    for what, (c, p) in scenes_maps.items():
        c, p = c.to(dev), p.to(dev)
        on_card = decode_maps(c, p, post)
        smoothed = nms.upsample_smooth(c, post.upsample_factor,
                                       post.smooth_sigma).cpu().numpy()
        paf_u = nms.upsample(p, post.upsample_factor).cpu().numpy()
        for b in range(BATCH):
            o_humans = decode_oracle(smoothed[b], paf_u[b], post,
                                     preprocessed=True)
            oracle_matches(np, f"oracle, {what}, image {b}", o_humans,
                           on_card, b)
        oracle_humans[what] = len(o_humans)
    if oracle_humans["three people"] != 3:
        raise AssertionError(f"oracle: {oracle_humans}")
    log(f"stream: the card's decode == the numpy grouping oracle on the "
        f"card's preprocessed maps, humans {oracle_humans}")

    # a compiled copy: phase 4's engine stays eager
    served = Engine(engine.config, params=engine.model.state_dict(),
                    device=dev)
    est = stream.StreamEstimator(served, batch=BATCH)
    if served.device.type != "cuda" or est.workers != 8:
        raise AssertionError(f"stream: engine on {served.device}, "
                             f"{est.workers} workers")
    line = {"model": mc.name, "batch": BATCH, "hw": [mc.hin, mc.win],
            "layout": est.s2d, "cpu_count": os.cpu_count(),
            "cpu_affinity": len(os.sched_getaffinity(0)),
            "cv2_threads": cv2.getNumThreads(), "cv2": cv2.__version__,
            "oracle_humans": oracle_humans}
    env = dict(os.environ, PYTHONPATH=HERE)
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".smoke_bank_stream_") as tmp:
        jpgs, pngs, bad = stream_files(np, cv2, tmp)
        paths = [*jpgs[:5], bad, *pngs, *jpgs[5:]]
        line["jpeg_mean_bytes"] = statistics.mean(os.path.getsize(p)
                                                  for p in jpgs)
        counted = (greedy, merge, paf_sample)
        torch.cuda.synchronize()
        for module in counted:
            module.launches = 0
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            results = list(est.run_files(paths))
            torch.cuda.synchronize()
        python_launches = sum(m.launches for m in counted)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        kernels = {k: sum(k in n for n in names)
                   for k in REPLAY_KERNELS[:3]}
        if not results:
            raise AssertionError("run_files yielded no batch")
        if kernels != dict.fromkeys(REPLAY_KERNELS[:3], len(results)) or (
                python_launches):
            raise AssertionError(
                f"run_files over {len(results)} batches: kernels in the "
                f"trace {kernels}, Python launches {python_launches}")
        ref = list(loader.StreamLoader(paths, mc.hin, mc.win, batch=BATCH,
                                       s2d=est.s2d))
        seen = [i for r in results for i in r.indices.tolist()]
        readable = [i for i, p in enumerate(paths) if p != bad]
        if seen != readable or len(ref) != len(results):
            raise AssertionError(f"run_files indices {seen}, expected "
                                 f"{readable}")
        for r, b in zip(results, ref):
            for name in ("indices", "scales", "pads"):
                np.testing.assert_array_equal(getattr(r, name), b[name])
            batch = np.zeros(est.shape, np.uint8)
            batch[:r.n] = b["images"]
            assert_batches_equal(torch, "run_files vs infer", r.humans,
                                 served.infer(torch.from_numpy(batch)
                                              .to(dev)))
        humans = [int(r.humans.num_humans[:r.n].sum()) for r in results]
        line.update(files=len(paths), batches=[r.n for r in results],
                    kernels_per_run=kernels, humans_per_batch=humans)
        log(f"stream: run_files over {len(paths)} files ({len(readable)} "
            f"readable) == infer on each loaded batch, batches "
            f"{line['batches']}, kernels in the trace {kernels}")

        # the CLI in a fresh process
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "openpose_plus_tpu_torch", "stream",
             "--images", os.path.join(tmp, "*.jpg"), "--loop", "--repeat",
             "20"], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0 or "frames in" not in proc.stdout or not all(
                k in proc.stdout for k in ("decode", "resize", "s2d2")):
            raise AssertionError(f"stream --images: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        line["cli_s"] = time.perf_counter() - t0
        line["cli_fps_line"] = next(ln for ln in proc.stdout.splitlines()
                                    if "frames in" in ln)
        log(f"stream: python -m openpose_plus_tpu_torch stream --images "
            f"--loop --repeat 20: rc 0, {line['cli_fps_line']}")

        if cv2.getNumThreads() != line["cv2_threads"]:
            raise AssertionError(f"cv2 threads {cv2.getNumThreads()} after "
                                 f"the loaders closed, {line['cv2_threads']} "
                                 "before")
    log(json.dumps({"stream": {**line, "gpu": gpu}}))
    log(gpu)
    del served, est
    torch.cuda.empty_cache()


# ---------------------------------------------------- 14. distributed ---

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_config(engine_config):
    """Phase 14's training config: phase 4's MobileNet-thin at full width,
    a global batch of BATCH, Adam at TRAIN_LR, no weight decay (as phase
    10)."""
    cfg = engine_config.replace(train=dataclasses.replace(
        engine_config.train, batch_size=BATCH, lr_init=TRAIN_LR,
        weight_decay=0.0, optimizer="adam"))
    check_full_width(cfg)
    return cfg


def parallel_batches(np, mc, count: int) -> list:
    """`count` seeded global batches: random images, PARALLEL_PEOPLE
    people of 18 visible parts an image."""
    rng = np.random.default_rng(14)
    out = []
    for _ in range(count):
        kp = np.zeros((BATCH, PARALLEL_PEOPLE, 18, 3), np.float32)
        kp[..., 0] = rng.uniform(16, mc.win - 16, kp.shape[:3])
        kp[..., 1] = rng.uniform(16, mc.hin - 16, kp.shape[:3])
        kp[..., 2] = 1.0
        out.append({"images": rng.integers(0, 256, (BATCH, mc.hin, mc.win,
                                                    3), dtype=np.uint8),
                    "keypoints": kp,
                    "mask": np.ones((BATCH, mc.hout, mc.wout, 1),
                                    np.float32)})
    return out


def param_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def rank_environment(rank: int, world: int, port: int):
    """torchrun's variables for `rank` of `world` on this host (both ranks
    on device 0), restored on exit."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nccl_world_of_one(torch, engine, images, batch, counted, dev) -> dict:
    """Phase 14.1: one NCCL rank on the card, started from torchrun's
    environment by `init_distributed`: the sync-sgd step (a gradient
    all_reduce over the rank) equals the plain step bit for bit (cuDNN held
    to deterministic algorithms, the plain step run twice first), and
    Engine(mesh=) of size 1 equals `infer`."""
    import torch.distributed as dist

    from openpose_plus_tpu_torch import Engine
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.config import ParallelConfig
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S

    cfg = parallel_config(engine.config)
    with rank_environment(0, 1, free_port()):
        rank_dev = S.init_distributed(ParallelConfig(multihost=True),
                                      device="cuda")
        try:
            backend = dist.get_backend()
            if backend != "nccl" or rank_dev != dev:
                raise AssertionError(f"world of one: {backend} on "
                                     f"{rank_dev}, expected nccl on {dev}")
            mesh = S.build_mesh(ParallelConfig())
            flags = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                steps = []
                for label in ("plain", "plain again", "sync-sgd"):
                    if label == "sync-sgd":
                        state = kf.create_kungfu_state(cfg, mesh, 0, dev)
                        (step,) = kf.make_kungfu_steps(cfg, mesh, label)
                    else:
                        state = T.create_train_state(cfg, 0, dev)
                        step = T.make_train_step_on_batch(cfg)
                    state, m = step(state, batch)
                    steps.append((float(m["loss"]), param_digest(state.model)))
            finally:
                (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = flags
            if steps[0] != steps[1]:
                raise AssertionError(f"the plain step is not deterministic "
                                     f"under cudnn.deterministic: {steps}")
            if steps[2] != steps[0]:
                raise AssertionError(f"sync-sgd on one NCCL rank differs "
                                     f"from the plain step: {steps}")
            sharded = Engine(engine.config,
                             params=engine.model.state_dict(), mesh=mesh,
                             device=dev)
            out, n = launches_during(torch, counted,
                                     lambda: sharded.infer(images))
            check_launches("Engine(mesh=) on one NCCL rank", n, 1, 0)
            assert_batches_equal(torch, "Engine(mesh=) on one NCCL rank vs "
                                 "infer", out, engine.infer(images))
            mesh_ms = median_ms(torch, lambda: sharded.infer(images))
        finally:
            dist.destroy_process_group()
    return {"backend": backend, "world": 1, "sync_sgd_loss": steps[2][0],
            "sync_sgd_equals_plain_step": True,
            "mesh_infer_equals_infer": True, "mesh_launches": n,
            "mesh_infer_ms": mesh_ms}


def gloo_cuda_probe(torch, dist, group, rank: int, world: int, dev) -> dict:
    """Which collectives torch's gloo backend takes on CUDA tensors here:
    each called once on a small tensor on `dev` in its own group; "ok"
    when it ran and gave the right values, else what it raised."""
    x = torch.full((4,), float(rank + 1), device=dev)
    ranks = torch.arange(1, world + 1, device=dev, dtype=x.dtype)
    total = float(ranks.sum())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0, group=group)
        return bool((y == 1).all())

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return bool((y == total).all())

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x, group=group)
        return bool((torch.stack(ys)[:, 0] == ranks).all())

    def all_gather_into_tensor():
        y = x.new_empty(4 * world)
        dist.all_gather_into_tensor(y, x, group=group)
        return bool((y.view(world, 4)[:, 0] == ranks).all())

    def reduce_scatter_tensor():
        y = x.new_empty(4 // world)
        dist.reduce_scatter_tensor(y, x, group=group)
        return bool((y == total).all())

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return bool((y.view(world, -1)[:, 0] == ranks).all())

    def all_to_all_single_uneven():
        # rank r sends r + 1 + j bytes to rank j (the halo exchange's splits)
        send = [r + 1 + j for j in range(world) for r in (rank,)]
        recv = [r + 1 + rank for r in range(world)]
        y = torch.empty(sum(recv), dtype=torch.uint8, device=dev)
        dist.all_to_all_single(
            y, torch.full((sum(send),), rank, dtype=torch.uint8, device=dev),
            recv, send, group=group)
        want = torch.cat([torch.full((n,), r, dtype=torch.uint8, device=dev)
                          for r, n in enumerate(recv)])
        return bool(torch.equal(y, want))

    out = {}
    for call in (broadcast, all_reduce, all_gather, all_gather_into_tensor,
                 reduce_scatter_tensor, all_to_all_single,
                 all_to_all_single_uneven):
        try:
            out[call.__name__] = "ok" if call() else "wrong values"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[call.__name__] = (f"raises {type(e).__name__}: "
                                  f"{str(e).splitlines()[0][:120]}")
    return out


def parallel_rank(rank: int, world: int, port: int, payload: dict,
                  results) -> None:
    """A spawned rank of phase 14.2: its result, or its traceback, on the
    `results` queue."""
    import traceback
    try:
        results.put((rank, True, _parallel_rank(rank, world, port,
                                                payload)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _parallel_rank(rank: int, world: int, port: int, p: dict) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    from openpose_plus_tpu_torch import Engine
    from openpose_plus_tpu_torch.config import ParallelConfig
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine
    from openpose_plus_tpu_torch.ops.cuda import (build, greedy, merge,
                                                  paf_sample, sepconv)
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S
    from openpose_plus_tpu_torch.postproc import HumanBatch

    torch.set_num_threads(4)
    with rank_environment(rank, world, port):
        dev = S.init_distributed(ParallelConfig(multihost=True),
                                 backend="gloo", device=p["device"])
    try:
        if p.get("only_spatial"):
            return {"spatial": _spatial_rank(torch, p, rank, world, dev)}
        build.load()
        counted = {"greedy_assign": greedy, "assemble": merge,
                   "sample_paf": paf_sample, "fused_sepconv": sepconv}
        mesh = S.build_mesh(ParallelConfig())
        _, n, group = S.data_axis(mesh)
        cfg = p["train_cfg"]
        out = {"device": str(dev), "strategies": {}}
        for strategy in kf.STRATEGIES:
            state = kf.create_kungfu_state(cfg, mesh, 0, dev)
            fns = kf.make_kungfu_steps(cfg, mesh, strategy)
            rec = {"losses": [], "digests": [], "checked_ms": []}
            for i, batch in enumerate(p["batches"]):
                local = S.shard_batch(batch, mesh)
                t0 = time.perf_counter()
                state, m = fns[i % len(fns)](state, local)
                rec["losses"].append(float(m["loss"]))   # synchronises
                rec["checked_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["digests"].append(param_digest(state.model))
                if strategy == "sync-sgd" and i == 0 and rank == 0:
                    out["sync_sgd_step1"] = {
                        "loss": rec["losses"][0],
                        "grads": {k: q.grad.float().cpu().numpy().copy()
                                  for k, q in state.model.named_parameters()},
                        "params": {k: q.detach().float().cpu().numpy().copy()
                                   for k, q in
                                   state.model.named_parameters()}}
            local = S.shard_batch(p["batches"][0], mesh)
            rec["step_ms"] = median_ms(torch, lambda: fns[0](state, local))
            bufs = [q.detach().clone() for q in state.model.parameters()]
            size = sum(b.numel() * b.element_size() for b in bufs)
            if strategy == "pair-avg":
                rec["collective"] = (f"all_reduce of an (n/2, P) buffer "
                                     f"(pair_average), rank XOR 1")
                rec["collective_bytes"] = n // 2 * size
                rec["collective_ms"] = median_ms(
                    torch, lambda: kf.pair_average(bufs, 0, group))
            else:
                rec["collective"] = ("all_reduce of the gradients"
                                     if strategy == "sync-sgd" else
                                     "all_reduce of the parameters")
                rec["collective_bytes"] = size
                rec["collective_ms"] = median_ms(
                    torch, lambda: kf.all_reduce_mean(bufs, group))
            out["strategies"][strategy] = rec
        del state, bufs

        images = torch.from_numpy(p["images"]).to(dev)
        sharded = Engine(p["serve_cfg"], seed=0, mesh=mesh, device=dev)
        plain = Engine(p["serve_cfg"], seed=0, device=dev)
        for eng in (sharded, plain):
            scale_heads(torch, eng, None, p["gains"])
        sharded.infer(images)                           # warm-up
        humans, launches = launches_during(torch, counted,
                                           lambda: sharded.infer(images))
        check_launches(f"rank {rank}: Engine(mesh=).infer", launches, 1, 0)
        per = images.shape[0] // n
        ref = HumanBatch.cat([plain.infer(images[r * per:(r + 1) * per])
                              for r in range(n)])
        assert_batches_equal(torch, f"rank {rank}: Engine(mesh=) vs batch-"
                             f"{per} engines on the slices", humans, ref)
        out["mesh"] = {f.name: getattr(humans, f.name).cpu().numpy()
                       for f in dataclasses.fields(humans)}
        out["mesh_maps"] = [t.cpu().numpy() for t in sharded.forward(images)]
        out["mesh_launches"] = launches
        out["mesh_infer_ms"] = median_ms(torch, lambda: sharded.infer(images))
        out["slice_infer_ms"] = median_ms(
            torch, lambda: plain.infer(images[rank * per:(rank + 1) * per]))

        t0 = time.perf_counter()
        res = evaluate_engine(plain, CocoPoseDataset(*p["bank"]),
                              batch_size=BATCH, distributed=True)
        out["eval"] = res.as_dict()
        out["eval_seconds"] = time.perf_counter() - t0

        probe = dist.new_group(backend="gloo",
                               timeout=datetime.timedelta(seconds=30))
        out["gloo_cuda"] = gloo_cuda_probe(torch, dist, probe, rank, n, dev)
        out["spatial"] = _spatial_rank(torch, p, rank, world, dev)
        return out
    finally:
        dist.destroy_process_group()


def run_parallel_ranks(world: int, payload: dict) -> list:
    """`parallel_rank` in `world` spawned processes; their results in rank
    order. A rank that fails, or does not answer within PARALLEL_TIMEOUT_S,
    fails the phase; every process is joined or killed first."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=parallel_rank, daemon=True,
                         args=(r, world, port, payload, results))
             for r in range(world)]
    for proc in procs:
        proc.start()
    out = {}
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(
                    f"parallel ranks {sorted(set(range(world)) - set(out))}"
                    f" did not answer within {PARALLEL_TIMEOUT_S} s") from None
            if not ok:
                raise AssertionError(f"parallel rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    return [out[r] for r in range(world)]


def spatial_configs() -> tuple:
    """Phase 14's spatial configs: MobileNet-thin as the strategies train
    it (`parallel_config`) and VGG19 at its default 368x432 bf16, both with
    phase 10's optimizer and the global batch of BATCH."""
    from openpose_plus_tpu_torch import default_config

    mobilenet = parallel_config(default_config("mobilenet_thin"))
    vgg = default_config("vgg19")
    vgg = vgg.replace(train=mobilenet.train)
    mc = vgg.model
    if (mc.hin, mc.win, mc.compute_dtype) != (368, 432, "bfloat16"):
        raise AssertionError(f"spatial: not the full-width VGG19 {mc}")
    return mobilenet, vgg


def one_process_step(torch, T, cfg, batch, dev, timed: bool = True
                     ) -> tuple:
    """One process's first step on the global batch from the seeded state:
    its loss, gradients, parameters, `max_memory_allocated` in the step and
    what it allocates at its peak beyond what was held before it;
    and, `timed`, the median ms of a step (else the first step's)."""
    state = T.create_train_state(cfg, 0, dev)
    step = T.make_train_step_on_batch(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    state, m = step(state, batch)
    end.record()
    end.synchronize()
    one = {"loss": float(m["loss"]),
           "grads": {k: q.grad.float().cpu().clone()
                     for k, q in state.model.named_parameters()},
           "params": {k: q.detach().float().cpu().clone()
                      for k, q in state.model.named_parameters()},
           "peak_step_bytes": torch.cuda.max_memory_allocated(dev) - before,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    ms = (median_ms(torch, lambda: step(state, batch)) if timed
          else start.elapsed_time(end))
    del state
    torch.cuda.empty_cache()
    return one, ms


def step_vs_one_process(torch, cfg, step1, one, what: str) -> dict:
    """A rank's first step (loss, gradients, parameters after it) against
    one process's on the global batch, under phase 10's card-vs-CPU
    tolerances and a bound of two lr steps on any parameter."""
    grads = {k: torch.from_numpy(v) for k, v in step1["grads"].items()}
    leaf = {k: _rel_l2(torch, grads[k], g) for k, g in one["grads"].items()}
    every = _rel_l2(torch, torch.cat([g.flatten() for g in grads.values()]),
                    torch.cat([g.flatten() for g in one["grads"].values()]))
    param_err = max(float((torch.from_numpy(step1["params"][k]) - q).abs()
                          .max()) for k, q in one["params"].items())
    step_bound = 2 * cfg.train.lr_init * (1 + 1e-3)
    vs_one = {"loss_ranks": step1["loss"], "loss_one_process": one["loss"],
              "loss_rel_err": abs(step1["loss"] - one["loss"]) / one["loss"],
              "grad_rel_l2_all": every,
              "grad_rel_l2_worst_leaf": max(leaf.values()),
              "param_max_abs_err": param_err, "param_bound": step_bound}
    if not (vs_one["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and every <= TRAIN_ALL_RTOL
            and vs_one["grad_rel_l2_worst_leaf"] <= TRAIN_LEAF_RTOL
            and param_err <= step_bound):
        raise AssertionError(f"{what} vs one process: {vs_one}")
    return vs_one


def _spatial_rank(torch, p: dict, rank: int, world: int, dev) -> dict:
    """This rank's part of the spatial axis: sync-sgd on a 1 x world
    (data, spatial) mesh, each model of SPATIAL_MODELS from the seeded
    state on its band of p["batches"]. Per model: each step's loss, wall
    ms and parameter digest; the first step's gradients and parameters
    (rank 0), its traffic (`spatial.STATS`) and the memory it allocated at
    its peak beyond what was held before; the median step ms
    (MobileNet-thin); and one more step with the exchanges and gathers
    timed (the device synchronised around each)."""
    from openpose_plus_tpu_torch.config import ParallelConfig
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S
    from openpose_plus_tpu_torch.parallel import spatial

    mesh = S.build_mesh(ParallelConfig(spatial_parallelism=world))
    out = {"axes": [S.data_axis(mesh)[:2], S.spatial_axis(mesh)[:2]]}
    for name, cfg in zip(SPATIAL_MODELS, p["spatial_cfgs"]):
        steps = PARALLEL_STEPS if name == "mobilenet_thin" \
            else SPATIAL_VGG_STEPS
        state = kf.create_kungfu_state(cfg, mesh, 0, dev)
        (step,) = kf.make_kungfu_steps(cfg, mesh, "sync-sgd")
        rec = {"losses": [], "digests": [], "checked_ms": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        for i, batch in enumerate(p["batches"][:steps]):
            local = S.shard_batch(batch, mesh, stride=cfg.model.stride)
            spatial.reset_stats()
            t0 = time.perf_counter()
            state, m = step(state, local)
            rec["losses"].append(float(m["loss"]))     # synchronises
            rec["checked_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["digests"].append(param_digest(state.model))
            if i == 0:
                rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                    dev)
                rec["peak_step_bytes"] = rec["max_memory_allocated"] - before
                rec["stats"] = dict(spatial.STATS)
                rec["band_rows"] = list(local["images"].shape[1:3])
                if rank == 0:
                    rec["step1"] = {
                        "loss": rec["losses"][0],
                        "grads": {k: q.grad.float().cpu().numpy().copy()
                                  for k, q in state.model.named_parameters()},
                        "params": {k: q.detach().float().cpu().numpy().copy()
                                   for k, q in
                                   state.model.named_parameters()}}
        local = S.shard_batch(p["batches"][0], mesh, stride=cfg.model.stride)
        if name == "mobilenet_thin":
            rec["step_ms"] = median_ms(torch, lambda: step(state, local))
        spatial.reset_stats(timed=True)
        try:
            step(state, local)
            torch.cuda.synchronize()
        finally:
            rec["timed_stats"] = dict(spatial.STATS)
            spatial.reset_stats()
        out[name] = rec
        del state
        torch.cuda.empty_cache()
    return out


def spatial_check(torch, ranks: list, refs: dict) -> dict:
    """The spatial axis across the ranks: both replicas bit-identical after
    every step, finite losses, the first step within `step_vs_one_process`
    of one process's (refs: model -> (one, one-process step ms)); returns
    the `spatial` object of the `parallel` line."""
    cfgs = dict(zip(SPATIAL_MODELS, spatial_configs()))
    models = {}
    for name in SPATIAL_MODELS:
        recs = [r["spatial"][name] for r in ranks]
        if any(rec["digests"] != recs[0]["digests"] for rec in recs):
            raise AssertionError(f"spatial {name}: the ranks' replicas "
                                 "differ")
        if not all(map(math.isfinite, recs[0]["losses"])):
            raise AssertionError(f"spatial {name}: losses "
                                 f"{recs[0]['losses']}")
        one, one_ms = refs[name]
        vs_one = step_vs_one_process(
            torch, cfgs[name], recs[0]["step1"], one,
            f"spatial sync-sgd {name} on {len(ranks)} ranks")
        models[name] = {
            "steps": len(recs[0]["losses"]), "losses": recs[0]["losses"],
            "band_rows_hw": [rec["band_rows"] for rec in recs],
            "step_ms": [rec.get("step_ms") for rec in recs],
            "checked_ms": [rec["checked_ms"] for rec in recs],
            "one_process_step_ms": one_ms,
            "halo_calls_a_step": [rec["stats"]["halo_calls"] for rec in recs],
            "halo_bytes_a_step": [rec["stats"]["halo_bytes"] for rec in recs],
            "halo_ms_a_step": [rec["timed_stats"]["halo_seconds"] * 1e3
                               for rec in recs],
            "gather_bytes_a_step": [rec["stats"]["gather_bytes"]
                                    for rec in recs],
            "gather_ms_a_step": [rec["timed_stats"]["gather_seconds"] * 1e3
                                 for rec in recs],
            "timed_step_note": "halo/gather ms from one more step with the "
                               "device synchronised around each exchange",
            "max_memory_allocated": [rec["max_memory_allocated"]
                                     for rec in recs],
            "one_process_max_memory_allocated": one["max_memory_allocated"],
            "peak_step_bytes": [rec["peak_step_bytes"] for rec in recs],
            "one_process_peak_step_bytes": one["peak_step_bytes"],
            "memory_note": "peak_step_bytes: max_memory_allocated in the "
                           "first step less what the process held before "
                           "it",
            "vs_one_process": vs_one}
    return {"note": "two ranks on one card, not a scaling figure",
            "backend": "gloo", "mesh": {"data": 1, "spatial": len(ranks)},
            "axes": [r["spatial"]["axes"] for r in ranks],
            "global_batch": BATCH, "models": models}


def spatial_phase(torch, np, dev, gpu) -> None:
    """Phase 14's spatial axis alone (`--spatial-phase`): the one-process
    references, PARALLEL_RANKS spawned gloo ranks sharing the card as a 1 x
    PARALLEL_RANKS mesh, the checks; a `spatial` line."""
    from openpose_plus_tpu_torch import train as T

    t_phase = time.perf_counter()
    cfgs = spatial_configs()
    batches = parallel_batches(np, cfgs[0].model, PARALLEL_STEPS)
    dev_refs = {}
    for name, cfg in zip(SPATIAL_MODELS, cfgs):
        dev_refs[name] = one_process_step(torch, T, cfg, batches[0], dev,
                                          timed=name == "mobilenet_thin")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks = run_parallel_ranks(PARALLEL_RANKS, {
        "device": str(dev), "batches": batches, "spatial_cfgs": cfgs,
        "only_spatial": True})
    line = spatial_check(torch, ranks, dev_refs)
    line["phase_seconds"] = time.perf_counter() - t_phase
    line["gpu"] = gpu
    log(json.dumps({"spatial": line}))


def parallel_phase(torch, np, engine, gains, images, eval_card, counted,
                   dev, gpu) -> None:
    """Phase 14 (module docstring): the distributed layer on the card."""
    import tempfile

    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.ap_oracle import GEOMETRIES
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.postproc import HumanBatch

    t_phase = time.perf_counter()
    cfg = parallel_config(engine.config)
    batches = parallel_batches(np, cfg.model, PARALLEL_STEPS)
    nccl = nccl_world_of_one(torch, engine, images, batches[0], counted, dev)
    log(f"parallel: one NCCL rank: {nccl}")

    # the reference of sync-sgd and of the spatial axis: one process
    # stepping on the global batch
    one, one_step_ms = one_process_step(torch, T, cfg, batches[0], dev)
    one_vgg, one_vgg_ms = one_process_step(
        torch, T, spatial_configs()[1], batches[0], dev, timed=False)
    infer_ms = median_ms(torch, lambda: engine.infer(images))

    size = GEOMETRIES["serving"]["size"]
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_bank_") as tmp:
        bank = make_scene_bank(tmp, "val", EVAL_IMAGES, size)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ranks = run_parallel_ranks(PARALLEL_RANKS, {
            "device": str(dev), "train_cfg": cfg, "serve_cfg": engine.config,
            "batches": batches, "images": images.cpu().numpy(),
            "gains": gains, "bank": bank,
            "spatial_cfgs": (cfg, spatial_configs()[1])})

    log("parallel ranks: " + json.dumps({
        "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
        "strategies": {s: {k: v for k, v in rec.items() if k != "digests"}
                       for s, rec in ranks[0]["strategies"].items()},
        "mesh_infer_ms": [out["mesh_infer_ms"] for out in ranks],
        "eval": [out["eval"] for out in ranks]}))
    # replicas: with two ranks every strategy leaves them bit-identical
    # (pair-avg's one round pairs rank 0 with rank 1)
    for strategy in kf.STRATEGIES:
        recs = [r["strategies"][strategy] for r in ranks]
        if any(rec["digests"] != recs[0]["digests"] for rec in recs):
            raise AssertionError(f"{strategy}: the ranks' replicas differ")
        if not all(map(math.isfinite, recs[0]["losses"])):
            raise AssertionError(f"{strategy}: losses {recs[0]['losses']}")
    # sync-sgd's first step against one process on the global batch
    vs_one = step_vs_one_process(torch, cfg, ranks[0]["sync_sgd_step1"],
                                 one, f"sync-sgd on {PARALLEL_RANKS} ranks")
    # the spatial axis: the same against one process, replicas bit-identical
    spatial_line = spatial_check(torch, ranks, {
        "mobilenet_thin": (one, one_step_ms),
        "vgg19": (one_vgg, one_vgg_ms)})
    # Engine(mesh=): every rank holds the whole batch, bit-equal to rank 0's
    # (each rank checked it against batch-4 engines on the slices); against
    # the batch-8 call: the maps within bf16 rounding of their scale, as
    # phase 4 holds the fused maps (cuDNN's batch-4 algorithms move bf16
    # ulps, which can move a peak: on an H100 one image's `valid` moved),
    # and the humans each image decodes to, beside the batch-8 call's
    held = [HumanBatch(**{k: torch.from_numpy(v)
                          for k, v in out["mesh"].items()}) for out in ranks]
    for r, out in enumerate(ranks[1:], 1):
        assert_batches_equal(torch, f"Engine(mesh=) rank {r} vs rank 0",
                             held[r], held[0])
        assert_equal(torch, f"Engine(mesh=).forward rank {r} vs rank 0",
                     [torch.from_numpy(m) for m in out["mesh_maps"]],
                     [torch.from_numpy(m) for m in ranks[0]["mesh_maps"]])
    map_ratios = check_map_scale(
        torch, "Engine(mesh=).forward vs batch-8 forward",
        [torch.from_numpy(m) for m in ranks[0]["mesh_maps"]],
        [t.cpu() for t in engine.forward(images)], 2e-2)
    batch8_humans = engine.infer(images).num_humans.tolist()
    # distributed evaluate_engine against phase 9's unsharded call: each
    # rank serves one batch of BATCH of phase 9's images, as phase 9 did,
    # so the detections are the same ones
    for out in ranks:
        ev = out["eval"]
        if not (ev["n_images"] == EVAL_IMAGES
                and ev["n_dets"] == eval_card.n_dets
                and abs(ev["ap"] - eval_card.ap) <= PARALLEL_EVAL_TOL):
            raise AssertionError(f"distributed evaluate_engine {ev} vs "
                                 f"phase 9's AP {eval_card.ap}")
    line = {
        "note": "two ranks on one card, not a scaling figure",
        "backend": "gloo", "ranks": PARALLEL_RANKS,
        "devices": [out["device"] for out in ranks],
        "model": cfg.model.name, "hw": [cfg.model.hin, cfg.model.win],
        "dtype": cfg.model.compute_dtype, "global_batch": BATCH,
        "optimizer": cfg.train.optimizer, "lr": cfg.train.lr_init,
        "strategies": {s: {k: ranks[0]["strategies"][s][k] for k in (
            "step_ms", "checked_ms", "losses", "collective",
            "collective_bytes", "collective_ms")}
            for s in kf.STRATEGIES},
        "one_process_step_ms": one_step_ms,
        "sync_sgd_vs_one_process": vs_one,
        "mesh_infer_ms": [out["mesh_infer_ms"] for out in ranks],
        "slice_infer_ms": [out["slice_infer_ms"] for out in ranks],
        "one_process_infer_ms": infer_ms,
        "mesh_launches": [out["mesh_launches"] for out in ranks],
        "mesh_maps_vs_batch8_rel_err": map_ratios,
        "mesh_humans_per_image": held[0].num_humans.tolist(),
        "batch8_humans_per_image": batch8_humans,
        "eval_ap": [out["eval"]["ap"] for out in ranks],
        "eval_ap_phase9": eval_card.ap,
        "eval_n_dets": [out["eval"]["n_dets"] for out in ranks],
        "eval_n_dets_phase9": eval_card.n_dets,
        "eval_seconds": [out["eval_seconds"] for out in ranks],
        "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
        "nccl_world_of_one": nccl, "spatial": spatial_line,
        "phase_seconds": time.perf_counter() - t_phase, "gpu": gpu}
    log(json.dumps({"parallel": line}))


def bench_scene(torch, np, scenes, n: int, h: int, w: int) -> tuple:
    """n images of standing people spread over the width of an (h, w) map
    grid, each image its own arrangement (CPU): (conf, paf, people an
    image)."""
    people = int((w - 14) // 14.61) + 1
    confs, pafs = [], []
    for j in range(n):
        conf, paf = scenes.make_maps([scenes.standing_person(
            7.37 + 14.61 * i + 0.71 * (j % 5), 21.43 + 0.83 * (j % 3),
            0.93 + 0.04 * i) for i in range(people)], h, w)
        confs.append(conf)
        pafs.append(paf)
    return (torch.from_numpy(np.stack(confs)),
            torch.from_numpy(np.stack(pafs)), people)


def bench_row_vs_plain(torch, np, scenes, name, chain, dev) -> dict:
    """Phase 15's check of one bench row at its own shapes: the chain's
    images through the served step eagerly, chunk by chunk as `infer_step`
    splits them, once through the hand kernels and once with each sent to
    its plain version on the card. An int8 row's int8_conv and quantize_act
    outputs equal the plain-routed forward's call by call and its maps lie
    within INT8_PLAIN_TOL of their scale; the decode of the kernel maps
    equals their plain-routed decode bit for bit; the graph's own
    HumanBatch (`chain.out`) holds against the plain decode by
    `compare_decodes` (masks equal, the rest within 1e-5); and a scene of
    people across the row's map grid, at the row's decode batch, decodes
    bit-equal through the kernels and the plain versions and finds every
    person (random weights find few peaks)."""
    from openpose_plus_tpu_torch.engine import _forward
    from openpose_plus_tpu_torch.ops.cuda import (greedy, int8_conv, merge,
                                                  paf_sample)
    from openpose_plus_tpu_torch.postproc import HumanBatch, decode_maps

    eng, images = chain.engine, chain.images
    mc, postproc = eng.config.model, eng.config.postproc
    b, chunk = images.shape[0], eng.chunk
    size = chunk if chunk and b > chunk and b % chunk == 0 else b
    names = ("int8_conv", "quantize_act")
    decoder = ((greedy, "greedy_assign"), (merge, "assemble"),
               (paf_sample, "sample_paf"))
    out = {"pieces": b // size, "int8_calls": 0, "maps_rel_err": []}
    plain = []
    with torch.inference_mode():
        for i in range(0, b, size):
            x = images[i:i + size]
            maps = {}
            if mc.compute_dtype == "int8":
                kern = record_outputs(int8_conv, names, lambda: maps.update(
                    kernel=_forward(eng.model, x)))
                ref = routed_plain(int8_conv, lambda: record_outputs(
                    int8_conv, names, lambda: maps.update(
                        plain=_forward(eng.model, x))))
                for key in names:
                    if not kern[key] or len(kern[key]) != len(ref[key]):
                        raise AssertionError(f"bench {name}: {key} calls "
                                             f"{len(kern[key])} against "
                                             f"{len(ref[key])} plain")
                    for (_, o), (_, r) in zip(kern[key], ref[key]):
                        if not torch.equal(o, r):
                            raise AssertionError(
                                f"bench {name}: a {key} output differs from "
                                "its plain version's")
                    out["int8_calls"] += len(kern[key])
                del kern, ref
                out["maps_rel_err"] += check_map_scale(
                    torch, f"bench {name} maps vs plain-routed",
                    maps["kernel"], maps["plain"], INT8_PLAIN_TOL)
            else:
                maps["kernel"] = _forward(eng.model, x)
            got = decode_maps(*maps["kernel"], postproc)
            plain.append(to_plain(decoder, lambda: decode_maps(
                *maps["kernel"], postproc)))
            assert_batches_equal(torch, f"bench {name} decode vs plain",
                                 got, plain[-1])
        conf, paf, people = bench_scene(torch, np, scenes, size, mc.hout,
                                        mc.wout)
        conf, paf = conf.to(dev), paf.to(dev)
        got = decode_maps(conf, paf, postproc)
        ref = to_plain(decoder, lambda: decode_maps(conf, paf, postproc))
    assert_batches_equal(torch, f"bench {name} scene decode vs plain", got,
                         ref)
    if not bool((got.num_humans == people).all()):
        raise AssertionError(f"bench {name} scene: humans "
                             f"{got.num_humans.tolist()}, {people} each")
    plain = HumanBatch.cat(plain)
    out["graph_bit_equal"] = all(
        torch.equal(getattr(chain.out, f.name), getattr(plain, f.name))
        for f in dataclasses.fields(plain))
    compare_decodes(torch, f"bench {name} graph vs plain", chain.out,
                    HumanBatch(**{f.name: getattr(plain, f.name).cpu()
                                  for f in dataclasses.fields(plain)}), 1e-5)
    out["humans"] = int(plain.num_humans.sum())
    out["scene"] = [size, mc.hout, mc.wout, people]
    return out


def bench_phase(torch, np, dev, gpu) -> None:
    """Phase 15 (module docstring): the bench's modes at full size, the
    table held to its checks."""
    from openpose_plus_tpu_torch import bench, loader
    from openpose_plus_tpu_torch.host import INPUT_LAYOUTS
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    scenes = load_test_helper("kernel_inputs")
    t_phase = time.perf_counter()
    kept, line = {}, {"rows": {}}

    def check_row(name, m):
        row, chain, dt = m.row, m.chain, m.seconds
        if "cost_analysis_error" in row:
            raise AssertionError(f"bench {name}: {row['cost_analysis_error']}")
        if chain.graph is None or chain.engine.device != dev:
            raise AssertionError(f"bench {name}: not a CUDA graph on {dev}")
        line["rows"][name] = {
            "fps": row["fps"], "ms": dt * 1e3, "batch": row["batch"],
            "mfu_pct": row["mfu_pct"], "hbm_pct_est": row["hbm_pct_est"],
            "spread_pct": row["spread_pct"],
            "flops_per_image": row["flops_per_image"],
            "samples_ms": [t * 1e3 for t in m.samples]}
        if not (all(math.isfinite(v) for v in (
                row["fps"], dt, row["mfu_pct"], row["hbm_pct_est"],
                row["flops_per_image"])) and min(row["fps"], dt,
                                                 row["flops_per_image"]) > 0):
            raise AssertionError(f"bench {name}: {row}, {dt} s a step")
        t0 = time.perf_counter()
        line["rows"][name]["vs_plain"] = {
            **bench_row_vs_plain(torch, np, scenes, name, chain, dev),
            "s": time.perf_counter() - t0}
        if name == bench.HEADLINE:
            # the bench's yardstick against the benchmark's on one step
            slope_ms = 1e3 * bench.fori_slope_seconds(chain.run, chain.carry)
            step_ms = graph_ms(chain.step, dev)
            line["headline_slope_over_device"] = slope_ms / step_ms
            if not abs(slope_ms / step_ms - 1) <= BENCH_SLOPE_TOL:
                raise AssertionError(
                    f"bench headline: slope {slope_ms:.4f} ms, graph_ms "
                    f"{step_ms:.4f} ms (limit {BENCH_SLOPE_TOL:.0%})")
            # the graph's HumanBatch against compiled infer
            chain.run(1)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(chain.carry)):
                raise AssertionError("bench headline: non-finite carry")
            ref = {f.name: getattr(chain.out, f.name).clone()
                   for f in dataclasses.fields(chain.out)}
            eng = chain.engine
            eng.compile(chain.images.shape[0], INPUT_LAYOUTS[
                eng.config.model.preferred_input_layout()])
            out = eng.infer(chain.images)
            for f, t in ref.items():
                if not torch.equal(getattr(out, f), t):
                    raise AssertionError(f"bench headline: the graph's "
                                         f"HumanBatch.{f} differs from "
                                         "compiled infer's")
            kept["headline"] = chain
        elif name == BENCH_INT8_ROW:
            kept["int8"] = chain

    t0 = time.perf_counter()
    for name, m in bench.table_rows(device=dev):
        check_row(name, m)
        del m
    line["table_s"] = time.perf_counter() - t0
    if list(line["rows"]) != [name for name, *_ in bench.ROWS]:
        raise AssertionError(f"bench table rows {list(line['rows'])}")
    log(f"bench: {len(line['rows'])} rows, each finite and against its "
        "plain versions; headline slope / graph_ms "
        f"{line['headline_slope_over_device']:.4f} (limit "
        f"{BENCH_SLOPE_TOL:.0%}); the headline's graph == compiled infer")

    # one profiler session over a replay of each kept graph
    calls = {label: functools.partial(chain.run, 1)
             for label, chain in kept.items()}
    calls["headline_x5"] = functools.partial(kept["headline"].run, 5)
    trace = replay_trace(torch, calls)
    n_convs, n_quant = int8_layers(common, kept["int8"].engine.model)
    expect = {"headline": {"greedy_assign_kernel": 1, "assemble_kernel": 1,
                           "sample_paf_kernel": 1},
              "headline_x5": {"greedy_assign_kernel": 5,
                              "assemble_kernel": 5, "sample_paf_kernel": 5},
              "int8": {"greedy_assign_kernel": 1, "assemble_kernel": 1,
                       "sample_paf_kernel": 1, "int8_conv_kernel": n_convs,
                       "quantize": n_quant}}
    for label, want in expect.items():
        got = {k: trace[label]["kernels"][k] for k in want}
        if got != want:
            raise AssertionError(f"bench {label} replay trace: kernels "
                                 f"{got}, expected {want}")
    line["trace"] = trace
    del kept
    torch.cuda.empty_cache()

    # the user's entry point, in a fresh process: the headline line
    env = dict(os.environ, PYTHONPATH=HERE, BENCH_HEADLINE_ONLY="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "openpose_plus_tpu_torch",
                           "bench"], cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=600)
    head = (json.loads(proc.stdout.splitlines()[-1])
            if proc.returncode == 0 and proc.stdout.strip() else None)
    if head is None or list(head) != BENCH_HEADLINE_KEYS or not (
            math.isfinite(head["value"]) and head["value"] > 0):
        raise AssertionError(f"python -m openpose_plus_tpu_torch bench: rc "
                             f"{proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr}")
    line["cli"] = {"headline": head, "s": time.perf_counter() - t0}

    for label, fn in (("train", bench.train), ("stream", bench.stream),
                      ("stream_loader_only", functools.partial(
                          bench.stream, loader_only=True))):
        t0 = time.perf_counter()
        out = fn(device=dev)
        if not (math.isfinite(out["value"]) and out["value"] > 0):
            raise AssertionError(f"bench {label}: {out}")
        line[label] = {**out, "s": time.perf_counter() - t0}
        if label != "train":       # the run's host scopes, ms a call
            line[label]["scope_ms"] = {
                scope: total_s * 1e3 / calls for scope, (calls, total_s)
                in GLOBAL_TRACER.last.summary().items()}
            # the plane a photo decodes to (bench.stream's defaults)
            photos = bench.make_photo_set(3000, 4000, 16)
            first = min(f for f in os.listdir(photos) if f.endswith(".jpg"))
            line[label]["plane"] = list(loader.decode(
                os.path.join(photos, first), 368, 656)[0].shape)
    line["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"bench": {**line, "gpu": gpu}}))


def main(argv: list[str]) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--decoder-kernels-of", metavar="DIR",
        help="only build the port in DIR (a checkout of this repository), "
             "print its greedy and merge kernels' ptxas frames, and check "
             "and time them on phase 6's random sets")
    parser.add_argument(
        "--int8-kernels-of", metavar="DIR",
        help="only build the port in DIR and check and time its int8_conv "
             "and quantize_act kernels at the shape groups of its own "
             "full-width int8 forwards (phase 11's engines)")
    parser.add_argument(
        "--mma-ceiling", action="store_true",
        help="only build and run probes/mma_ceiling.cu: the card's "
             "mma.sync s8 and bf16 rates from registers and its wgmma "
             "rates from shared memory")
    parser.add_argument(
        "--int8-phases", action="store_true",
        help="only build csrc/int8_conv.cu with its phase clocks and print "
             "where a block of the int8 conv spends its time at the "
             "forwards' main shapes")
    parser.add_argument(
        "--bench-phase", action="store_true",
        help="only build the kernels and run phase 15, the bench (the full "
             "run starts it so, in a fresh process)")
    parser.add_argument(
        "--studies-phase", action="store_true",
        help="only build the kernels and run phase 17, the accuracy studies")
    parser.add_argument(
        "--spatial-phase", action="store_true",
        help="only run phase 14's spatial axis (no kernel is on its path): "
             "sync-sgd of MobileNet-thin and VGG19 on two gloo ranks "
             "sharing the card as a 1 x 2 (data, spatial) mesh, against "
             "one process")
    args = parser.parse_args(argv)
    if args.decoder_kernels_of and args.int8_kernels_of:
        parser.error("one of --decoder-kernels-of and --int8-kernels-of")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    import numpy as np

    tree = args.decoder_kernels_of or args.int8_kernels_of
    if tree is not None:
        sys.path.insert(0, os.path.abspath(tree))

    from openpose_plus_tpu_torch import Engine, default_config, skeletons
    from openpose_plus_tpu_torch.models import common, get_model
    from openpose_plus_tpu_torch.ops.cuda import (build, dw_probe, greedy,
                                                  int8_conv, merge,
                                                  paf_sample, peaks, sepconv)
    from openpose_plus_tpu_torch.postproc import decode_maps, nms
    inputs = load_test_helper("kernel_inputs")

    dev = torch.device("cuda", 0)
    if args.mma_ceiling:
        mma_ceiling(build)
        return 0
    if args.int8_phases:
        int8_phases(torch, np, build, int8_conv, inputs, dev, gpu)
        return 0
    if args.spatial_phase or args.bench_phase or args.studies_phase:
        if args.spatial_phase:          # no kernel is on its path
            spatial_phase(torch, np, dev, gpu)
        else:
            build.build()
            build.load()
            if args.bench_phase:
                bench_phase(torch, np, dev, gpu)
            else:
                studies_phase(torch, {
                    "greedy_assign": greedy, "assemble": merge,
                    "sample_paf": paf_sample, "fused_sepconv": sepconv,
                    "find_peaks": peaks}, dev, gpu)
        if foreign_modules():
            raise AssertionError(f"the port pulled in {foreign_modules()}")
        return 0

    # ---- 2. build -------------------------------------------------------
    phase_s, last = {}, [time.perf_counter()]

    def phase_done(name: str) -> None:
        """Log and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    nvcc_log = (lib_path.parent / "nvcc.log").read_text()
    for line in nvcc_log.splitlines():
        if "ptxas info" in line and ("registers" in line
                                     or "Compiling" in line):
            log(f"  {line.strip()}")
    frames = ptxas_frames(nvcc_log)
    int8_frames = ptxas_frames(nvcc_log, INT8_KERNELS)
    bias_act_frames = ptxas_frames(nvcc_log, ("bias_act_kernel",))
    for name, (stack, spill_st, spill_ld) in sorted({
            **frames, **int8_frames, **bias_act_frames}.items()):
        log(f"  ptxas frame {name}: {stack} bytes stack, {spill_st} bytes "
            f"spill stores, {spill_ld} bytes spill loads")
    cfg = default_config("mobilenet_thin")
    m = cfg.postproc.max_humans
    clock_mhz = max_sm_mhz()
    if tree is not None:
        import openpose_plus_tpu_torch
        if not openpose_plus_tpu_torch.__file__.startswith(
                os.path.abspath(tree) + os.sep):
            raise AssertionError(f"imported {openpose_plus_tpu_torch.__file__}"
                                 f", not the port in {tree}")
        if args.int8_kernels_of:
            int8_kernels_of(torch, np, tree, dev, gpu)
            return 0
        for (label, k), case in random_decoder_sets(torch, inputs, np,
                                                    dev).items():
            log(json.dumps({"decoder_kernels": {
                "tree": tree, "set": label, "k": k, "batch": BATCH, "m": m,
                **decoder_kernel_times(torch, greedy, merge, *case, m,
                                       clock_mhz),
                "max_sm_mhz": clock_mhz, "gpu": gpu}}))
        return 0
    # greedy and merge keep every instance's locals in registers
    if ({k for k in DECODER_KERNELS if any(k in n for n in frames)}
            != set(DECODER_KERNELS)
            or any(f != (0, 0, 0) for f in frames.values())):
        raise AssertionError(f"greedy/merge ptxas frames {frames}: expected "
                             "0 bytes of stack and spills for every instance")
    # the int8 conv's 64 or 32 s32 accumulators a thread and its epilogue
    # stay in registers at every instance, the quantize passes too
    n_conv = sum(INT8_KERNELS[0] in n for n in int8_frames)
    if (n_conv != 2 * len(int8_conv.PLANS) or len(int8_frames) != n_conv + 2
            or any(f != (0, 0, 0) for f in int8_frames.values())):
        raise AssertionError(f"int8 ptxas frames {int8_frames}: expected "
                             f"{2 * len(int8_conv.PLANS)} int8_conv "
                             "instances and the two quantize passes, each "
                             "with 0 bytes of stack and spills")
    if len(bias_act_frames) != 16 or any(f != (0, 0, 0) for f in
                                         bias_act_frames.values()):
        raise AssertionError(f"bias_act ptxas frames {bias_act_frames}: "
                             "expected 16 instances with 0 bytes of stack "
                             "and spills")
    phase_done("2_build")

    # ---- 4. main paths ---------------------------------------------------
    rng = np.random.default_rng(0)
    mc = cfg.model
    cfg_fused = cfg.replace(model=dataclasses.replace(
        mc, fused_inference=True))
    # dw5-dw9 and three SepConvRelu per branch: 41 at the default 6 stages
    n_fused = 5 + 2 * 3 * mc.n_stages
    shapes = fused_shapes(common, get_model(cfg_fused.model))
    if sum(shapes.values()) != n_fused:
        raise AssertionError(f"fused model layers {shapes}: expected "
                             f"{n_fused}")
    engine = Engine(cfg, seed=0, device=dev)
    images = torch.from_numpy(rng.integers(
        0, 256, (BATCH, mc.hin, mc.win, 3), dtype=np.uint8)).to(dev)
    gains = scale_heads(torch, engine, images)
    fused_engine = Engine(cfg_fused, seed=0, device=dev)
    scale_heads(torch, fused_engine, images, gains)
    for a, b in zip(engine.model.state_dict().values(),
                    fused_engine.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError("the two engines' weights differ")
    counted = {"greedy_assign": greedy, "assemble": merge,
               "sample_paf": paf_sample, "fused_sepconv": sepconv,
               "find_peaks": peaks}
    path_launches = {}
    for label, eng in (("default", engine), ("fused", fused_engine)):
        eng.infer(images)                      # warm-up (cuDNN, allocator)
        out, n = launches_during(torch, counted, lambda: eng.infer(images))
        path_launches[label] = n
        log(f"main path ({label}): Engine.infer {tuple(images.shape)} "
            f"{mc.name} {mc.compute_dtype} {mc.n_stages} stages, "
            f"fused_inference={eng.config.model.fused_inference}, head gains "
            f"{gains}; kernel launches {n}; humans per image "
            f"{out.num_humans.tolist()}")
        check_launches(f"{label} path", n, 1,
                       n_fused if label == "fused" else 0)
        check_humans(torch, f"{label} path", out, m, dev)
        if n["find_peaks"] < 1 or tuple(out.coords.shape[2:]) != (18, 2) \
                or not bool((out.num_humans > 0).all()):
            raise AssertionError(f"{label} path: find_peaks launched "
                                 f"{n['find_peaks']} times, coords "
                                 f"{tuple(out.coords.shape)}, humans per "
                                 f"image {out.num_humans.tolist()}")
    launches = dict(path_launches["default"])
    launches["fused_sepconv"] = path_launches["fused"]["fused_sepconv"]
    # the fused maps against the unfused ones: bf16 rounding
    # (tests/test_torch_models.py REL_TOL["bfloat16"])
    ratios = check_map_scale(torch, "fused vs unfused maps",
                             fused_engine.forward(images),
                             engine.forward(images), 2e-2)
    log(f"fused vs unfused final maps: max_abs_err / scale conf "
        f"{ratios[0]:.3g}, paf {ratios[1]:.3g} (limit 2e-2)")

    check_forward32(torch, get_model, engine, images, dev, "")

    # synthetic scene: three standing people, card (kernels) vs CPU (plain)
    conf, paf = three_people(torch, np, inputs, mc)
    # with TF32 allowed for matmuls: the decoder's contractions must not
    # take it (they run in float64)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on_dev = decode_maps(conf.to(dev), paf.to(dev), cfg.postproc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # float64 contractions summed in another order: ~1 ulp
    compare_decodes(torch, "scene", on_dev,
                    decode_maps(conf, paf, cfg.postproc), 1e-5)
    n_humans = on_dev.num_humans.tolist()
    if n_humans != [3] * BATCH or not bool(
            (on_dev.n_parts[:, :3] == 18).all()):
        raise AssertionError(f"scene decoded to {n_humans} humans, "
                             f"parts {on_dev.n_parts[0, :4].tolist()}")
    log(f"scene: 3 standing people -> {n_humans[0]} humans x 18 parts, "
        f"card == cpu")

    phase_done("4_main_paths")

    # ---- 5. accuracy paths ------------------------------------------------
    engines = {"default": engine, "fused": fused_engine}
    accuracy_paths(torch, np, inputs, engines, images, counted, n_fused,
                   dev)
    phase_done("5_accuracy_paths")

    # ---- 6. the kernels' timings: the `kernels` line's figures -----------
    k = cfg.postproc.max_peaks
    # greedy and merge on random sets at K=16 and K=32, their plain versions
    # at the served K
    timing, errs = {}, {}
    for (label, kk), case in random_decoder_sets(torch, inputs, np,
                                                 dev).items():
        t = decoder_kernel_times(torch, greedy, merge, *case, m, clock_mhz,
                                 plain=kk == k)
        log(json.dumps({"decoder_kernels": {
            "set": label, "k": kk, "batch": BATCH, "m": m, **t,
            "max_sm_mhz": clock_mhz, "gpu": gpu}}))
        if kk == k:
            for name in ("greedy_assign", "assemble"):
                timing[name] = {**t[name], "library_ms": None}
                errs[name] = 0.0          # bit-equal, checked in the call
    sep_ms = {}
    for (c, f), n in sorted(shapes.items()):
        sep_ms[c, f] = time_sepconv(torch, np, inputs, common, sepconv,
                                    BATCH, mc.hout, mc.wout, c, f, dev)
        log(json.dumps({"sepconv": {
            "batch": BATCH, "hw": [mc.hout, mc.wout], "c": c, "f": f,
            "layers": n, **sep_ms[c, f], "gpu": gpu}}))
    errs["fused_sepconv"] = max(t["max_abs_err"] for t in sep_ms.values())
    probe_t = {}
    for c in (128, 256):
        probe_t[c] = time_probe(torch, np, inputs, dw_probe, c, dev)
        log(json.dumps({"probe": {**probe_t[c], "gpu": gpu}}))
    up = cfg.postproc.upsample_factor
    paf_args = [torch.from_numpy(a).to(dev) for a in inputs.paf_samples(
        np.random.default_rng(1), BATCH, mc.hout * up, mc.wout * up, k)]
    paf_args.append(paf_sample.limb_channels(dev, skeletons.COCO18))
    paf_gather = one_call_gather(torch, *paf_args)
    sample = functools.partial(paf_sample.sample_paf, *paf_args)
    sample_plain = functools.partial(paf_sample.sample_paf_plain, *paf_args)
    got, ref = sample(), sample_plain()
    assert_bits_equal(torch, f"sample_paf K={k} {tuple(paf_args[0].shape)} "
                      "vs plain (cuda)", got, ref)
    errs["sample_paf"] = max_abs_err(torch, got, ref)
    timing["sample_paf"] = {
        "ms": median_ms(torch, sample), "plain_ms": median_ms(
            torch, sample_plain), "device_ms": graph_ms(sample, dev),
        "plain_device_ms": graph_ms(sample_plain, dev)}
    timing["sample_paf"].update(zip(("bound_ms", "bound_by"), bound(
        sample_paf_bytes(torch, *paf_args), 0.0), strict=True),
        library_ms=median_ms(torch, paf_gather),
        library_device_ms=graph_ms(paf_gather, dev))
    conf, _ = engine.forward(images)
    timing["find_peaks"] = peaks_times(torch, nms, peaks, conf,
                                       cfg.postproc.fidelity())
    log(json.dumps({"peaks": {"decode": "fidelity", **timing["find_peaks"],
                              "gpu": gpu}}))
    errs["find_peaks"] = timing["find_peaks"]["max_abs_err"]
    # one forward's worth: every (C, F) shape times its layer count; the
    # cuDNN pair stands in for the library call (no one call fuses them)
    timing["fused_sepconv"] = {
        key: sum(n * sep_ms[cf][src] for cf, n in shapes.items())
        for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                         ("device_ms", "kernel_device_ms"),
                         ("plain_device_ms", "plain_device_ms"),
                         ("library_ms", "pair_ms"),
                         ("library_device_ms", "pair_device_ms"),
                         ("bound_ms", "bound_ms"))}
    timing["fused_sepconv"]["bound_by"] = "bytes" if all(
        t["bound_by"] == "bytes" for t in sep_ms.values()) else "operations"
    # the probe path: one launch at each C
    for name, key in (("dw3x3_relu", "dw"), ("copy_bias", "copy")):
        timing[name] = {
            out: sum(p[f"{key}{src}"] for p in probe_t.values())
            for out, src in (("ms", "_ms"), ("plain_ms", "_plain_ms"),
                             ("device_ms", "_device_ms"),
                             ("plain_device_ms", "_plain_device_ms"),
                             ("library_ms", "_library_ms"),
                             ("library_device_ms", "_library_device_ms"),
                             ("bound_ms", "_bound_ms"))}
        timing[name]["bound_by"] = probe_t[128][f"{key}_bound_by"]
        errs[name] = max(p[f"{key}_max_abs_err"] for p in probe_t.values())
        launches[name] = sum(p[f"{key}_launches"] for p in probe_t.values())
    shape_of = {
        "greedy_assign": f"batch {BATCH}, K={k}",
        "assemble": f"batch {BATCH}, K={k}, M={m}",
        "sample_paf": f"batch {BATCH}, K={k}, {tuple(paf_args[0].shape)} "
                      "map",
        "find_peaks": f"batch {BATCH}, fidelity() K=32, 368x432 maps",
        "fused_sepconv": f"the {n_fused} layers of one batch-{BATCH} "
                         "forward",
        "dw3x3_relu": f"C=128 plus C=256 at ({BATCH}, *{PROBE_HW})",
        "copy_bias": f"C=128 plus C=256 at ({BATCH}, *{PROBE_HW})"}
    for name, t in timing.items():
        log(json.dumps({"kernel_times": {"name": name, **t,
                                         "shape": shape_of[name],
                                         "gpu": gpu}}))
    phase_done("6_timings")

    # ---- 7-9. the zoo, the GT-map oracle, evaluate_engine -----------------
    zoo_paths(torch, images, counted, dev, gpu)
    body25_phase(torch, np, inputs, counted, dev, gpu)
    body25_sums = bias_act_phase(torch, np, inputs, dev,
                                 gpu)["body25"][BATCH]["sum"]
    timing["bias_act"] = {"ms": body25_sums["device_ms"],
                          "plain_ms": body25_sums["plain_device_ms"],
                          "bound_ms": body25_sums["bound_ms"],
                          "bound_by": "bytes", "library_ms": None}
    launches["bias_act"] = BIAS_ACT_CALLS["body25"][-1]
    errs["bias_act"] = 0.0                       # bit-equal, checked above
    phase_done("7_zoo")
    oracle_phase(torch, counted, dev, gpu)
    phase_done("8_oracle")
    eval_card = eval_phase(torch, engine, counted, gpu)
    legacy_checkpoint(torch, engine, images, dev, gpu)
    phase_done("9_evaluate_engine")

    # ---- 10. training ------------------------------------------------------
    train_phase(torch, np, counted, dev, gpu)
    phase_done("10_training")

    # ---- 11. calibrated int8 ----------------------------------------------
    for name, t in int8_phase(torch, np, images, counted, dev, gpu).items():
        timing[name], launches[name], errs[name] = (t, t["launches"],
                                                    t["max_abs_err"])
    phase_done("11_int8")

    # ---- 12. the deploy path ---------------------------------------------
    deploy_phase(torch, np, engine, fused_engine, images, n_fused, dev, gpu)
    phase_done("12_deploy")

    # ---- 13. the file stream and the grouping oracle ----------------------
    stream_phase(torch, np, engine, inputs, dev, gpu)
    phase_done("13_stream")

    # ---- 14. the distributed layer ----------------------------------------
    parallel_phase(torch, np, engine, gains, images, eval_card, counted,
                   dev, gpu)
    phase_done("14_parallel")

    # ---- 15. the bench, in a fresh process: its profiler session would be
    # this process's seventh, and a seventh lost records (run 72) or crashed
    # the process (run 88)
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--bench-phase"], cwd=HERE, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase 15 (--bench-phase): rc {proc.returncode}")
    phase_done("15_bench")

    # ---- 17. the accuracy studies -----------------------------------------
    studies_phase(torch, counted, dev, gpu)
    phase_done("17_studies")
    log(json.dumps({"phase_seconds": {**phase_s,
                                      "total": sum(phase_s.values()),
                                      "gpu": gpu}}))

    if foreign_modules():
        raise AssertionError(f"the port pulled in {foreign_modules()}")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         **{key: timing[name][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, replaces) in SOURCES.items()]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
