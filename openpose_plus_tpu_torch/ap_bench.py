"""Synthetic AP benchmark on the port: the quality axis's studies.

Counterpart of `scripts/ap_benchmark.py`: train a zoo model on the seeded
TRAIN scene bank (`data.synthetic.make_scene_bank`), then evaluate
keypoint AP on the held-out val bank (`eval_coco.evaluate_engine`) under
cumulative inference settings:

  base              default PostprocConfig
  fidelity          PostprocConfig.fidelity()
  fidelity_tta      fidelity + horizontal-flip TTA
  fidelity_tta_ms   fidelity + flip TTA + scale search (0.5, 1.0, 1.5)
  with --frag-merge also fidelity_fm, fidelity_tta_fm and
  fidelity_tta_msdd_fm (the fragment-merge pass; msdd: per-scale decode
  and OKS-dedup merge)
  with --int8 also fidelity_int8: the same float weights in a calibrated
  int8 engine (`compute_dtype="int8"`), its scales from
  `calibrate_from_paths` on the first 8 TRAIN images, never the eval
  images (the TensorRT protocol)
  with --ms-study also fidelity_tta_ms15 (1.0, 1.5), fidelity_tta_msup
  (1.0, 1.5, 2.0; not at the serving tier) and fidelity_tta_msdd (0.5,
  1.0, 1.5 with the OKS-dedup merge): "the 0.5x scale hurts" apart from
  "the combiner hurts"

The other studies:

  --large-bank  the small-tier weights on the val_large bank (few frame-
                filling, often truncated figures), rows "<model>+large"
  --curve S1,S2,..  one training run to max(S) (the lr cut at max(S) // 2)
                with weight snapshots at each S, fidelity_tta AP per
                snapshot, rows "<model><tier>#curve"
  --oracle      GT maps through the decoder configs (`ap_oracle`), rows
                `ap_oracle.oracle_key`: with --out-stride N / --label-sigma X
                the resolution and label-width probes
  --table       the markdown tables of everything recorded

Geometry tiers (--geometry): "small" (256 px scenes, 128x128 input) and
"serving" (736 px scenes, 368x432 input, rows keyed "<model>@368"). The
banks, the trained weights (the JAX flat npz layout, `checkpoint.
save_npz`, under the JAX package's names), a loss CSV per training run and
the results (`results.json`) go to --bank-dir (default the git-ignored
`.ap_bench_torch/`); the JAX package's record `ap_benchmark.json` is only
read, and each row prints beside its record for the same key. Recorded
cells are skipped unless --force.

    python -m openpose_plus_tpu_torch.ap_bench --model mobilenet_thin \\
        --geometry serving --steps 16000 --lr 1e-3 --frag-merge
    python -m openpose_plus_tpu_torch.ap_bench --model vggtiny \\
        --curve 4000,16000,32000,64000
    python -m openpose_plus_tpu_torch.ap_bench --oracle --geometry serving \\
        --out-stride 4
    python -m openpose_plus_tpu_torch.ap_bench --table
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from openpose_plus_tpu_torch import ap_oracle
from openpose_plus_tpu_torch.ap_oracle import GEOMETRIES

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_PATH = os.path.join(HERE, "ap_benchmark.json")    # read only
BANK_DIR = os.path.join(HERE, ".ap_bench_torch")

MODELS = ("mobilenet_thin", "vggtiny", "hao28", "vgg19")
VARIANTS = ("base", "fidelity", "fidelity_tta", "fidelity_tta_ms")
INT8_VARIANTS = ("fidelity_int8",)
MS_STUDY_VARIANTS = ("fidelity_tta_ms15", "fidelity_tta_msup",
                     "fidelity_tta_msdd")
FM_VARIANTS = ("fidelity_fm", "fidelity_tta_fm", "fidelity_tta_msdd_fm")
# val_large is the truncation regime, the fragment-merge pass's target
LARGE_VARIANTS = ("fidelity", "fidelity_tta", "fidelity_tta_ms",
                  "fidelity_tta_msup", "fidelity_tta_msdd",
                  "fidelity_fm", "fidelity_tta_fm")
CALIB_IMAGES = 8      # train images the int8 variant calibrates on
MS_SCALES = {
    "fidelity_tta_ms": (0.5, 1.0, 1.5),
    "fidelity_tta_ms15": (1.0, 1.5),
    "fidelity_tta_msup": (1.0, 1.5, 2.0),
    "fidelity_tta_msdd": (0.5, 1.0, 1.5),
    "fidelity_tta_msdd_fm": (0.5, 1.0, 1.5),
}


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def results_path(bank_dir: str = BANK_DIR) -> str:
    return os.path.join(bank_dir, "results.json")


def _load_results(bank_dir: str = BANK_DIR) -> dict:
    return _load(results_path(bank_dir))


def _save_row(bank_dir: str, key: str, row: dict) -> None:
    """Merge `row` into the results' `key` (incremental: a run that is
    interrupted keeps every cell it finished)."""
    res = _load_results(bank_dir)
    res[key] = {**res.get(key, {}), **row}
    os.makedirs(bank_dir, exist_ok=True)
    with open(results_path(bank_dir), "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
        f.write("\n")


def _beside(want: Optional[float], ap: float) -> str:
    return ("no JAX record" if want is None else
            f"JAX record {want:.4f}, delta {ap - want:+.4f}")


def _device_line(device: str | torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_config(model: str, ann: str, imgs: str, steps: int, lr: float,
                 geo: dict, lr_scaling: str = "none",
                 bank_dir: str = BANK_DIR):
    """The benchmark's training config: the tier's geometry and labels,
    moderate augmentation (the bank already varies scale and rotation),
    batch 8, the lr cut to 0.33x at mid-run, no weight decay."""
    from openpose_plus_tpu_torch.config import default_config

    cfg = default_config(model)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hin=geo["hin"], win=geo["win"]),
        data=dataclasses.replace(
            cfg.data, train_annotations=ann, train_images=imgs,
            num_workers=4, prefetch=4,
            rotate_max_deg=15.0, scale_min=0.8, scale_max=1.15,
            shift_frac=0.1, sigma=geo["sigma"], limb_width=geo["limb"]),
        train=dataclasses.replace(
            cfg.train, batch_size=8, lr_init=lr, lr_scaling=lr_scaling,
            lr_decay_every=max(steps // 2, 1), lr_decay_factor=0.33,
            weight_decay=0.0, log_every=100, checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(bank_dir, f"ck_{model}")),
    )


def snapshot_path(bank_dir: str, model: str, steps: int, lr: float,
                  geo: dict, lr_scaling: str = "none",
                  schedule_steps: Optional[int] = None) -> str:
    """The JAX package's weight name: <model>_s<steps>_lr<lr><tier tag>,
    then _cv<schedule_steps> for a snapshot of a curve run and _lrs under
    the lr rule (lr and geometry are in the name: another --lr or
    --geometry retrains)."""
    tag = geo["tag"]
    if schedule_steps is not None:
        tag += f"_cv{schedule_steps}"
    if lr_scaling != "none":
        tag += "_lrs"
    return os.path.join(bank_dir, f"{model}_s{steps}_lr{lr:g}{tag}.npz")


def train_model(model: str, steps: int, lr: float, ann: str, imgs: str,
                geo: dict, snapshots: tuple[int, ...] = (),
                lr_scaling: str = "none", device: str = "cuda",
                bank_dir: str = BANK_DIR) -> tuple:
    """Train on the train bank; returns (cfg, state_dict, info). The weights
    are cached as a JAX-layout npz under bank_dir (`snapshot_path`), so the
    eval variants never retrain; `snapshots` also saves the weights at
    those steps of the same run (names with _cv<steps>). The loss every 100
    steps goes to a CSV beside them."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.pipeline import TrainPipeline

    cfg = build_config(model, ann, imgs, steps, lr, geo, lr_scaling,
                       bank_dir)
    schedule = steps if snapshots else None

    def path(s: int) -> str:
        return snapshot_path(bank_dir, model, s, lr, geo, lr_scaling,
                             schedule)

    want = sorted(set(snapshots) | {steps})
    if all(os.path.exists(path(s)) for s in want):
        print(f"[{model}] reusing trained weights {path(steps)}", flush=True)
        return cfg, ckpt.from_flax(ckpt.load_npz(path(steps))), {}

    os.makedirs(bank_dir, exist_ok=True)
    state = T.create_train_state(cfg, seed=0, device=device)
    pipeline = TrainPipeline(CocoPoseDataset(ann, imgs), cfg, seed=0,
                             cache_decoded=True)
    step_fn = T.make_train_step_on_batch(cfg)
    curve = path(steps)[:-len(".npz")] + "_loss.csv"
    it = iter(pipeline)
    t0 = time.perf_counter()
    losses = []
    try:
        with open(curve, "w") as f:
            f.write("step,loss,loss_conf_last,loss_paf_last,lr,seconds\n")
            for i in range(steps):
                state, metrics = step_fn(state, next(it))
                if i == 0 or i % 100 == 99:
                    loss = float(metrics["loss"])      # synchronises
                    seconds = time.perf_counter() - t0
                    losses.append(loss)
                    f.write(f"{i + 1},{loss:.6g},"
                            f"{float(metrics['loss_conf_last']):.6g},"
                            f"{float(metrics['loss_paf_last']):.6g},"
                            f"{float(metrics['lr']):.6g},{seconds:.3f}\n")
                    f.flush()
                    print(f"[{model}] step {i + 1}/{steps}: loss "
                          f"{loss:.2f} ({seconds:.0f}s)", flush=True)
                if i + 1 in want:
                    loss = float(metrics["loss"])
                    if not math.isfinite(loss):
                        raise FloatingPointError(
                            f"[{model}] non-finite loss {loss} at step "
                            f"{i + 1}")
                    ckpt.save_npz(path(i + 1), state.model.state_dict())
    finally:
        pipeline.stop()
    seconds = time.perf_counter() - t0
    print(f"[{model}] trained {steps} steps in {seconds:.0f}s, loss "
          f"{losses[0]:.1f} -> {losses[-1]:.1f}; saved {path(steps)}",
          flush=True)
    info = {"train_seconds": seconds,
            "imgs_per_sec": steps * cfg.train.batch_size / seconds,
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_csv": os.path.relpath(curve, HERE)}
    return cfg, state.model.state_dict(), info


def eval_variant(cfg, params, variant: str, dataset,
                 device: str = "cuda", calib_dataset=None) -> dict:
    """One inference variant's AP over a bank; the int8 variant calibrates
    on `calib_dataset` (the train bank)."""
    from openpose_plus_tpu_torch.engine import Engine
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine

    ecfg = cfg
    if variant != "base":
        ecfg = cfg.replace(postproc=cfg.postproc.fidelity())
    if variant.endswith("_fm"):
        ecfg = ecfg.replace(postproc=dataclasses.replace(
            ecfg.postproc, fragment_merge_rel=ap_oracle.FRAGMENT_MERGE_REL))
    if variant in INT8_VARIANTS:
        ecfg = ecfg.replace(model=dataclasses.replace(
            ecfg.model, compute_dtype="int8"))
    eng = Engine(ecfg, params=params, device=device)
    if variant in INT8_VARIANTS:
        eng.calibrate_from_paths([calib_dataset[i].image_path
                                  for i in range(CALIB_IMAGES)])
    kwargs = {}
    if variant.startswith("fidelity_tta"):
        kwargs["flip_tta"] = True
    if variant in MS_SCALES:
        kwargs["scales"] = MS_SCALES[variant]
        if "msdd" in variant:
            kwargs["ms_combine"] = "dedup"
    t0 = time.perf_counter()
    r = evaluate_engine(eng, dataset, batch_size=8, **kwargs)
    out = {"ap": round(r.ap, 4), "ap50": round(r.ap50, 4),
           "ap75": round(r.ap75, 4), "ar": round(r.ar, 4),
           "eval_seconds": round(time.perf_counter() - t0, 1)}
    if variant in MS_SCALES:
        out["scales"] = list(MS_SCALES[variant])
    return out


def _stamp(out: dict, steps: int, lr: float, geo: dict) -> dict:
    out.update({"steps": steps, "lr": lr, "n_val": geo["n_val"],
                "hin": geo["hin"], "bank_size": geo["size"]})
    return out


def _banks(bank_dir: str, geo: dict, eval_split: str) -> tuple:
    """(train annotations, train images, eval annotations, eval images,
    seconds): the tier's seeded banks, drawn once into bank_dir."""
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank

    os.makedirs(bank_dir, exist_ok=True)
    t0 = time.perf_counter()
    train = make_scene_bank(bank_dir, "train", geo["n_train"], geo["size"])
    val = make_scene_bank(bank_dir, eval_split, geo["n_val"], geo["size"])
    return (*train, *val, round(time.perf_counter() - t0, 1))


def _missing(row: dict, variants, force: bool, steps: int,
             lr: float) -> list:
    return [v for v in variants
            if force or v not in row or row[v].get("steps") != steps
            or row[v].get("lr", lr) != lr]


def _eval_rows(key: str, variants, cfg, params, info: dict, geo: dict,
               steps: int, lr: float, val_set, device, bank_dir: str,
               calib_set=None, **extra) -> dict:
    """Evaluates each variant, stamps and stores its row under `key` as it
    lands and prints it beside its record; returns the new cells."""
    record = _load(RECORD_PATH).get(key, {})
    gpu = _device_line(device)
    row = {}
    for variant in variants:
        out = _stamp(eval_variant(cfg, params, variant, val_set, device,
                                  calib_dataset=calib_set), steps, lr, geo)
        want = record.get(variant, {}).get("ap")
        out.update(extra, record_ap=want, device=gpu, **info)
        row[variant] = out
        _save_row(bank_dir, key, row)
        print(f"[{key}] {variant}: AP {out['ap']:.4f} "
              f"({_beside(want, out['ap'])}) AP50 {out['ap50']:.4f} "
              f"AR {out['ar']:.4f} ({out['eval_seconds']}s)", flush=True)
    print(json.dumps({"ap_bench": {"key": key, "gpu": gpu, "row": row}}),
          flush=True)
    return row


def run_model(model: str, steps: int, lr: float, force: bool,
              geometry: str = "small", lr_scaling: str = "none",
              frag_merge: bool = False, device: str = "cuda",
              int8: bool = False, ms_study: bool = False,
              bank_dir: str = BANK_DIR) -> dict:
    """Train one model at one tier and evaluate its variants; returns the
    row ({variant: result}) as stored in the results."""
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset

    geo = GEOMETRIES[geometry]
    train_ann, train_imgs, val_ann, val_imgs, bank_seconds = _banks(
        bank_dir, geo, "val")
    key = model + geo["key_suffix"] + (
        "#lrrule" if lr_scaling != "none" else "")
    row = _load_results(bank_dir).get(key, {})
    ms_variants = MS_STUDY_VARIANTS
    if geometry == "serving":
        # the serving tier is the resolution question's answer already;
        # msup's 2.0x engine (736x864) is studied where it is cheap
        ms_variants = tuple(v for v in ms_variants
                            if v != "fidelity_tta_msup")
    pool = (VARIANTS + (INT8_VARIANTS if int8 else ())
            + (ms_variants if ms_study else ())
            + (FM_VARIANTS if frag_merge else ()))
    # single-engine variants first, the scale searches (one engine a
    # scale) last: an interrupted run still lands every cheap cell
    variants = (tuple(v for v in pool if "ms" not in v)
                + tuple(v for v in pool if "ms" in v))
    missing = _missing(row, variants, force, steps, lr)
    if not missing:
        print(f"[{key}] all variants recorded (use --force to redo)")
        return row

    cfg, params, info = train_model(model, steps, lr, train_ann, train_imgs,
                                    geo, lr_scaling=lr_scaling, device=device,
                                    bank_dir=bank_dir)
    row.update(_eval_rows(
        key, missing, cfg, params, info, geo, steps, lr,
        CocoPoseDataset(val_ann, val_imgs), device, bank_dir,
        calib_set=CocoPoseDataset(train_ann, train_imgs),
        bank_seconds=bank_seconds))
    return row


def run_large(model: str, steps: int, lr: float = 1e-3, force: bool = False,
              device: str = "cuda", bank_dir: str = BANK_DIR) -> dict:
    """The small-tier weights (`run_model`'s, reused when trained) on the
    val_large bank: the regime slice of the scale-search study."""
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset

    geo = GEOMETRIES["small"]
    train_ann, train_imgs, large_ann, large_imgs, bank_seconds = _banks(
        bank_dir, geo, "val_large")
    key = model + "+large"
    row = _load_results(bank_dir).get(key, {})
    missing = _missing(row, LARGE_VARIANTS, force, steps, lr)
    if not missing:
        print(f"[{key}] all variants recorded (use --force to redo)")
        return row

    cfg, params, info = train_model(model, steps, lr, train_ann, train_imgs,
                                    geo, device=device, bank_dir=bank_dir)
    row.update(_eval_rows(
        key, missing, cfg, params, info, geo, steps, lr,
        CocoPoseDataset(large_ann, large_imgs), device, bank_dir,
        bank="val_large", bank_seconds=bank_seconds))
    return row


def run_curve(model: str, steps_list: tuple[int, ...], lr: float = 1e-3,
              force: bool = False, geometry: str = "small",
              device: str = "cuda", bank_dir: str = BANK_DIR) -> dict:
    """One run to max(steps_list) (its lr cut at the half of that) with a
    snapshot at each count; fidelity_tta AP at each: the AP-vs-steps
    convergence curve, rows {str(steps): result}."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset

    geo = GEOMETRIES[geometry]
    train_ann, train_imgs, val_ann, val_imgs, _ = _banks(bank_dir, geo, "val")
    total = max(steps_list)
    key = model + geo["key_suffix"] + "#curve"
    row = _load_results(bank_dir).get(key, {})
    missing = [s for s in sorted(steps_list)
               if force or str(s) not in row
               or row[str(s)].get("schedule_steps") != total]
    if not missing:
        print(f"[{key}] curve recorded (use --force to redo)")
        return row

    cfg, params, info = train_model(model, total, lr, train_ann, train_imgs,
                                    geo, snapshots=tuple(steps_list),
                                    device=device, bank_dir=bank_dir)
    val_set = CocoPoseDataset(val_ann, val_imgs)
    record = _load(RECORD_PATH).get(key, {})
    gpu = _device_line(device)
    for s in missing:
        p = params if s == total else ckpt.from_flax(ckpt.load_npz(
            snapshot_path(bank_dir, model, s, lr, geo, schedule_steps=total)))
        out = _stamp(eval_variant(cfg, p, "fidelity_tta", val_set, device),
                     s, lr, geo)
        want = record.get(str(s), {}).get("ap")
        out.update(schedule_steps=total, record_ap=want, device=gpu, **info)
        row[str(s)] = out
        _save_row(bank_dir, key, row)
        print(f"[{key}] {s} steps: AP {out['ap']:.4f} "
              f"({_beside(want, out['ap'])}) AP50 {out['ap50']:.4f} "
              f"({out['eval_seconds']}s)", flush=True)
    return row


def run_oracle(force: bool, geometry: str = "small", out_stride: int = 8,
               label_sigma: Optional[float] = None, device: str = "cuda",
               bank_dir: str = BANK_DIR) -> dict:
    """The GT-map oracle's rows (`ap_oracle`) under `ap_oracle.oracle_key`,
    with scripts/ap_benchmark.py's fields: the tier's val bank rendered at
    `out_stride` (and `label_sigma`) and decoded through the variants'
    configs, no training."""
    from openpose_plus_tpu_torch.eval_coco import evaluate_detections_full

    geo = GEOMETRIES[geometry]
    sigma = geo["sigma"] if label_sigma is None else label_sigma
    key = ap_oracle.oracle_key(geometry, out_stride, label_sigma)
    row = _load_results(bank_dir).get(key, {})
    variants = [v for v in ap_oracle.VARIANTS if force or v not in row]
    if not variants:
        print(f"[{key}] all oracle variants recorded (use --force)")
        return row

    bank = ap_oracle.oracle_bank(geometry)
    record = _load(RECORD_PATH).get(key, {})
    gpu = _device_line(device)
    for variant in variants:
        t0 = time.perf_counter()
        with torch.inference_mode():
            r = evaluate_detections_full(ap_oracle.oracle_detections(
                bank, variant, device, out_stride, label_sigma),
                bank.gt_by_image)
        out = {"ap": round(r.ap, 4), "ap50": round(r.ap50, 4),
               "ap75": round(r.ap75, 4), "ar": round(r.ar, 4),
               "n_val": geo["n_val"], "hin": geo["hin"], "stride": out_stride,
               "bank_size": geo["size"], "sigma": sigma,
               "eval_seconds": round(time.perf_counter() - t0, 1)}
        want = record.get(variant, {}).get("ap")
        out.update(record_ap=want, device=gpu)
        row[variant] = out
        _save_row(bank_dir, key, {variant: out})
        print(f"[{key}] {variant}: AP {out['ap']:.4f} "
              f"({_beside(want, out['ap'])}) AP50 {out['ap50']:.4f} "
              f"AP75 {out['ap75']:.4f} AR {out['ar']:.4f} "
              f"({out['eval_seconds']}s)", flush=True)
    return row


def _table(title: str, first: str, keys, cols, res: dict) -> None:
    print(f"\n### {title}\n")
    print(f"| {first} | " + " | ".join(cols) + " |")
    print("|---|" + "---|" * len(cols))
    for k, label in keys:
        cells = [f"{res[k][c]['ap']:.3f}" if c in res[k] else "—"
                 for c in cols]
        print(f"| {label} | " + " | ".join(cells) + " |")


def print_table(bank_dir: str = BANK_DIR) -> None:
    """The results as scripts/ap_benchmark.py's markdown tables: the model
    rows of each tier and of val_large, the oracle ceilings, the lr-rule
    rows and each convergence curve."""
    res = _load_results(bank_dir)
    for suffix, title in (("", "small tier (128x128 input)"),
                          ("@368", "serving tier (368x432 input)"),
                          ("+large", "val_large bank (small tier weights)")):
        keys = [m for m in MODELS if (m + suffix) in res]
        if not keys:
            continue
        cols = VARIANTS + INT8_VARIANTS + MS_STUDY_VARIANTS + FM_VARIANTS
        present = [c for c in cols
                   if any(c in res[m + suffix] for m in keys)]
        _table(title, "model", [(m + suffix, m) for m in keys], present, res)
    oracles = sorted(k for k in res if k.startswith("oracle"))
    if oracles:
        _table("oracle ceilings (GT maps through the decoder)", "key",
               [(k, k) for k in oracles], ap_oracle.VARIANTS, res)
    rules = sorted(k for k in res if k.endswith("#lrrule"))
    if rules:
        _table("lr-rule validation (lr_scaling=inv-sqrt-area, zoo-default "
               "lr_init)", "key", [(k, k) for k in rules],
               VARIANTS + FM_VARIANTS, res)
    for k in sorted(k for k in res if k.endswith("#curve")):
        steps = sorted(int(s) for s in res[k])
        print(f"\n### {k}\n")
        print("| steps | " + " | ".join(str(s) for s in steps) + " |")
        print("|---|" + "---|" * len(steps))
        print("| AP (+tta) | "
              + " | ".join(f"{res[k][str(s)]['ap']:.3f}" for s in steps)
              + " |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=MODELS)
    ap.add_argument("--all", action="store_true",
                    help="every model of the zoo in turn")
    ap.add_argument("--table", action="store_true",
                    help="only print the tables of the recorded results")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--geometry", choices=tuple(GEOMETRIES), default="small")
    ap.add_argument("--lr-scaling", choices=("none", "inv-sqrt-area"),
                    default="none",
                    help="train with the geometry-transfer lr rule; results "
                         "record under <model><tier>#lrrule")
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate the calibrated int8 engine "
                         "(fidelity_int8)")
    ap.add_argument("--frag-merge", action="store_true",
                    help="also evaluate the fragment-merge repair pass")
    ap.add_argument("--ms-study", action="store_true",
                    help="also evaluate the scale sets (1.0,1.5), "
                         "(1.0,1.5,2.0) and the dedup-combined default set")
    ap.add_argument("--large-bank", action="store_true",
                    help="evaluate the small-tier weights on the val_large "
                         "bank (frame-filling figures)")
    ap.add_argument("--oracle", action="store_true",
                    help="decode GT maps through the decoder configs: the "
                         "quality axis's ceiling rows (no training)")
    ap.add_argument("--out-stride", type=int, default=8,
                    help="oracle probe: render GT maps at this stride")
    ap.add_argument("--label-sigma", type=float, default=None,
                    help="oracle probe: override the GT Gaussian sigma")
    ap.add_argument("--curve", type=str, default=None,
                    help="comma-separated step counts, e.g. "
                         "4000,16000,32000,64000: one continuous run, AP at "
                         "each snapshot")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bank-dir", default=BANK_DIR,
                    help="banks, weights and results.json")
    args = ap.parse_args(argv)

    if args.table:
        print_table(args.bank_dir)
        return
    if args.oracle:
        run_oracle(args.force, args.geometry, args.out_stride,
                   args.label_sigma, args.device, args.bank_dir)
        print_table(args.bank_dir)
        return
    models = MODELS if args.all else ((args.model,) if args.model else ())
    if not models:
        raise SystemExit("pass --model NAME, --all, or --table")
    for m in models:
        if args.curve:
            steps_list = tuple(int(s) for s in args.curve.split(","))
            run_curve(m, steps_list, args.lr, args.force, args.geometry,
                      args.device, args.bank_dir)
        elif args.large_bank:
            run_large(m, args.steps, args.lr, args.force, args.device,
                      args.bank_dir)
        else:
            run_model(m, args.steps, args.lr, args.force, args.geometry,
                      args.lr_scaling, args.frag_merge, args.device,
                      args.int8, args.ms_study, args.bank_dir)
    print_table(args.bank_dir)


if __name__ == "__main__":
    main()
