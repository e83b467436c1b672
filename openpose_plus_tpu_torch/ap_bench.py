"""Synthetic AP benchmark, the model rows, on the port.

Counterpart of the model rows of `scripts/ap_benchmark.py`: train a zoo
model on the seeded TRAIN scene bank (`data.synthetic.make_scene_bank`),
then evaluate keypoint AP on the held-out val bank (`eval_coco.
evaluate_engine`) under cumulative inference settings:

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

Geometry tiers (--geometry): "small" (256 px scenes, 128x128 input) and
"serving" (736 px scenes, 368x432 input, rows keyed "<model>@368"). The
banks, the trained weights (the JAX flat npz layout, `checkpoint.
save_npz`), a loss CSV per training run and the results
(`results.json`) go to the git-ignored `.ap_bench_torch/`; the JAX
package's record `ap_benchmark.json` is only read, and each row prints
beside its record for the same key. The scale-set study, `--large-bank`
and `--curve` wait for their own items (ROADMAP.md §1).

    python -m openpose_plus_tpu_torch.ap_bench --model mobilenet_thin \\
        --geometry serving --steps 16000 --lr 1e-3 --frag-merge
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_PATH = os.path.join(HERE, "ap_benchmark.json")    # read only
BANK_DIR = os.path.join(HERE, ".ap_bench_torch")
RESULTS_PATH = os.path.join(BANK_DIR, "results.json")

MODELS = ("mobilenet_thin", "vggtiny", "hao28", "vgg19")
VARIANTS = ("base", "fidelity", "fidelity_tta", "fidelity_tta_ms")
FM_VARIANTS = ("fidelity_fm", "fidelity_tta_fm", "fidelity_tta_msdd_fm")
INT8_VARIANTS = ("fidelity_int8",)
CALIB_IMAGES = 8      # train images the int8 variant calibrates on
MS_SCALES = {"fidelity_tta_ms": (0.5, 1.0, 1.5),
             "fidelity_tta_msdd_fm": (0.5, 1.0, 1.5)}

# scripts/ap_benchmark.py GEOMETRIES: bank image size, network input, GT
# label widths in input pixels, bank sizes, cache tag and result key
GEOMETRIES = {
    "small": dict(size=256, hin=128, win=128, sigma=5.0, limb=5.0,
                  n_train=256, n_val=96, tag="", key_suffix=""),
    "serving": dict(size=736, hin=368, win=432, sigma=8.0, limb=8.0,
                    n_train=256, n_val=96, tag="_h368", key_suffix="@368"),
}


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_results(res: dict) -> None:
    os.makedirs(BANK_DIR, exist_ok=True)
    with open(RESULTS_PATH, "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
        f.write("\n")


def build_config(model: str, ann: str, imgs: str, steps: int, lr: float,
                 geo: dict, lr_scaling: str = "none"):
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
            checkpoint_dir=os.path.join(BANK_DIR, f"ck_{model}")),
    )


def _weights_path(model: str, steps: int, lr: float, geo: dict,
                  lr_scaling: str) -> str:
    tag = geo["tag"] + ("_lrs" if lr_scaling != "none" else "")
    return os.path.join(BANK_DIR, f"{model}_s{steps}_lr{lr:g}{tag}.npz")


def train_model(model: str, steps: int, lr: float, ann: str, imgs: str,
                geo: dict, lr_scaling: str = "none",
                device: str = "cuda") -> tuple:
    """Train on the train bank; returns (cfg, state_dict, info). The weights
    are cached as a JAX-layout npz under BANK_DIR (lr and geometry in the
    name), so the eval variants never retrain; the loss every 100 steps
    goes to a CSV beside them."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.pipeline import TrainPipeline

    cfg = build_config(model, ann, imgs, steps, lr, geo, lr_scaling)
    path = _weights_path(model, steps, lr, geo, lr_scaling)
    if os.path.exists(path):
        print(f"[{model}] reusing trained weights {path}", flush=True)
        return cfg, ckpt.from_flax(ckpt.load_npz(path)), {}

    state = T.create_train_state(cfg, seed=0, device=device)
    pipeline = TrainPipeline(CocoPoseDataset(ann, imgs), cfg, seed=0,
                             cache_decoded=True)
    step_fn = T.make_train_step_on_batch(cfg)
    curve = path[:-len(".npz")] + "_loss.csv"
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
                            f"{metrics['lr']:.6g},{seconds:.3f}\n")
                    f.flush()
                    print(f"[{model}] step {i + 1}/{steps}: loss "
                          f"{loss:.2f} ({seconds:.0f}s)", flush=True)
    finally:
        pipeline.stop()
    seconds = time.perf_counter() - t0
    if not all(map(math.isfinite, losses)):
        raise FloatingPointError(f"[{model}] non-finite loss: {losses}")
    ckpt.save_npz(path, state.model.state_dict())
    print(f"[{model}] trained {steps} steps in {seconds:.0f}s, loss "
          f"{losses[0]:.1f} -> {losses[-1]:.1f}; saved {path}", flush=True)
    info = {"train_seconds": seconds,
            "imgs_per_sec": steps * cfg.train.batch_size / seconds,
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_csv": os.path.relpath(curve, HERE)}
    return cfg, state.model.state_dict(), info


def eval_variant(cfg, params, variant: str, dataset,
                 device: str = "cuda", calib_dataset=None) -> dict:
    """One inference variant's AP over the val bank; the int8 variant
    calibrates on `calib_dataset` (the train bank)."""
    from openpose_plus_tpu_torch.engine import Engine
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine

    ecfg = cfg
    if variant != "base":
        ecfg = cfg.replace(postproc=cfg.postproc.fidelity())
    if variant.endswith("_fm"):
        ecfg = ecfg.replace(postproc=dataclasses.replace(
            ecfg.postproc, fragment_merge_rel=0.5))
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


def _gpu_line() -> str:
    """The card's name and power limit (nvidia-smi), or the device type."""
    if not torch.cuda.is_available():
        return "cpu"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_model(model: str, steps: int, lr: float, force: bool,
              geometry: str = "small", lr_scaling: str = "none",
              frag_merge: bool = False, device: str = "cuda",
              int8: bool = False) -> dict:
    """Train one model at one tier and evaluate its variants; returns the
    row ({variant: result}) as stored in RESULTS_PATH."""
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank

    geo = GEOMETRIES[geometry]
    os.makedirs(BANK_DIR, exist_ok=True)
    t0 = time.perf_counter()
    train_ann, train_imgs = make_scene_bank(
        BANK_DIR, "train", geo["n_train"], geo["size"])
    val_ann, val_imgs = make_scene_bank(
        BANK_DIR, "val", geo["n_val"], geo["size"])
    bank_seconds = time.perf_counter() - t0

    key = model + geo["key_suffix"] + (
        "#lrrule" if lr_scaling != "none" else "")
    record = _load(RECORD_PATH).get(key, {})
    res = _load(RESULTS_PATH)
    row = res.get(key, {})
    variants = (VARIANTS + (FM_VARIANTS if frag_merge else ())
                + (INT8_VARIANTS if int8 else ()))
    missing = [v for v in variants
               if force or v not in row or row[v].get("steps") != steps
               or row[v].get("lr", lr) != lr]
    if not missing:
        print(f"[{key}] all variants recorded (use --force to redo)")
        return row

    cfg, params, info = train_model(model, steps, lr, train_ann, train_imgs,
                                    geo, lr_scaling, device)
    val_set = CocoPoseDataset(val_ann, val_imgs)
    train_set = CocoPoseDataset(train_ann, train_imgs)
    gpu = _gpu_line()
    for variant in missing:
        out = eval_variant(cfg, params, variant, val_set, device,
                           calib_dataset=train_set)
        want = record.get(variant, {}).get("ap")
        out.update(steps=steps, lr=lr, n_val=geo["n_val"], hin=geo["hin"],
                   bank_size=geo["size"], record_ap=want, device=gpu,
                   bank_seconds=round(bank_seconds, 1), **info)
        row[variant] = out
        res = _load(RESULTS_PATH)
        res[key] = {**res.get(key, {}), **row}
        _save_results(res)            # incremental: survive interruption
        beside = ("no JAX record" if want is None else
                  f"JAX record {want:.4f}, delta {out['ap'] - want:+.4f}")
        print(f"[{key}] {variant}: AP {out['ap']:.4f} ({beside}) "
              f"AP50 {out['ap50']:.4f} AR {out['ar']:.4f} "
              f"({out['eval_seconds']}s)", flush=True)
    print(json.dumps({"ap_bench": {"key": key, "gpu": gpu, "row": row}}),
          flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=MODELS, required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--geometry", choices=tuple(GEOMETRIES), default="small")
    ap.add_argument("--lr-scaling", choices=("none", "inv-sqrt-area"),
                    default="none",
                    help="train with the geometry-transfer lr rule; results "
                         "record under <model><tier>#lrrule")
    ap.add_argument("--frag-merge", action="store_true",
                    help="also evaluate the fragment-merge repair pass")
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate the calibrated int8 engine "
                         "(fidelity_int8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_model(args.model, args.steps, args.lr, args.force, args.geometry,
              args.lr_scaling, args.frag_merge, args.device, args.int8)


if __name__ == "__main__":
    main()
