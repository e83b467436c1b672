"""End-to-end learning demo on synthetic data: train -> decode -> AP.

Counterpart of `scripts/synthetic_e2e.py`: renders a dataset of stick
figures (`data.synthetic.standing_person`, drawn with cv2; images and
COCO-format keypoint annotations), trains a small model with the real
pipeline (augmentation, GT maps on the device, the train step), and
evaluates keypoint AP with the real evaluator (letterbox -> engine ->
grouping -> OKS matching), before and after training.

    python -m openpose_plus_tpu_torch.synthetic_e2e --steps 300 --n-images 64

Prints one JSON line: {"ap_before": ..., "ap_after": ..., "loss_first":
..., "loss_last": ...}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np


def make_synthetic_dataset(out_dir: str, n_images: int, size: int = 256,
                           seed: int = 0) -> tuple[str, str]:
    """Stick-figure scenes + COCO-format annotations; returns
    (annotations.json path, images dir)."""
    import cv2

    from openpose_plus_tpu_torch import skeleton
    from openpose_plus_tpu_torch.data.synthetic import standing_person

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 0
    for i in range(n_images):
        img = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            s = rng.uniform(size / 48, size / 24)  # pixels per canonical unit
            cx = rng.uniform(6 * s, size - 6 * s)
            cy = rng.uniform(12 * s, size - 10 * s)
            # the canonical figure spans ~[-5,5] x [-11,9] units around its
            # center: evaluated at (cx/s, cy/s) and scaled by s it stands
            # at (cx, cy) in pixels
            pose = {p: (x * s, y * s)
                    for p, (x, y) in standing_person(cx / s, cy / s).items()}
            color = tuple(int(c) for c in rng.integers(120, 255, 3))
            for ia, ib in skeleton.COCO_PAIRS_RENDER:
                cv2.line(img, (int(pose[ia][0]), int(pose[ia][1])),
                         (int(pose[ib][0]), int(pose[ib][1])), color, 2)
            for p, (x, y) in pose.items():
                cv2.circle(img, (int(x), int(y)), 3,
                           skeleton.COCO_COLORS[p % 18], -1)
            kp = []
            for p18 in skeleton.COCO_FROM_OPENPOSE:
                x, y = pose[p18]
                v = 2 if 0 <= x < size and 0 <= y < size else 0
                kp += [float(x), float(y), v]
            xs = [pose[p][0] for p in pose]
            ys = [pose[p][1] for p in pose]
            area = max((max(xs) - min(xs)) * (max(ys) - min(ys)), 1.0)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": 1, "iscrowd": 0,
                "area": float(area), "keypoints": kp, "segmentation": [],
            })
            ann_id += 1
        name = f"syn{i:04d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
    ann_path = os.path.join(out_dir, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return ann_path, img_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-images", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--hin", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--eval-limit", type=int, default=32)
    ap.add_argument("--model", default="vggtiny")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.pipeline import TrainPipeline
    from openpose_plus_tpu_torch.engine import Engine
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine

    workdir = args.workdir or tempfile.mkdtemp(prefix="synth_e2e_")
    ann, imgs = make_synthetic_dataset(workdir, args.n_images, args.size)

    cfg = default_config(args.model)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=args.hin, win=args.hin,
                                  n_stages=3),
        data=dataclasses.replace(
            cfg.data, train_annotations=ann, train_images=imgs,
            num_workers=4, prefetch=4,
            # mild augmentation: the synthetic set is small
            rotate_max_deg=15.0, scale_min=0.8, scale_max=1.1,
            shift_frac=0.1, sigma=6.0, limb_width=6.0),
        train=dataclasses.replace(
            cfg.train, batch_size=args.batch, lr_init=args.lr,
            lr_decay_every=10_000, weight_decay=0.0, log_every=50,
            checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(workdir, "ck")),
    )

    dataset = CocoPoseDataset(ann, imgs)
    print(f"dataset: {len(dataset)} images", flush=True)

    state = T.create_train_state(cfg, seed=0, device=args.device)
    ap_before = evaluate_engine(
        Engine(cfg, params=state.model.state_dict(), device=args.device),
        dataset, batch_size=args.batch, limit=args.eval_limit)

    pipeline = TrainPipeline(dataset, cfg, seed=0)
    step_fn = T.make_train_step_on_batch(cfg)
    it = iter(pipeline)
    losses = []
    try:
        for i in range(args.steps):
            state, metrics = step_fn(state, next(it))
            if i % 50 == 0 or i == args.steps - 1:
                losses.append(float(metrics["loss"]))
                print(f"step {i}: loss {losses[-1]:.2f}", flush=True)
    finally:
        pipeline.stop()

    ap_after = evaluate_engine(
        Engine(cfg, params=state.model.state_dict(), device=args.device),
        dataset, batch_size=args.batch, limit=args.eval_limit)
    print(json.dumps({
        "ap_before": round(ap_before.ap, 4),
        "ap_after": round(ap_after.ap, 4),
        "ap50_after": round(ap_after.ap50, 4),
        "ar_after": round(ap_after.ar, 4),
        "loss_first": round(losses[0], 2),
        "loss_last": round(losses[-1], 2),
        "workdir": workdir,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
