"""Command-line apps of the port (`openpose_plus_tpu/cli.py`, the same
subcommands and flags, plus `--device`, default cuda):

    python -m openpose_plus_tpu_torch infer  --images a.jpg --draw-dir out/
    python -m openpose_plus_tpu_torch stream --video clip.avi
    python -m openpose_plus_tpu_torch stream --images 'photos/*.jpg' --loop
    python -m openpose_plus_tpu_torch camera --device 0
    python -m openpose_plus_tpu_torch eval   --annotations ... --images ...
    python -m openpose_plus_tpu_torch train  --model vgg19 ...
    torchrun --nproc-per-node N -m openpose_plus_tpu_torch train --parallel \
        --kf-optimizer sma ...
    torchrun --nproc-per-node N -m openpose_plus_tpu_torch eval \
        --distributed ...
    python -m openpose_plus_tpu_torch export --out engine_dir/ --batch 8
    python -m openpose_plus_tpu_torch infer  --engine-dir engine_dir/ ...
    python -m openpose_plus_tpu_torch bench

`export` writes a torch.export artifact (weights baked in) that `infer
--engine-dir` runs without the model-building code. `--checkpoint` takes
what `checkpoint` reads: a checkpoint directory of `train_loop`, or the
JAX package's flat `.npz` (through the weight bridge). In `camera`,
`--device` is the camera's index, as in the reference, and the torch device
is `--torch-device`. `stream` letterboxes on the port's thread pool
(`loader.py`; with `--images` it decodes there too) and prints the host
scopes' report (`utils.tracer`) where the reference prints its native
tracer's. `bench` runs the benchmark table (`bench.py`; its other modes:
`python -m openpose_plus_tpu_torch.bench {one,train,stream}`).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import Optional


def _build_engine(args):
    from openpose_plus_tpu_torch.config import default_config
    from openpose_plus_tpu_torch.engine import Engine

    cfg = default_config(args.model)
    mc = dataclasses.replace(cfg.model, hin=args.input_height,
                             win=args.input_width)
    if getattr(args, "int8", False):
        mc = dataclasses.replace(mc, compute_dtype="int8")
    cfg = cfg.replace(model=mc)
    if getattr(args, "fidelity", False):
        cfg = cfg.replace(postproc=cfg.postproc.fidelity())
    if getattr(args, "frag_merge", 0.0):
        cfg = cfg.replace(postproc=dataclasses.replace(
            cfg.postproc, fragment_merge_rel=args.frag_merge))
    params = None
    if args.checkpoint:
        from openpose_plus_tpu_torch import checkpoint as ckpt

        if args.checkpoint.endswith(".npz"):
            params = ckpt.load_npz(args.checkpoint)
        else:
            from openpose_plus_tpu_torch import train as T

            # checkpoints hold float-mode models; int8 is a serving mode
            float_cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, compute_dtype="bfloat16", fused_inference=False))
            template = T.create_train_state(float_cfg, device="cpu")
            params = ckpt.restore(args.checkpoint,
                                  template).model.state_dict()
    return Engine(cfg, params=params, device=args.torch_device)


def add_device_flag(p: argparse.ArgumentParser, flag: str = "--device",
                    dest: str = "torch_device") -> None:
    """The torch device flag (default cuda: without a card only the CPU,
    asked for by name, runs)."""
    p.add_argument(flag, dest=dest, default="cuda",
                   help="torch device to run on (default cuda)")


def _engine_flags(p: argparse.ArgumentParser,
                  device_flag: str = "--device") -> None:
    p.add_argument("--model", default="mobilenet_thin")
    p.add_argument("--checkpoint", default=None,
                   help="train_loop checkpoint dir or .npz weights")
    p.add_argument("--input-height", type=int, default=368)
    p.add_argument("--input-width", type=int, default=432)
    p.add_argument("--fidelity", action="store_true",
                   help="reference-style high-fidelity grouping (8x maps)")
    p.add_argument("--int8", action="store_true",
                   help="calibrated int8 serving (TensorRT int8 analogue; "
                        "calibrates activation scales on the first batch)")
    p.add_argument("--frag-merge", type=float, default=0.0, metavar="REL",
                   help="fragment-merge repair pass: re-join disjoint-part "
                        "skeletons closer than REL x the larger fragment's "
                        "bbox diagonal (0 = off; 0.5 = tuned setting)")
    add_device_flag(p, device_flag)


def _load(path: str, hin: int, win: int):
    """An image file letterboxed to the network input: (image, scale,
    pad), a large JPEG decoded DCT-scaled (`loader.load_image`, the
    reference's native decode). FileNotFoundError if it cannot be read."""
    from openpose_plus_tpu_torch.loader import load_image

    loaded = load_image(path, hin, win)
    if loaded is None:
        raise FileNotFoundError(path)
    return loaded


# engine-building flags and their defaults: an artifact fixes them
_ENGINE_FLAGS = (("checkpoint", None), ("fidelity", False),
                 ("model", "mobilenet_thin"), ("int8", False),
                 ("input_height", 368), ("input_width", 432),
                 ("torch_device", "cuda"))


def cmd_infer(args) -> int:
    """Batch image files -> skeletons (example-inference-1 equivalent)."""
    import numpy as np

    from openpose_plus_tpu_torch.eval_coco import humans_to_detections

    if args.engine_dir:
        # a frozen artifact fixes the model, weights, dims, grouping and
        # device at export time: reject the flags rather than ignore them
        for flag, default in _ENGINE_FLAGS:
            if getattr(args, flag) != default:
                print(f"--engine-dir runs a frozen artifact; --"
                      f"{flag.replace('_', '-')} has no effect (set it at "
                      "`export` time)", file=sys.stderr)
                return 2
        from openpose_plus_tpu_torch.export import load_engine

        eng = load_engine(args.engine_dir)
        args.batch = eng.batch_size
    else:
        eng = _build_engine(args)
    m = eng.config.model
    paths = _expand(args.images)
    if not paths:
        print("no input images", file=sys.stderr)
        return 2
    out = []
    for i in range(0, len(paths), args.batch):
        chunk = paths[i:i + args.batch]
        images, metas = [], []
        for p in chunk:
            img, scale, pad = _load(p, m.hin, m.win)
            images.append(img)
            metas.append((p, scale, pad))
        while len(images) < args.batch:
            images.append(np.zeros_like(images[0]))
        humans = eng.infer(np.stack(images))
        for b, (p, scale, pad) in enumerate(metas):
            dets = humans_to_detections(humans, b, 0, scale, pad, m.hin,
                                        m.win)
            out.append({"image": p, "n_humans": len(dets),
                        "humans": [
                            {"score": d.score,
                             "keypoints": d.keypoints.round(2).tolist()}
                            for d in dets]})
            print(f"{p}: {len(dets)} humans")
            if args.draw_dir:
                _draw(p, humans, b, args.draw_dir)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0


def _draw(path: str, humans, b: int, draw_dir: str) -> None:
    import cv2

    from openpose_plus_tpu_torch.utils.vis import draw_humans

    os.makedirs(draw_dir, exist_ok=True)
    vis = draw_humans(cv2.imread(path), humans, b)
    cv2.imwrite(os.path.join(draw_dir, os.path.basename(path)), vis)


def cmd_stream(args) -> int:
    """Sustained pipelined throughput (example-stream-detector)."""
    from openpose_plus_tpu_torch.stream import StreamEstimator
    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    paths = _expand(args.images or [])
    if not args.video and not paths:
        print("no input images (use --images or --video)", file=sys.stderr)
        return 2
    est = StreamEstimator(_build_engine(args), batch=args.batch,
                          workers=args.workers)
    if args.video:
        it = est.run_video(args.video)
    else:
        it = est.run_files(paths, loop=args.loop)
    n_batches = args.repeat if args.loop else None
    frames = 0
    t0: Optional[float] = None
    with GLOBAL_TRACER.recording() as rec:
        try:
            for i, r in enumerate(it):
                if i == 0:
                    t0 = time.perf_counter()   # skip the warm-up batch
                else:
                    frames += r.n
                if n_batches is not None and i >= n_batches:
                    break
        finally:
            it.close()
    dt = time.perf_counter() - (t0 or time.perf_counter())
    if frames:
        print(f"{frames} frames in {dt:.2f}s = {frames / dt:.1f} FPS")
    print(rec.report())
    return 0


def cmd_camera(args) -> int:
    """Live camera loop (example-live-camera)."""
    import cv2
    import numpy as np

    from openpose_plus_tpu_torch.stream import StreamEstimator
    from openpose_plus_tpu_torch.utils.vis import draw_humans

    cap = cv2.VideoCapture(args.device)
    if not cap.isOpened():
        print(f"cannot open camera {args.device}", file=sys.stderr)
        return 2
    try:
        eng = _build_engine(args)
        est = StreamEstimator(eng, batch=1)

        def frames():
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

        for r in est.run_frames(frames()):
            print(f"frame {int(r.indices[0])}: "
                  f"{int(r.humans.num_humans[0])} humans")
            if args.save_dir:
                os.makedirs(args.save_dir, exist_ok=True)
                m = eng.config.model
                canvas = np.zeros((m.hin, m.win, 3), np.uint8)
                cv2.imwrite(os.path.join(args.save_dir,
                                         f"frame{int(r.indices[0]):06d}.jpg"),
                            draw_humans(canvas, r.humans, 0))
    finally:
        cap.release()
    return 0


def cmd_bench(args) -> int:
    """The device benchmark's table (`bench.table`), as the reference runs
    its `bench.main()`."""
    from openpose_plus_tpu_torch import bench

    bench.table(device=args.device)
    return 0


def cmd_eval(args) -> int:
    """COCO val AP. Under torchrun, `--distributed` starts the process
    group: each rank evaluates its slice on its device and every rank
    prints the AP of the whole set."""
    import torch.distributed as dist

    from openpose_plus_tpu_torch.config import ParallelConfig
    from openpose_plus_tpu_torch.parallel.sharding import init_distributed

    if args.distributed and "WORLD_SIZE" in os.environ:
        started = not dist.is_initialized()
        args.torch_device = init_distributed(ParallelConfig(multihost=True),
                                             device=args.torch_device)
        try:
            return _eval(args)
        finally:
            if started:
                dist.destroy_process_group()
    return _eval(args)


def _eval(args) -> int:
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine

    eng = _build_engine(args)
    if args.calib_images:
        paths = sorted(
            p for p in glob.glob(os.path.join(args.calib_images, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if not paths:
            print(f"no images under {args.calib_images}", file=sys.stderr)
            return 2
        eng.calibrate_from_paths(paths[:args.calib_count])
    ds = CocoPoseDataset(args.annotations, args.images)
    res = evaluate_engine(eng, ds, batch_size=args.batch, limit=args.limit,
                          distributed=args.distributed,
                          flip_tta=args.flip_tta,
                          scales=tuple(args.scales) if args.scales else None,
                          ms_combine=args.ms_combine)
    print(json.dumps(res.as_dict()))
    return 0


def cmd_train(args, extra) -> int:
    from openpose_plus_tpu_torch import train as T

    T.main(extra)
    return 0


def cmd_export(args) -> int:
    """Freeze the engine to a torch.export artifact."""
    import numpy as np

    from openpose_plus_tpu_torch.export import save_engine

    eng = _build_engine(args)
    if args.int8:
        # an int8 artifact freezes the activation scales: calibrate first
        paths = _expand(args.calib_images or [])
        if not paths:
            print("--int8 export needs --calib-images (representative "
                  "images; their max activations become the frozen "
                  "quantization scales)", file=sys.stderr)
            return 2
        m = eng.config.model
        eng.calibrate(np.stack([_load(p, m.hin, m.win)[0] for p in paths]))
    save_engine(eng, args.out, batch_size=args.batch,
                input_layout=args.input_layout)
    print(json.dumps({"out": args.out, "model": args.model,
                      "batch_size": args.batch,
                      "input_layout": args.input_layout}))
    return 0


def _expand(patterns) -> list[str]:
    out = []
    for p in patterns:
        hits = sorted(glob.glob(p))
        out.extend(hits if hits else ([p] if os.path.exists(p) else []))
    return out


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="openpose_plus_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("infer", help="pose estimation on image files")
    _engine_flags(p)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--draw-dir", default=None)
    p.add_argument("--json-out", default=None)
    p.add_argument("--engine-dir", default=None,
                   help="run a frozen artifact from `export` instead of "
                        "building the model")

    p = sub.add_parser("stream", help="pipelined stream throughput")
    _engine_flags(p)
    p.add_argument("--images", nargs="+", default=None,
                   help="image files or glob patterns")
    p.add_argument("--video", default=None, help="stream a video file")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=8,
                   help="host threads decoding and letterboxing")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--repeat", type=int, default=50,
                   help="batches to time in --loop mode")

    p = sub.add_parser("camera", help="live camera inference")
    _engine_flags(p, device_flag="--torch-device")
    p.add_argument("--device", type=int, default=0, help="camera index")
    p.add_argument("--save-dir", default=None,
                   help="write rendered skeleton frames here")

    p = sub.add_parser("bench", help="device benchmark: the table of "
                                     "bench.py's rows")
    add_device_flag(p, dest="device")

    p = sub.add_parser("eval", help="COCO keypoint AP evaluation")
    _engine_flags(p)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--scales", type=float, nargs="+", default=None,
                   help="multi-scale search, e.g. --scales 0.5 1.0 1.5")
    p.add_argument("--ms-combine", choices=("avg", "dedup"), default="avg",
                   help="multi-scale combiner: avg = map averaging, dedup "
                        "= per-scale decode + OKS-NMS merge")
    p.add_argument("--flip-tta", action="store_true",
                   help="average horizontally-flipped predictions")
    p.add_argument("--calib-images", default=None,
                   help="directory of train-side images to calibrate int8 "
                        "activation scales on; default: first eval batch")
    p.add_argument("--calib-count", type=int, default=8,
                   help="number of calibration images to use")

    sub.add_parser("train", help="train a model (see train.py flags)")

    p = sub.add_parser("export", help="freeze the engine to a torch.export "
                                      "artifact")
    _engine_flags(p)
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--calib-images", nargs="+", default=None,
                   help="representative images for --int8 export "
                        "(activation scales are frozen into the artifact)")
    p.add_argument("--input-layout", default="plain",
                   choices=["plain", "s2d", "s2d2"],
                   help="input signature baked into the artifact; loaded "
                        "artifacts still accept plain images and permute "
                        "on the host")

    args, extra = parser.parse_known_args(argv)
    if args.cmd == "train":
        return cmd_train(args, extra)
    if extra:
        parser.error(f"unknown arguments: {extra}")
    return {"infer": cmd_infer, "stream": cmd_stream, "camera": cmd_camera,
            "bench": cmd_bench, "eval": cmd_eval,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
