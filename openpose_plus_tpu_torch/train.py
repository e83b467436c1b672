"""Training: deep-supervision loss, optimizer and schedule, the train
step, the loop with resume on one device or several ranks, and the CLI.

Port of `openpose_plus_tpu/train.py`, function for function:

  * loss: the sum over stages of the masked L2 of (conf, paf) against the
    GT maps, each stage's term summed over pixels and channels and averaged
    over the batch (`pose_loss`)
  * optimizer: Adam or momentum SGD with a staircase lr decay; the weight
    decay is coupled L2 added to the gradient before the optimizer (as
    `optax.add_decayed_weights` chained in front of it; not AdamW), on the
    4-D kernels only (`make_optimizer`)
  * the step synthesises the GT maps on the device from the batch's
    keypoints (`data.targets.make_targets`), so the host only decodes and
    warps images (`data.pipeline.TrainPipeline`)
  * checkpoints with resume (`checkpoint.save` / `restore`)

A step runs on one torch device, the card unless the caller passes
`device="cpu"`; without a CUDA device the default raises. On the card the
single-device step is one CUDA-graph replay (the reference jits it): the
first CAPTURE_WARMUP steps of a batch shape run eagerly, each a real step
on its own batch, the next is captured and replayed, and every later step
copies its batch into the graph's buffers and replays (`make_train_step`,
`make_train_step_on_batch`, the world-of-one step of
`kungfu.make_kungfu_steps`, so `train_loop`, `ap_bench` and `bench
train`). The lr lives in a float32 tensor on the parameters' device that
the schedule fills before each step, so a replay reads this step's lr. On
the CPU, and for the multi-rank strategies, the spatial forward and
`_update`'s hooks, the step runs eagerly, as do the heatmap dumps
(`_dump_vis`). `train_loop`
runs on every rank of the process group it finds (or starts, with
`config.parallel.multihost`: one process a rank under `torchrun`), with
the KungFu strategy `config.train.kf_optimizer` ("sync-sgd", "sma",
"pair-avg"; `parallel/kungfu.py`); `config.train.batch_size` is the global
batch. `config.parallel.spatial_parallelism > 1` shards the image height
too: the ranks form a (data, spatial) mesh, each rank runs the model on
its band of rows with halo-exchanged convs (`parallel/spatial.py`), and
sync-sgd sums the bands' gradients (sma and pair-avg refuse the axis, as
in the reference).

    python -m openpose_plus_tpu_torch.train --model mobilenet_thin \\
        --train-images DIR --train-annotations FILE --steps 1000
    torchrun --nproc-per-node 8 -m openpose_plus_tpu_torch.train \\
        --parallel --kf-optimizer sma ...
    torchrun --nproc-per-node 8 -m openpose_plus_tpu_torch.train \\
        --parallel --spatial 2 ...
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from openpose_plus_tpu_torch.config import Config, TrainConfig
from openpose_plus_tpu_torch.data.targets import make_targets
from openpose_plus_tpu_torch.engine import preprocess_images
from openpose_plus_tpu_torch.graphs import (CAPTURE_WARMUP, capture_graph,
                                            on_side_stream)
from openpose_plus_tpu_torch.models import common, get_model


@dataclasses.dataclass
class _Captured:
    """A captured train step: its graph, the static device buffers the
    batch is copied into, and the graph's own metrics (each replay
    overwrites them)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    metrics: dict


@dataclasses.dataclass
class TrainState:
    """The step count and the objects a step updates in place: the model
    (in train mode), its optimizer and its lr schedule. `graphs` holds the
    state's captured steps on the card, keyed by the step's kind and the
    batch's shapes and dtypes: the count of eager warm-up steps taken so
    far, then the `_Captured` step."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    device: torch.device
    graphs: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Load in place. The optimizer's state tensors and lr are new
        objects afterwards, so the captured steps are dropped: the next
        steps warm up and capture again."""
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        _device_lr(self.optimizer)
        self.graphs.clear()


def effective_lr_init(cfg: TrainConfig, out_area: Optional[int] = None
                      ) -> float:
    """lr_init after the geometry-transfer rule (TrainConfig.lr_scaling):
    "inv-sqrt-area" scales it by sqrt(lr_ref_area / out_area)."""
    if cfg.lr_scaling == "none" or out_area is None:
        return cfg.lr_init
    if cfg.lr_scaling != "inv-sqrt-area":
        raise ValueError(f"unknown lr_scaling {cfg.lr_scaling!r}")
    return cfg.lr_init * float(cfg.lr_ref_area / out_area) ** 0.5


def _decay(cfg: TrainConfig) -> Callable[[int], float]:
    """The staircase factor at optimizer step `count` (counted before that
    step, as optax counts)."""
    return lambda count: cfg.lr_decay_factor ** (count // cfg.lr_decay_every)


def lr_schedule(cfg: TrainConfig, out_area: Optional[int] = None
                ) -> Callable[[int], float]:
    """count -> lr: effective_lr_init * decay_factor ** (count //
    decay_every), the staircase exponential decay."""
    init, decay = effective_lr_init(cfg, out_area), _decay(cfg)
    return lambda count: init * decay(count)


class MomentumSGD(torch.optim.SGD):
    """`torch.optim.SGD` (momentum, no dampening, not Nesterov) that takes
    a tensor lr on the card: buf = momentum * buf + g (g with the coupled
    L2 added; buf = g at the first step), then p -= lr * buf. torch's SGD
    reads a tensor lr as a Python scalar, which a CUDA-graph capture cannot
    do; here a CUDA lr is read on the device (the product lr * buf rounded
    on its own), a CPU one as torch's SGD reads it (one rounding, as the
    reference's fused update)."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MomentumSGD takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            states = [self.state[p] for p in params]
            if all("momentum_buffer" in st for st in states):
                bufs = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
            else:
                bufs = [g.detach().clone() for g in grads]
                for st, buf in zip(states, bufs):
                    st["momentum_buffer"] = buf
            lr = group["lr"]
            if lr.device.type == "cuda":
                torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
            else:
                torch._foreach_add_(params, bufs, alpha=-float(lr))


def _device_lr(optimizer: torch.optim.Optimizer) -> None:
    """Each group's lr as a float32 tensor on its parameters' device (the
    schedule fills it in place; a captured step reads it at replay), and
    Adam capturable on a card, its step counts there (a checkpoint written
    on another device loads so too)."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device if group["params"] else (
            torch.device("cpu"))
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == dev
                and lr.dtype == torch.float32):
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=dev)
        if isinstance(optimizer, torch.optim.Adam):
            group["capturable"] = dev.type == "cuda"
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                if "step" in st and group["capturable"]:
                    st["step"] = st["step"].to(dev, torch.float32)


def make_optimizer(cfg: TrainConfig, model: nn.Module,
                   out_area: Optional[int] = None
                   ) -> tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer over `model`'s parameters and its lr schedule, a
    LambdaLR stepped once after each optimizer step. Two parameter groups:
    the kernels (ndim >= 2) with `weight_decay` as coupled L2, the biases
    with none. Each group's lr is a float32 tensor on the parameters'
    device, which the schedule fills with its float64 value (one rounding);
    on a card Adam is `capturable` and momentum is `MomentumSGD`, so the
    step can be captured in a CUDA graph."""
    params = list(model.parameters())
    groups = [{"params": [p for p in params if p.ndim >= 2],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p in params if p.ndim < 2],
               "weight_decay": 0.0}]
    lr = effective_lr_init(cfg, out_area)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif cfg.optimizer == "momentum":
        opt = MomentumSGD(groups, lr=lr, momentum=cfg.momentum,
                          dampening=0.0, nesterov=False)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    # the schedule keeps float base lrs; the groups then get their tensors
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _decay(cfg))
    _device_lr(opt)
    return opt, sched


def pose_loss(outputs: dict, gt_conf: torch.Tensor, gt_paf: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, dict]:
    """Deep-supervision masked L2: total = sum over stages of
    mean_batch[sum over H, W, C of ((pred - gt) * mask)^2] for both
    branches, each stage's output cast to float32 first. mask: (B, h, w, 1)
    with 0 over unannotated regions. The metrics are the last stage's two
    terms."""
    if mask is None:
        mask = torch.ones_like(gt_conf[..., :1])
    total = 0.0
    last_conf = last_paf = None
    for conf, paf in zip(outputs["conf"], outputs["paf"]):
        l_conf = (((conf.float() - gt_conf) * mask) ** 2).sum(
            dim=(1, 2, 3)).mean()
        l_paf = (((paf.float() - gt_paf) * mask) ** 2).sum(
            dim=(1, 2, 3)).mean()
        total = total + l_conf + l_paf
        last_conf, last_paf = l_conf, l_paf
    return total, {"loss_conf_last": last_conf, "loss_paf_last": last_paf}


def _device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"training: device {dev}, but no CUDA device is available; "
            "pass device=\"cpu\" to train on the CPU")
    return dev


def _check_trainable(config: Config) -> None:
    if config.model.compute_dtype == "int8":
        raise ValueError(
            "int8 is a calibrated inference mode (Engine.calibrate); train "
            "in bfloat16/float32 — the same checkpoint then serves int8.")
    if config.model.fused_inference:
        raise ValueError(
            "fused_inference routes layers through fused_sepconv, which has "
            "no backward; train with fused_inference=False (the weights "
            "then serve either way)")


def create_train_state(config: Config, seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """A fresh model of `config.model.train_lowering()` (seeded init on the
    host, so one seed gives the same parameters on every device), its
    optimizer and schedule, on `device`, in train mode."""
    _check_trainable(config)
    dev = _device(device)
    model = get_model(config.model.train_lowering())
    common.init_params(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt, sched = make_optimizer(config.train, model,
                                config.model.hout * config.model.wout)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      device=dev)


def _apply(state: TrainState, images: torch.Tensor, gt_conf: torch.Tensor,
           gt_paf: torch.Tensor, mask: Optional[torch.Tensor],
           after_backward: Optional[Callable[[nn.Module], None]] = None,
           forward: Optional[Callable[[nn.Module, torch.Tensor], dict]]
           = None) -> dict:
    """The device work of one step: forward, loss, backward, update (what
    a captured step replays); returns the metrics on the device."""
    state.optimizer.zero_grad(set_to_none=True)
    outputs = (state.model(images) if forward is None
               else forward(state.model, images))
    loss, metrics = pose_loss(outputs, gt_conf, gt_paf, mask)
    loss.backward()
    if after_backward is not None:
        after_backward(state.model)
    state.optimizer.step()
    return dict({k: v.detach() for k, v in metrics.items()},
                loss=loss.detach())


def _lr_metric(state: TrainState) -> torch.Tensor:
    """The lr of this step, copied before the schedule refills it."""
    return state.optimizer.param_groups[0]["lr"].clone()


def _update(state: TrainState, images: torch.Tensor, gt_conf: torch.Tensor,
            gt_paf: torch.Tensor, mask: Optional[torch.Tensor],
            after_backward: Optional[Callable[[nn.Module], None]] = None,
            forward: Optional[Callable[[nn.Module, torch.Tensor], dict]]
            = None) -> tuple[TrainState, dict]:
    """One optimizer step in place, eagerly; metrics stay on the device (no
    sync), `lr` too: the schedule's value at the step before its
    increment. `forward(model, images)` replaces the model call (the
    spatial axis's band forward); `after_backward(model)` runs between the
    backward pass and the update (sync-sgd's gradient all-reduce)."""
    lr = _lr_metric(state)
    return _finish(state, _apply(state, images, gt_conf, gt_paf, mask,
                                 after_backward, forward), lr)


def _graphed(state: TrainState, kind: str,
             inputs: tuple[Optional[torch.Tensor], ...],
             body: Callable[..., dict]) -> tuple[TrainState, dict]:
    """One step of `body(state, *inputs)` (device tensors in, metrics out),
    eagerly on the CPU; on the card one CUDA-graph replay a step, keyed by
    `kind` and the inputs' shapes and dtypes. A key's first CAPTURE_WARMUP
    steps run eagerly on a side stream (each a real step on its own
    batch); the next captures `body` over static copies of its inputs
    (the capture executes nothing) and replays it; later steps copy their
    inputs in and replay. The lr metric and the schedule's step stay
    outside the graph, so a run of n steps makes n updates either way."""
    lr = _lr_metric(state)
    if state.device.type != "cuda":
        return _finish(state, body(state, *inputs), lr)
    key = (kind, *((None if t is None else (tuple(t.shape), t.dtype))
                   for t in inputs))
    entry = state.graphs.get(key, 0)
    if isinstance(entry, int) and entry < CAPTURE_WARMUP:
        state.graphs[key] = entry + 1
        metrics = on_side_stream(lambda: body(state, *inputs), state.device)
        return _finish(state, metrics, lr)
    if isinstance(entry, int):
        static = tuple(None if t is None else t.clone() for t in inputs)
        graph, out = capture_graph(lambda: body(state, *static),
                                   state.device, warmup=0)
        entry = state.graphs[key] = _Captured(graph, static, out)
    for dst, src in zip(entry.inputs, inputs):
        if dst is not None:
            dst.copy_(src)
    entry.graph.replay()
    return _finish(state, {k: v.clone() for k, v in entry.metrics.items()},
                   lr)


def _finish(state: TrainState, metrics: dict, lr: torch.Tensor
            ) -> tuple[TrainState, dict]:
    """The host's part of a step: the schedule, the count, the lr metric
    (taken before the schedule steps)."""
    state.scheduler.step()
    state.step += 1
    return state, dict(metrics, lr=lr)


def make_train_step(config: Config):
    """step(state, images, gt_conf, gt_paf, mask) -> (state, metrics):
    `images` are preprocessed float images on the state's device, the GT
    maps (B, hout, wout, 19 / 38) and the mask (B, hout, wout, 1) too. The
    state is updated in place and returned. On the card a step is one
    CUDA-graph replay (after the warm-up steps and the capture of its
    shapes; see `_graphed`)."""
    _check_trainable(config)

    def step(state: TrainState, images: torch.Tensor, gt_conf: torch.Tensor,
             gt_paf: torch.Tensor, mask: Optional[torch.Tensor] = None
             ) -> tuple[TrainState, dict]:
        return _graphed(state, "maps", (images, gt_conf, gt_paf, mask),
                        _apply)

    return step


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A host array or tensor -> `device`, copied once: from pinned host
    memory and without blocking when the target is a GPU."""
    t = torch.as_tensor(x)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


_BATCH_KEYS = ("images", "keypoints", "mask")


def _targets_fn(config: Config):
    """(images uint8, keypoints, mask) on the device -> (images, gt_conf,
    gt_paf, mask): normalised (/255 - 0.5), GT maps at the output grid."""
    m, d = config.model, config.data

    def on_device(images: torch.Tensor, keypoints: torch.Tensor,
                  mask: torch.Tensor) -> tuple:
        gt_conf, gt_paf = make_targets(keypoints, m.hout, m.wout, m.stride,
                                       d.sigma, d.limb_width)
        return preprocess_images(images), gt_conf, gt_paf, mask

    return on_device


def batch_on_device(config: Config):
    """targets(state, batch) -> (images, gt_conf, gt_paf, mask) of a
    pipeline batch {'images' uint8 (any input layout Engine takes),
    'keypoints' (B, P, 18, 3), 'mask' (B, hout, wout, 1)}: the batch is
    copied to the state's device once, normalised there (/255 - 0.5) and
    its GT maps synthesised there at the model's output grid."""
    _check_trainable(config)
    on_device = _targets_fn(config)

    def targets(state: TrainState, batch: dict) -> tuple:
        return on_device(*(_to_device(batch[k], state.device)
                           for k in _BATCH_KEYS))

    return targets


def make_train_step_on_batch(config: Config):
    """step(state, batch) -> (state, metrics) over a pipeline batch (see
    `batch_on_device`). On the card the batch is copied to the device and
    into the graph's buffers, and one CUDA-graph replay normalises it,
    synthesises its GT maps and makes the step (`_graphed`)."""
    _check_trainable(config)
    on_device = _targets_fn(config)

    def body(state: TrainState, images, keypoints, mask) -> dict:
        return _apply(state, *on_device(images, keypoints, mask))

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        return _graphed(state, "batch", tuple(
            _to_device(batch[k], state.device) for k in _BATCH_KEYS), body)

    return step


def train_loop(config: Config, n_steps: Optional[int] = None,
               resume: bool = True, log=print,
               device: str | torch.device = "cuda") -> TrainState:
    """The training loop on every rank of the world it finds (reference
    train.py :: single_train / parallel_train): the COCO dataset and the
    host pipeline, on-device GT synthesis, the KungFu strategy's steps,
    resume from the newest checkpoint, a log line every `log_every` steps
    and a metrics-CSV row, checkpoints every `checkpoint_every` and heatmap
    dumps every `vis_every`.

    With a process group running (or started from torchrun's environment
    when `config.parallel.multihost`), the ranks form a (data, spatial)
    mesh (`config.parallel.spatial_parallelism` ranks a data row). Data
    row d trains on its own shard of the dataset (`shard_index=d`, seed +
    d) in batches of batch_size / rows: the row's spatial rank 0 reads
    them and hands each to the row's other spatial ranks, which take their
    bands of its rows. A rank runs on cuda:LOCAL_RANK when `device` is
    "cuda"; every rank resumes from the newest checkpoint, and rank 0
    alone writes checkpoints, CSV rows and dumps, from its replica.
    Returns this rank's state."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.data.pipeline import TrainPipeline
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S

    dev = S.init_distributed(config.parallel, device=_device(device))
    rank = S.rank_and_world()[0]
    if dist.is_initialized():
        mesh = S.build_mesh(config.parallel)
        row, rows = S.data_axis(mesh)[:2]
        reader = S.spatial_axis(mesh)[0] == 0
        spatial = S.spatial_axis(mesh)[1] > 1
    else:
        S.check_divisible(1, config.parallel.spatial_parallelism)
        mesh, row, rows, reader, spatial = None, 0, 1, True, False
    if config.train.batch_size % rows:
        raise ValueError(
            f"batch_size {config.train.batch_size} must be divisible by the "
            f"data mesh axis ({rows} devices)")
    n_steps = n_steps or config.train.n_steps
    state = kf.create_kungfu_state(config, mesh, config.train.seed, dev)
    ckpt_dir = config.train.checkpoint_dir
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        state = ckpt.restore(ckpt_dir, state)
        log(f"resumed from step {state.step}")
    step_fns = kf.make_kungfu_steps(config, mesh, config.train.kf_optimizer)

    dataset = CocoPoseDataset(config.data.train_annotations,
                              config.data.train_images)
    # the data row's disjoint shard (the reference's dataset.shard(
    # cluster_size, rank)), in batches of its share of the global batch,
    # read once a row: the spatial ranks of a row step on one batch
    local = config.replace(train=dataclasses.replace(
        config.train, batch_size=config.train.batch_size // rows))
    pipeline = (TrainPipeline(dataset, local, seed=config.train.seed + row,
                              shard_index=row, shard_count=rows)
                if reader else None)
    csv_writer = (_metrics_csv_writer(config) if rank == 0
                  else lambda *a: None)
    it = iter(pipeline) if reader else None
    t0 = time.perf_counter()
    imgs_since = 0
    try:
        for i in range(state.step, n_steps):
            full = next(it) if reader else None
            batch = full
            if spatial:
                full = S.broadcast_batch(full, mesh, dev)
                batch = S.band_batch(full, mesh,
                                     stride=config.model.stride)
            state, metrics = step_fns[i % len(step_fns)](state, batch)
            imgs_since += batch["images"].shape[0] * rows
            if (i + 1) % config.train.log_every == 0:
                loss = float(metrics["loss"])          # synchronises
                dt = time.perf_counter() - t0
                log(f"step {i + 1} loss {loss:.2f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"{imgs_since / dt:.1f} img/s")
                csv_writer(i + 1, metrics, imgs_since / dt)
                t0 = time.perf_counter()
                imgs_since = 0
            if (i + 1) % config.train.checkpoint_every == 0 and rank == 0:
                ckpt.save(ckpt_dir, state, i + 1)
            if (config.train.vis_every
                    and (i + 1) % config.train.vis_every == 0
                    and rank == 0):
                _dump_vis(config, state, full, i + 1)
    finally:
        if pipeline is not None:
            pipeline.stop()
    if mesh is not None:
        dist.barrier()        # rank 0's last checkpoint is on disk
    return state


def _metrics_csv_writer(config: Config):
    """Row-per-log-interval CSV metrics (no-op when metrics_csv is empty).
    Columns: step, loss, loss_conf_last, loss_paf_last, lr, imgs_per_sec."""
    path = config.train.metrics_csv
    if not path:
        return lambda *a: None
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("step,loss,loss_conf_last,loss_paf_last,lr,"
                    "imgs_per_sec\n")

    def write(step, metrics, imgs_per_sec):
        # open per row: rows land every log_every steps, and a crash never
        # loses buffered rows
        with open(path, "a") as f:
            f.write(f"{step},{float(metrics['loss']):.6g},"
                    f"{float(metrics['loss_conf_last']):.6g},"
                    f"{float(metrics['loss_paf_last']):.6g},"
                    f"{float(metrics['lr']):.6g},{imgs_per_sec:.2f}\n")

    return write


def _dump_vis(config: Config, state: TrainState, batch, step: int) -> None:
    """Render predicted vs GT heatmaps of the batch's first image over the
    plain image (vis_dir/step<N>_{pred,gt}.jpg)."""
    try:
        import cv2
    except ImportError:
        return
    from openpose_plus_tpu_torch.utils.vis import draw_maps_overlay

    m, d = config.model, config.data
    images = common.to_plain(_to_device(batch["images"][:1], state.device))
    with torch.no_grad():
        out = state.model(preprocess_images(images))
        gt, _ = make_targets(_to_device(batch["keypoints"][:1], state.device),
                             m.hout, m.wout, m.stride, d.sigma, d.limb_width)
    pred = out["conf"][-1][0].float().cpu().numpy()
    img = np.ascontiguousarray(images[0].cpu().numpy()[:, :, ::-1])  # BGR
    os.makedirs(config.train.vis_dir, exist_ok=True)
    cv2.imwrite(os.path.join(config.train.vis_dir, f"step{step}_pred.jpg"),
                draw_maps_overlay(img, pred))
    cv2.imwrite(os.path.join(config.train.vis_dir, f"step{step}_gt.jpg"),
                draw_maps_overlay(img, gt[0].cpu().numpy()))


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: the JAX package's flags, plus --device (default cuda) and
    --checkpoint-every."""
    import argparse

    p = argparse.ArgumentParser(description="Train a pose model (PyTorch)")
    p.add_argument("--model", default="vgg19")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--parallel", action="store_true",
                   help="one process a rank: start the process group from "
                        "torchrun's environment")
    p.add_argument("--kf-optimizer", default="sync-sgd",
                   choices=["sync-sgd", "sma", "pair-avg"],
                   help="distributed strategy (reference --kf-optimizer; "
                        "pair-avg as hypercube gossip)")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial-parallel shards of the image height "
                        "(ranks a data row; sync-sgd)")
    p.add_argument("--train-images", default=None)
    p.add_argument("--train-annotations", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics-csv", default=None,
                   help="append per-log-interval metrics rows here")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="steps between checkpoints")
    p.add_argument("--lr-scaling", default=None,
                   choices=["none", "inv-sqrt-area"],
                   help="geometry-transfer lr rule: inv-sqrt-area scales "
                        "lr_init by sqrt(lr_ref_area/(hout*wout))")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)

    from openpose_plus_tpu_torch.config import default_config

    cfg = default_config(args.model)
    tr = dataclasses.replace(cfg.train, kf_optimizer=args.kf_optimizer)
    if args.lr_scaling:
        tr = dataclasses.replace(tr, lr_scaling=args.lr_scaling)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.checkpoint_dir:
        tr = dataclasses.replace(tr, checkpoint_dir=args.checkpoint_dir)
    if args.metrics_csv:
        tr = dataclasses.replace(tr, metrics_csv=args.metrics_csv)
    if args.checkpoint_every:
        tr = dataclasses.replace(tr, checkpoint_every=args.checkpoint_every)
    da = cfg.data
    if args.train_images:
        da = dataclasses.replace(da, train_images=args.train_images)
    if args.train_annotations:
        da = dataclasses.replace(da, train_annotations=args.train_annotations)
    pa = dataclasses.replace(cfg.parallel, multihost=args.parallel,
                             spatial_parallelism=args.spatial)
    cfg = cfg.replace(train=tr, data=da, parallel=pa)
    started = not dist.is_initialized()
    try:
        train_loop(cfg, n_steps=args.steps, device=args.device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
