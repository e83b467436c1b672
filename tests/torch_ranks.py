"""Ranks of the port's distributed layer on the CPU, for the tests: gloo
process groups in spawned processes, and the work each rank does.

`run_ranks(fn, world, *args)` starts `world` spawned processes, each with a
gloo group on a free localhost port and torch at one thread, runs
`fn(rank, world, *args)` in each and returns their results in rank order.
A rank that raises fails the call with its traceback; ranks that have not
answered by the timeout fail it too; every process is joined or killed
before the call returns. This module imports numpy, torch and the port
only: spawned ranks import it, and it keeps them free of JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import queue
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 90.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, results, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = RANK_TIMEOUT_S
              ) -> list:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(out))} of "
                    f"{world} did not answer within {timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world)]


def digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def params_np(model: torch.nn.Module) -> dict:
    return {n: p.detach().cpu().numpy().copy()
            for n, p in model.named_parameters()}


# ------------------------------------------------------ the strategies ---

def kungfu_rank(rank, world, flat_params, batches, runs):
    """For each (key, strategy, config, offset) of `runs`: a fresh kungfu
    state on the given (Flax-flat) parameters, each rank's parameters then
    moved by offset * rank, and one step a global batch of `batches` (the
    rank's slice); the parameters at the start, and per step the mean loss
    and this rank's parameters and digest. Also: the error of pair-avg on
    a mesh of ranks 0-2 (ranks outside it skip), and a 1 x 2 (data,
    spatial) mesh of ranks 0-1: its ranks, names and each rank's axes."""
    from openpose_plus_tpu_torch.checkpoint import from_flax
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S

    out = {}
    for key, strategy, cfg, offset in runs:
        mesh = S.build_mesh(cfg.parallel)
        state = kf.create_kungfu_state(cfg, mesh, device="cpu")
        state.model.load_state_dict(from_flax(flat_params))
        if offset:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(torch.tensor(offset, dtype=p.dtype) * rank)
        fns = kf.make_kungfu_steps(cfg, mesh, strategy)
        start = params_np(state.model)
        steps = []
        for i, batch in enumerate(batches):
            state, metrics = fns[i % len(fns)](state,
                                               S.shard_batch(batch, mesh))
            steps.append({"loss": float(metrics["loss"]),
                          "params": params_np(state.model),
                          "digest": digest(state.model)})
        out[key] = {"n_fns": len(fns), "start": start, "steps": steps}
    three = S.build_mesh(cfg.parallel, devices=[0, 1, 2])
    if rank < 3:
        try:
            kf.make_kungfu_steps(cfg, three, "pair-avg")
        except ValueError as e:
            out["three"] = str(e)
    two = S.build_mesh(dataclasses.replace(cfg.parallel,
                                           spatial_parallelism=2),
                       devices=[0, 1])
    if rank < 2:
        out["spatial_mesh"] = (two.mesh.tolist(), two.mesh_dim_names,
                               S.data_axis(two)[:2], S.spatial_axis(two)[:2])
    return out


# ----------------------------------------------- serving and evaluation ---

def serving_rank(rank, world, cfg, state_dict, images, bank, eval_cfg):
    """Engine(mesh=) and distributed evaluate_engine on one rank: the mesh
    engine's infer (plain, flip-TTA, scale search), forward and compiled
    infer of the global batch beside an unsharded engine on each rank's
    slice; an indivisible batch's error; the int8 calibration scales of a
    mesh engine on the global batch; evaluate_engine over the bank
    with and without distributed=True; the padded host gather of payloads
    of different shapes."""
    from openpose_plus_tpu_torch import Engine
    from openpose_plus_tpu_torch.data.coco import CocoPoseDataset
    from openpose_plus_tpu_torch.eval_coco import evaluate_engine
    from openpose_plus_tpu_torch.parallel import sharding as S
    from openpose_plus_tpu_torch.postproc import HumanBatch

    def host(hb):
        return {f.name: getattr(hb, f.name).numpy().copy()
                for f in dataclasses.fields(hb)}

    mesh = S.build_mesh(cfg.parallel)
    sharded = Engine(cfg, params=state_dict, mesh=mesh, device="cpu")
    plain = Engine(cfg, params=state_dict, device="cpu")
    per = len(images) // world
    slices = [images[r * per:(r + 1) * per] for r in range(world)]
    out = {"local": S.process_local_slice(10)}
    calls = {"infer": lambda e, x: e.infer(x),
             "flip": lambda e, x: e.infer(x, flip_tta=True),
             "dedup": lambda e, x: e.infer_multiscale(
                 x, (0.5, 1.0), combine="dedup")}
    for name, call in calls.items():
        out[name] = host(call(sharded, images))
        out[name + "_slices"] = host(HumanBatch.cat(
            [call(plain, x) for x in slices]))
    conf, paf = sharded.forward(images)
    ref = [plain.forward(x) for x in slices]
    out["forward_equal"] = (torch.equal(conf, torch.cat([c for c, _ in ref]))
                            and torch.equal(paf,
                                            torch.cat([p for _, p in ref])))
    sharded.compile(len(images))
    out["compiled_equal"] = all(
        np.array_equal(v, out["infer"][k])
        for k, v in host(sharded.infer(images)).items())
    try:
        sharded.infer(images[:per * world - 1])
    except ValueError as e:
        out["indivisible"] = str(e)
    int8 = Engine(cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="int8")), params=state_dict, mesh=mesh,
        device="cpu")
    int8.calibrate(images)
    out["int8_scales"] = [b.numpy().copy() for b in int8._calib]
    ann, imgs, _ = bank
    dataset = CocoPoseDataset(ann, imgs)
    engine = Engine(eval_cfg, params=state_dict, device="cpu")
    out["eval_single"] = evaluate_engine(engine, dataset, batch_size=4)
    out["eval_dist"] = evaluate_engine(engine, dataset, batch_size=4,
                                       distributed=True)
    out["gathered"] = gather_payloads(rank)
    return out


def gather_payloads(rank):
    """scripts/multiprocess_smoke.py's gather case: detection and
    ground-truth payloads whose row counts and widths differ by rank,
    through the padded host gather; returns the unpacked results."""
    from openpose_plus_tpu_torch import eval_coco as E

    n_local = 3 + rank * 2
    rows = np.zeros((n_local, 53), np.float32)
    rows[:, 0] = np.arange(n_local) + 100 * rank
    rows[:, 1] = 0.5
    g = 1 + rank    # different people counts -> different row widths
    gt = {1000 + rank: (np.ones((g, 17, 3), np.float32),
                        np.ones((g,), np.float32),
                        np.ones((rank, 4), np.float32))}
    return (E._unpack_detections(E._allgather_padded(rows)),
            E._unpack_gt(E._allgather_padded(E._pack_gt(gt))))


# ------------------------------------------------------------ the loop ---

def train_loop_rank(rank, world, cfg, n_steps):
    """train_loop twice to `n_steps` (the second resumes): the logs, the
    checkpoint saves this rank made, and each state's step and digest."""
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T

    saves = []
    real_save = ckpt.save
    ckpt.save = lambda *a, **k: (saves.append(a[2]), real_save(*a, **k))
    try:
        logs = []
        first = T.train_loop(cfg, n_steps=n_steps, log=logs.append,
                             device="cpu")
        second = T.train_loop(cfg, n_steps=n_steps, log=logs.append,
                              device="cpu")
    finally:
        ckpt.save = real_save
    return {"logs": logs, "saves": saves, "steps": [first.step, second.step],
            "digests": [digest(first.model), digest(second.model)]}


def scene_bank(n_images: int = 12, size: int = 128):
    """A seeded val bank of `n_images` cv2-written images in a temporary
    directory (the caller removes it): (annotations, images dir, dir)."""
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank

    tmp = tempfile.mkdtemp(prefix="torch_ranks_bank_")
    ann, imgs = make_scene_bank(os.path.join(tmp, "bank"), "val", n_images,
                                size)
    return ann, imgs, tmp


# ------------------------------------------------------ the spatial axis ---

def spatial_ops_rank(rank, world, cases):
    """Each of `cases` (name, x, weight, stride, groups, hout, g) on this
    rank's band: x a global NCHW float32 array of height hout * scale,
    `weight` a conv's (None: the 2x2 max pool), `g` the output's global
    cotangent. Returns per case the output band, the gradients of the band
    and of the weight (this rank's share), and the elements the exchanges
    brought (forward, backward)."""
    from openpose_plus_tpu_torch.models import common
    from openpose_plus_tpu_torch.parallel import spatial

    out = {}
    for name, x, weight, stride, groups, hout, g in cases:
        band = spatial.Band(rank, world, None, hout, 8)
        per = x.shape[2] // hout
        xs = torch.from_numpy(x[:, :, band.lo * per:band.hi * per]
                              ).requires_grad_()
        w = (None if weight is None
             else torch.from_numpy(weight).requires_grad_())
        spatial.reset_stats()
        with spatial.use(band):
            y = (common.maxpool2x2(xs) if w is None
                 else common.conv2d_same(xs, w, stride, groups))
        forward = spatial.STATS["halo_elements"]
        out_scale = y.shape[2] // (band.hi - band.lo)
        gs = torch.from_numpy(g[:, :, band.lo * out_scale:
                                band.hi * out_scale])
        (y * gs).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
                     "dw": None if w is None else w.grad.numpy(),
                     "elements": (forward,
                                  spatial.STATS["halo_elements"] - forward),
                     "calls": spatial.STATS["halo_calls"]}
    return out


def spatial_model_rank(rank, world, runs):
    """Each of `runs` (key, model config, state dict, images, cotangents):
    the model on this rank's band of the images on a 1 x world mesh
    (`spatial.band_forward`), every stage's gathered maps, then the
    backward of sum(maps * cotangents) and the parameter gradients summed
    over the ranks. Returns per run the final stage's full maps, the summed
    gradients and the traffic counts."""
    from openpose_plus_tpu_torch.config import ParallelConfig
    from openpose_plus_tpu_torch.models import get_model
    from openpose_plus_tpu_torch.parallel import sharding as S
    from openpose_plus_tpu_torch.parallel import spatial

    mesh = S.build_mesh(ParallelConfig(spatial_parallelism=world))
    out = {}
    for key, cfg, state_dict, images, cots in runs:
        model = get_model(cfg)
        model.load_state_dict(state_dict)
        band = spatial.axis_band(mesh, cfg.hin, cfg.stride)
        x = torch.from_numpy(images[:, band.lo * cfg.stride:
                                    band.hi * cfg.stride])
        spatial.reset_stats()
        maps = spatial.band_forward(band, model, x)
        loss = sum((m * torch.from_numpy(c)).sum() for m, c in zip(
            maps["conf"] + maps["paf"], cots))
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        flat = torch.cat([gr.reshape(-1) for gr in grads])
        dist.all_reduce(flat)
        out[key] = {"conf": maps["conf"][-1].detach().numpy(),
                    "paf": maps["paf"][-1].detach().numpy(),
                    "grads": {n: t.view_as(gr).numpy() for (n, _), gr, t in
                              zip(model.named_parameters(), grads,
                                  flat.split([gr.numel() for gr in grads]))},
                    "stats": dict(spatial.STATS)}
    return out


def spatial_train_rank(rank, world, flat_params, batches, cfg):
    """sync-sgd on the (data, spatial) mesh of `cfg.parallel` from the
    given (Flax-flat) parameters, one step a global batch (the rank's data
    slice and band of rows): per step the mean loss, this rank's
    parameters and digest; and the errors sma and pair-avg raise on the
    mesh."""
    from openpose_plus_tpu_torch.checkpoint import from_flax
    from openpose_plus_tpu_torch.parallel import kungfu as kf
    from openpose_plus_tpu_torch.parallel import sharding as S

    mesh = S.build_mesh(cfg.parallel)
    state = kf.create_kungfu_state(cfg, mesh, device="cpu")
    state.model.load_state_dict(from_flax(flat_params))
    (step,) = kf.make_kungfu_steps(cfg, mesh, "sync-sgd")
    steps = []
    for batch in batches:
        state, metrics = step(state, S.shard_batch(batch, mesh))
        steps.append({"loss": float(metrics["loss"]),
                      "params": params_np(state.model),
                      "digest": digest(state.model)})
    errors = {}
    for strategy in ("sma", "pair-avg"):
        try:
            kf.make_kungfu_steps(cfg, mesh, strategy)
        except ValueError as e:
            errors[strategy] = str(e)
    return {"steps": steps, "errors": errors,
            "axes": (S.data_axis(mesh)[:2], S.spatial_axis(mesh)[:2])}


def spatial_engine_rank(rank, world, cfg, state_dict, images):
    """Engine(mesh=) on the (data, spatial) mesh of `cfg.parallel`: its
    infer and forward of the global batch, and beside them an unsharded
    engine's on each data row's slice (in this process: the CPU's conv
    results depend on its thread count)."""
    from openpose_plus_tpu_torch import Engine
    from openpose_plus_tpu_torch.parallel import sharding as S
    from openpose_plus_tpu_torch.postproc import HumanBatch

    def host(hb):
        return {f.name: getattr(hb, f.name).numpy().copy()
                for f in dataclasses.fields(hb)}

    mesh = S.build_mesh(cfg.parallel)
    engine = Engine(cfg, params=state_dict, mesh=mesh, device="cpu")
    plain = Engine(cfg, params=state_dict, device="cpu")
    rows = S.data_axis(mesh)[1]
    per = len(images) // rows
    slices = [images[d * per:(d + 1) * per] for d in range(rows)]
    maps = [plain.forward(x) for x in slices]
    return {"humans": host(engine.infer(images)),
            "maps": [t.numpy().copy() for t in engine.forward(images)],
            "slices": host(HumanBatch.cat([plain.infer(x) for x in slices])),
            "slice_maps": [torch.cat(t).numpy() for t in zip(*maps)]}


def spatial_loop_rank(rank, world, cfg, n_steps):
    """train_loop on this rank, recording every batch its step function
    was handed (after the row's batch broadcast and the band cut);
    returns them with the state's step and digest."""
    from openpose_plus_tpu_torch import train as T
    from openpose_plus_tpu_torch.parallel import kungfu as kf

    seen = []
    real = kf.make_kungfu_steps

    def recording(*args, **kw):
        def wrap(fn):
            def step(state, batch):
                seen.append({k: np.asarray(v).copy()
                             for k, v in batch.items()})
                return fn(state, batch)
            return step
        return [wrap(fn) for fn in real(*args, **kw)]

    kf.make_kungfu_steps = recording
    try:
        state = T.train_loop(cfg, n_steps=n_steps, log=lambda _: None,
                             device="cpu")
    finally:
        kf.make_kungfu_steps = real
    return {"batches": seen, "step": state.step,
            "digest": digest(state.model)}


def spatial_world_rank(rank, world, parts):
    """Each (key, function name, arguments) of `parts` on this rank, in
    order: one spawn runs every spatial case of a world size."""
    return {key: globals()[name](rank, world, *args)
            for key, name, args in parts}
