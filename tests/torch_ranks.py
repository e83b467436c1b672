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
    a mesh of ranks 0-2 (ranks outside it skip)."""
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
