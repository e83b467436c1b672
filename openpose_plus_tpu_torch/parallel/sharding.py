"""Process groups, the device mesh, and what each rank holds of a batch or
a dataset.

Port of `openpose_plus_tpu/parallel/sharding.py` to `torch.distributed`,
one process a rank (started by `torchrun` or `torch.multiprocessing`) where
the JAX package runs one controller over a mesh of devices:

  * `init_multihost` -> `init_distributed`: the default process group from
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), NCCL for CUDA devices and gloo on the CPU unless the
    caller names the backend; a failed init raises;
  * `build_mesh`: a `DeviceMesh` with the dims (data, spatial). The spatial
    axis (GSPMD height sharding with halo exchange in the JAX package) is
    not ported: `spatial_parallelism > 1` raises `NotImplementedError`;
  * `replicated` / `shard_params` -> `replicate`: rank 0's parameters and
    buffers broadcast to every rank (KungFu's BroadcastGlobalVariables);
  * `batch_sharding` / `map_sharding` -> `shard_batch`, this rank's
    contiguous slice of a global host batch (a rank holds no view of the
    other ranks' rows);
  * `process_local_slice`: the same arithmetic on the rank and world size.

The collectives on device tensors are `broadcast` (`replicate`,
`all_gather_rows`) and `all_reduce` (`parallel.kungfu`): the two that
torch's gloo backend takes on CUDA tensors as well as NCCL. Gathers of
host data run on a gloo group (`host_group`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from openpose_plus_tpu_torch.config import ParallelConfig


def check_spatial(cfg: ParallelConfig) -> None:
    """Only the data axis is ported: a spatial axis raises."""
    if cfg.spatial_parallelism > 1:
        raise NotImplementedError(
            f"spatial_parallelism={cfg.spatial_parallelism}: sharding the "
            "image height across ranks needs a halo-exchanged conv, "
            "ROADMAP.md item 'Distributed' (the spatial axis); the port "
            "shards the batch only")


def init_distributed(cfg: ParallelConfig, backend: Optional[str] = None,
                     device: str | torch.device = "cuda") -> torch.device:
    """This rank's device, after starting the default process group from
    torchrun's environment when `cfg.multihost` asks for one and none is
    running (a no-op otherwise, as `init_multihost` on one host).

    device "cuda" without an index becomes cuda:LOCAL_RANK, made the
    current device. backend: "nccl" for a CUDA device and "gloo" on the
    CPU unless given; gloo on CUDA devices is allowed (it takes broadcast
    and all_reduce on CUDA tensors). A running group of another backend
    than the one asked for raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev}, but no CUDA device is available; pass "
                "device=\"cpu\" to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} process group is "
                             f"running; {backend} was asked for")
        return dev
    if cfg.multihost:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", **kw)
    return dev


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def build_mesh(cfg: Optional[ParallelConfig] = None,
               devices: Optional[Sequence[int]] = None):
    """(data, spatial) `DeviceMesh` over the given ranks (every rank of the
    default group by default). Its device type follows the backend: "cuda"
    under NCCL, "cpu" under gloo (whose groups take CUDA tensors too); the
    port uses a mesh for its groups and coordinates only."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = cfg or ParallelConfig()
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("build_mesh: no process group is running; "
                               "call init_distributed first")
        devices = range(dist.get_world_size())
    ranks = list(devices)
    n, sp = len(ranks), cfg.spatial_parallelism
    if n % sp != 0:
        raise ValueError(f"{n} devices not divisible by spatial={sp}")
    check_spatial(cfg)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n // sp, sp),
                      mesh_dim_names=(cfg.data_axis, cfg.spatial_axis))


def data_axis(mesh) -> tuple[int, int, Any]:
    """(this rank's index on the mesh's data axis, the axis size, its
    process group)."""
    return mesh.get_local_rank(0), mesh.size(0), mesh.get_group(0)


def replicate(module: nn.Module, group=None) -> nn.Module:
    """Broadcast the first rank's parameters and buffers (of `group`, the
    default group if None) into every rank's module, in place."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src, group=group)
    return module


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's contiguous rows [r*B/n, (r+1)*B/n) of every leaf of a
    global batch along the data axis; rank-0 leaves (step counters,
    scalars) are kept whole. B must be divisible by n."""
    r, n, _ = data_axis(mesh)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = v
            continue
        b = v.shape[0]
        if b % n:
            raise ValueError(f"batch leaf {k!r} has {b} rows, not divisible "
                             f"by the data axis ({n} ranks)")
        out[k] = v[r * b // n:(r + 1) * b // n]
    return out


def process_local_slice(global_count: int) -> tuple[int, int]:
    """[start, stop) of this rank's shard of a globally-indexed dataset
    (reference: dataset.shard(cluster_size, rank)); (0, count) without a
    process group."""
    r, n = rank_and_world()
    per = (global_count + n - 1) // n
    lo = min(r * per, global_count)   # clamp: trailing ranks may be empty
    return lo, min(global_count, lo + per)


def all_gather_rows(tensors: Sequence[torch.Tensor], group=None
                    ) -> list[torch.Tensor]:
    """Each tensor's rows of every rank of `group`, concatenated in rank
    order along dim 0. Every rank passes tensors of the same shapes and
    dtypes. The tensors go as one byte buffer a rank, broadcast from each
    rank in turn: bit-exact for any dtype, on any backend."""
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    raw = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    mine = torch.cat(raw)
    buffers = []
    for r in range(world):
        buf = mine if r == me else torch.empty_like(mine)
        src = r if group is None else dist.get_global_rank(group, r)
        dist.broadcast(buf, src, group=group)
        buffers.append(buf)
    out, offset = [], 0
    for t, b in zip(tensors, raw):
        rows = [buf[offset:offset + b.numel()].clone().view(t.dtype)
                .view(t.shape) for buf in buffers]
        out.append(torch.cat(rows))
        offset += b.numel()
    return out


@contextlib.contextmanager
def host_group():
    """A gloo group over every rank for gathers of host (CPU) tensors: the
    default group when it is gloo, else a new one, destroyed on exit."""
    if dist.get_backend() == "gloo":
        yield None
        return
    group = dist.new_group(backend="gloo")
    try:
        yield group
    finally:
        dist.destroy_process_group(group)
