"""Process groups, the device mesh, and what each rank holds of a batch or
a dataset.

Port of `openpose_plus_tpu/parallel/sharding.py` to `torch.distributed`,
one process a rank (started by `torchrun` or `torch.multiprocessing`) where
the JAX package runs one controller over a mesh of devices:

  * `init_multihost` -> `init_distributed`: the default process group from
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), NCCL for CUDA devices and gloo on the CPU unless the
    caller names the backend; a failed init raises;
  * `build_mesh`: a `DeviceMesh` with the dims (data, spatial); the
    spatial axis shards the image height (`parallel/spatial.py`, where the
    JAX package has GSPMD's halo exchange);
  * `replicated` / `shard_params` -> `replicate`: rank 0's parameters and
    buffers broadcast to every rank (KungFu's BroadcastGlobalVariables);
  * `batch_sharding` / `map_sharding` -> `shard_batch`, this rank's
    contiguous slice of a global host batch along the data axis, and of
    the images its band of rows along the spatial axis (`band_batch`; a
    rank holds no view of the other ranks' rows); `broadcast_batch` hands
    the batch one rank of a data row read to the row's other spatial
    ranks;
  * `process_local_slice`: the same arithmetic on the rank and world size.

The collectives on device tensors are `broadcast` (`replicate`,
`all_gather_rows`, `broadcast_batch`), `all_reduce` (`parallel.kungfu`)
and, on the spatial axis, `all_to_all_single` and
`all_gather_into_tensor` (`parallel.spatial`): torch's gloo backend takes
each of them on CUDA tensors as well as NCCL. Gathers of host data run on
a gloo group (`host_group`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from openpose_plus_tpu_torch.config import ParallelConfig


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


def check_divisible(n: int, spatial: int) -> None:
    """The reference's check of a mesh of `n` devices."""
    if n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")


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
    check_divisible(n, sp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n // sp, sp),
                      mesh_dim_names=(cfg.data_axis, cfg.spatial_axis))


def data_axis(mesh) -> tuple[int, int, Any]:
    """(this rank's index on the mesh's data axis, the axis size, its
    process group)."""
    return mesh.get_local_rank(0), mesh.size(0), mesh.get_group(0)


def spatial_axis(mesh) -> tuple[int, int, Any]:
    """(this rank's index on the mesh's spatial axis, the axis size, its
    process group); (0, 1, None) for a mesh of the data axis alone."""
    if mesh.ndim < 2:
        return 0, 1, None
    return mesh.get_local_rank(1), mesh.size(1), mesh.get_group(1)


def mesh_group(mesh):
    """A process group over every rank of the mesh: the data axis's group
    when the spatial axis has size 1, else the default group, which a mesh
    with a spatial axis must span."""
    if spatial_axis(mesh)[1] == 1:
        return data_axis(mesh)[2]
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh with a spatial axis spans every rank of "
                         f"the process group: {mesh.size()} of "
                         f"{dist.get_world_size()}")
    return None


def replicate(module: nn.Module, group=None) -> nn.Module:
    """Broadcast the first rank's parameters and buffers (of `group`, the
    default group if None) into every rank's module, in place."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src, group=group)
    return module


def shard_batch(batch: dict, mesh, spatial_leaves: tuple[str, ...] = (
        "images",), stride: int = 8) -> dict:
    """This rank's part of a global batch: the contiguous rows
    [r*B/n, (r+1)*B/n) of every leaf along the data axis (rank-0 leaves,
    step counters and scalars, are kept whole; B must be divisible by n),
    then of the 4-D leaves named in `spatial_leaves` (NHWC images) this
    rank's band of rows along the spatial axis (`band_batch`). The maps,
    mask and keypoints are sliced over data only (`map_sharding`)."""
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
    return band_batch(out, mesh, spatial_leaves, stride)


def band_batch(batch: dict, mesh, spatial_leaves: tuple[str, ...] = (
        "images",), stride: int = 8) -> dict:
    """The 4-D leaves of `batch` named in `spatial_leaves` cut to this
    rank's band of rows (dim 1) on the mesh's spatial axis, the bands of
    `parallel.spatial` for an output grid `stride` times smaller than a
    plain image (an s2d layout's rows are taken at its own scale); every
    other leaf as it is."""
    from openpose_plus_tpu_torch.parallel import spatial

    s, n, _ = spatial_axis(mesh)
    if n == 1:
        return batch
    out = dict(batch)
    for k in spatial_leaves:
        v = batch.get(k)
        if getattr(v, "ndim", 0) != 4:
            continue
        per = stride // {3: 1, 12: 2, 48: 4}.get(v.shape[-1], 1)
        lo, hi = spatial.bands(spatial.check_geometry(v.shape[1], per, n),
                               n)[s]
        out[k] = v[:, lo * per:hi * per]
    return out


def broadcast_batch(batch: Optional[dict], mesh,
                    device: torch.device) -> dict:
    """The batch of a data row on every spatial rank of the row: spatial
    rank 0 passes the dict of arrays it read, the others None; every rank
    returns the leaves on `device` (two broadcasts on the spatial axis:
    the leaves' names, shapes and dtypes, then their bytes)."""
    s, _, group = spatial_axis(mesh)
    src = dist.get_global_rank(group, 0)

    def nbytes(shape, dtype) -> int:     # each leaf on a 16-byte boundary
        return -(-torch.Size(shape).numel() * dtype.itemsize // 16) * 16

    if s == 0:
        leaves = {k: torch.as_tensor(v) for k, v in batch.items()}
        meta = [[(k, tuple(t.shape), t.dtype) for k, t in leaves.items()]]
    else:
        meta = [None]
    dist.broadcast_object_list(meta, src, group=group, device=device)
    buf = torch.zeros(sum(nbytes(*m[1:]) for m in meta[0]),
                      dtype=torch.uint8, device=device)
    out, offset = {}, 0
    for k, shape, dtype in meta[0]:
        out[k] = buf[offset:offset + nbytes(shape, dtype)].view(dtype)[
            :torch.Size(shape).numel()].view(shape)
        if s == 0:
            out[k].copy_(leaves[k])
        offset += nbytes(shape, dtype)
    dist.broadcast(buf, src, group=group)
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
