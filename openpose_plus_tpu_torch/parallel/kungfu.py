"""The KungFu strategies of the reference's distributed trainer, one
process a rank on `torch.distributed`.

Port of `openpose_plus_tpu/parallel/kungfu.py`. The reference's
`--kf-optimizer` wrappers (train.py :: parallel_train):

  * sync-sgd -> SynchronousSGDOptimizer: the gradients are all-reduced as
    a mean before every update; every rank holds identical parameters.
  * sma      -> SynchronousAveragingOptimizer: each rank applies its own
    gradients, then the parameters are all-reduced as a mean.
  * pair-avg -> PairAveragingOptimizer, as the JAX package's deterministic
    hypercube gossip: in round r each rank averages its parameters with
    partner `rank XOR 2^r`, one round a step, log2(n) rounds.

Every rank holds its own replica: its model, and an optimizer state that
stays local (`create_kungfu_state` starts every rank from rank 0's
parameters, where the JAX package stacks one replica a device). Rank 0's
replica is the one `train.train_loop` checkpoints, as KungFu and
`unstack_replica` do. Metrics are all-reduced as a mean.

The collectives are explicit, each over one flattened buffer, where the
JAX package has `pmean` / `ppermute` inside `shard_map`:

  * sync-sgd: one `all_reduce` of the gradients a step (`all_reduce_mean`);
  * sma: one `all_reduce` of the parameters;
  * pair-avg: one `all_reduce` of an (n/2, P) buffer in which the two
    ranks of each pair write half their parameters (`pair_average`): the
    pair's row sums to (own + partner) * 0.5, bit for bit. It moves n/2
    times the bytes of a point-to-point exchange, and needs only the
    collective that every backend takes on CUDA tensors;
  * the metrics: one `all_reduce` of three scalars.

The update is `train._update`'s Adam or momentum step unchanged, eager:
gloo's collectives cannot be captured in a CUDA graph. A world of one (no
mesh) takes `train.make_train_step_on_batch`'s step, one CUDA-graph replay
a step on the card. On a (data, spatial) mesh, sync-sgd runs each rank on
its band of the images (`parallel.spatial`); sma and pair-avg refuse a
spatial axis, as the reference does.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from openpose_plus_tpu_torch.config import Config
from openpose_plus_tpu_torch.parallel import sharding as S
from openpose_plus_tpu_torch.parallel import spatial

STRATEGIES = ("sync-sgd", "sma", "pair-avg")


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None,
                    divisor: Optional[int] = None) -> None:
    """Each tensor replaced in place by its mean over the ranks of `group`:
    one all_reduce (sum) of the tensors flattened into one buffer, then a
    division by the world size (pmean's psum / n), or by `divisor` (a
    (data, spatial) mesh sums its bands' shares and averages over data)."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(divisor or dist.get_world_size(group))
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


def pair_index(rank: int, rnd: int) -> int:
    """The index of the pair {rank, rank XOR 2^rnd} among the n/2 pairs of
    a round: the rank with bit `rnd` taken out."""
    low = rank & ((1 << rnd) - 1)
    return ((rank >> (rnd + 1)) << rnd) | low


def pair_average(tensors: Sequence[torch.Tensor], rnd: int, group=None
                 ) -> None:
    """Each tensor replaced in place by (own + partner's) * 0.5, the
    partner being rank XOR 2^rnd of `group` (a power-of-two world): the
    ranks write half their flattened tensors into their pair's row of a
    zeroed (n/2, P) buffer, which one all_reduce sums."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    flat = _flatten_dense_tensors(tensors)
    rows = flat.new_zeros((n // 2, flat.numel()))
    row = rows[pair_index(me, rnd)]
    torch.mul(flat, 0.5, out=row)
    dist.all_reduce(rows, group=group)
    for t, r in zip(tensors, _unflatten_dense_tensors(row, tensors)):
        t.copy_(r)


def _mean_metrics(metrics: dict, group) -> dict:
    keys = [k for k in metrics if k != "lr"]
    values = torch.stack([metrics[k].float() for k in keys])
    all_reduce_mean([values], group)
    return dict(metrics, **dict(zip(keys, values.unbind())))


def create_kungfu_state(config: Config, mesh=None, seed: int = 0,
                        device: str | torch.device = "cuda"):
    """`train.create_train_state` on this rank, with the mesh's first
    rank's parameters broadcast over the mesh (KungFu's
    BroadcastGlobalVariables; the seeded init already agrees)."""
    from openpose_plus_tpu_torch.train import create_train_state

    state = create_train_state(config, seed, device)
    if mesh is not None:
        S.replicate(state.model, S.mesh_group(mesh))
    return state


def make_kungfu_steps(config: Config, mesh, strategy: str
                      ) -> list[Callable]:
    """This rank's step functions for a strategy: step(state, batch) ->
    (state, metrics), `batch` being this rank's part of the global batch
    (a pipeline batch, as `train.make_train_step_on_batch` takes;
    `sharding.shard_batch`).

    On a mesh with a spatial axis (sync-sgd only: the reference's
    decentralized strategies refuse it) the model runs on the rank's band
    of the images (`spatial.band_forward`), the loss on the full maps, and
    one all_reduce over the mesh sums the bands' gradient shares and
    averages them over the data axis.

    Returns a list; the train loop cycles `fns[step % len(fns)]`: one
    function for sync-sgd and sma, log2(n) for pair-avg (round r pairs the
    ranks along bit r). `mesh` is the `DeviceMesh` of the ranks, or None
    for a world of one without a process group (no collectives: the
    single-device step, a CUDA-graph replay on the card)."""
    from openpose_plus_tpu_torch import train as T

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown kf strategy {strategy!r}; "
                         f"choose from {STRATEGIES}")
    n, group, reduce_group, forward = 1, None, None, None
    if mesh is not None:
        _, n, group = S.data_axis(mesh)
        names = mesh.mesh_dim_names
        for dim, other in enumerate(names[1:], 1):
            if mesh.size(dim) != 1 and strategy != "sync-sgd":
                raise ValueError(
                    f"kf strategy {strategy!r} shards over {names[0]!r} "
                    f"only; mesh axis {other!r} has size {mesh.size(dim)} "
                    f"— spatial partitioning is not supported with "
                    f"decentralized strategies (use kf_optimizer="
                    f"'sync-sgd')")
    if strategy == "pair-avg" and (n & (n - 1) or n < 2):
        raise ValueError(f"pair-avg hypercube gossip needs a power-of-two "
                         f"device count, got {n}")
    if mesh is not None:
        reduce_group = S.mesh_group(mesh)
        if S.spatial_axis(mesh)[1] > 1:
            m = config.model
            forward = functools.partial(
                spatial.band_forward,
                spatial.axis_band(mesh, m.hin, m.stride))
    targets = T.batch_on_device(config)
    single = T.make_train_step_on_batch(config) if mesh is None else None

    def reduce_grads(model: torch.nn.Module) -> None:
        all_reduce_mean([p.grad for p in model.parameters()], reduce_group,
                        divisor=n)

    def step(state, batch, *, rnd: int):
        if single is not None:
            return single(state, batch)
        after_backward: Optional[Callable] = (
            reduce_grads if strategy == "sync-sgd" else None)
        state, metrics = T._update(state, *targets(state, batch),
                                   after_backward=after_backward,
                                   forward=forward)
        params = [p.detach() for p in state.model.parameters()]
        if strategy == "sma":
            all_reduce_mean(params, group)
        elif strategy == "pair-avg":
            pair_average(params, rnd, group)
        return state, _mean_metrics(metrics, group)

    n_rounds = max(1, n.bit_length() - 1) if strategy == "pair-avg" else 1
    return [functools.partial(step, rnd=r) for r in range(n_rounds)]
