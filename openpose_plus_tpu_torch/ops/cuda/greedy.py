"""Greedy per-limb candidate assignment: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `openpose_plus_tpu/ops/pallas/greedy.py ::
greedy_assign_pallas`; kernel source `openpose_plus_tpu_torch/csrc/greedy.cu`.
On the H100 the work is bounded by the serial chain of the K rounds, not by
bytes: the plain version is K rounds of ~10 small tensor ops each, the
kernel one launch that keeps every round in registers (one warp per image
and limb, four to a 128-thread block; each round a `redux.sync` max of
order-preserving integer keys and a `redux.sync` min of the index; the
loop ends at the first round that finds nothing).

`greedy_assign` calls the op `openpose_plus_tpu_torch::greedy_assign`
(torch.library), which dispatches on the device of its input: a CPU tensor
takes `greedy_assign_plain`, a CUDA tensor launches the kernel or raises.
Each launch adds one to the module-level `launches` count. As an op it
traces into torch.export graphs and CUDA-graph captures as one node.
"""

from __future__ import annotations

import torch

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.ops import NAMESPACE, check_device

MAX_K = 32

launches = 0   # kernel launches in this process (see module docstring)


def greedy_assign_plain(scores: torch.Tensor, max_peaks: int
                        ) -> tuple[torch.Tensor, ...]:
    """scores (B, L, K, K) float32 -> slot_a, slot_b (B, L, K) int32,
    score (B, L, K) float32, valid (B, L, K) bool.

    Round t takes the max of the remaining candidates, ties to the lowest
    row-major (slot_a, slot_b) index (masked min-index, never an argmax
    with an unspecified tie order), then masks that row and column."""
    b, n_limbs, k, _ = scores.shape
    if k != max_peaks:
        raise ValueError(f"scores K={k} != max_peaks={max_peaks}")
    kk = k * k
    rem = scores.reshape(b, n_limbs, kk).clone()
    col = torch.arange(kk, device=scores.device)
    col_a, col_b = col // k, col % k
    big = torch.full_like(col, kk)
    out_a, out_b, out_s, out_v = [], [], [], []
    for _ in range(k):
        best = rem.amax(dim=-1, keepdim=True)                  # (B, L, 1)
        ok = best > -torch.inf
        j = torch.where(rem == best, col, big).amin(dim=-1, keepdim=True)
        ja, jb = j // k, j % k
        hit = ok & ((col_a == ja) | (col_b == jb))
        rem = rem.masked_fill(hit, -torch.inf)
        zero = torch.zeros_like(ja)
        out_a.append(torch.where(ok, ja, zero))
        out_b.append(torch.where(ok, jb, zero))
        out_s.append(torch.where(ok, best, torch.zeros_like(best)))
        out_v.append(ok)
    return (torch.cat(out_a, -1).to(torch.int32),
            torch.cat(out_b, -1).to(torch.int32),
            torch.cat(out_s, -1), torch.cat(out_v, -1))


@torch.library.custom_op(
    f"{NAMESPACE}::greedy_assign", mutates_args=(), device_types="cpu",
    schema="(Tensor scores, int max_peaks) -> (Tensor, Tensor, Tensor, "
           "Tensor)")
def _greedy_assign_op(scores: torch.Tensor, max_peaks: int
                      ) -> tuple[torch.Tensor, ...]:
    return greedy_assign_plain(scores, max_peaks)


@_greedy_assign_op.register_fake
def _(scores, max_peaks):
    b, n_limbs, k = scores.shape[:3]
    slot = scores.new_empty((b, n_limbs, k), dtype=torch.int32)
    return (slot, torch.empty_like(slot), scores.new_empty((b, n_limbs, k)),
            scores.new_empty((b, n_limbs, k), dtype=torch.bool))


@_greedy_assign_op.register_kernel("cuda")
def _greedy_assign_cuda(scores: torch.Tensor, max_peaks: int
                        ) -> tuple[torch.Tensor, ...]:
    b, n_limbs, k, k2 = scores.shape
    skeletons.find(n_limbs=n_limbs)
    if k2 != k or k != max_peaks:
        raise ValueError(f"greedy_assign: scores {tuple(scores.shape)} is "
                         f"not (B, L, {max_peaks}, {max_peaks})")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"greedy_assign kernel takes K <= {MAX_K}, got {k}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("greedy_assign: scores must be contiguous float32")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    dev = scores.device
    slot_a = torch.empty((b, n_limbs, k), dtype=torch.int32, device=dev)
    slot_b = torch.empty_like(slot_a)
    score = torch.empty((b, n_limbs, k), dtype=torch.float32, device=dev)
    valid = torch.empty((b, n_limbs, k), dtype=torch.bool, device=dev)
    if b == 0:
        return slot_a, slot_b, score, valid
    lib = build.load()
    err = lib.greedy_assign_launch(
        scores.data_ptr(), b, n_limbs, k, slot_a.data_ptr(), slot_b.data_ptr(),
        score.data_ptr(), valid.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "greedy_assign_launch")
    launches += 1
    return slot_a, slot_b, score, valid


def greedy_assign(scores: torch.Tensor, max_peaks: int
                  ) -> tuple[torch.Tensor, ...]:
    """Dispatching wrapper (the op); same contract as
    `greedy_assign_plain`."""
    check_device("greedy_assign", scores)
    return _greedy_assign_op(scores, max_peaks)
