"""Human assembly: the sequential subset merge of accepted connections.

Port of `openpose_plus_tpu/postproc/group.py`; the merge itself is the CUDA
kernel behind the dispatching wrapper in `ops/cuda/merge.py` (plain PyTorch
on CPU tensors). Semantics are bit-for-bit those of the reference's
`group.assemble`.
"""

from __future__ import annotations

import dataclasses

import torch

from openpose_plus_tpu_torch.ops.cuda import merge
from openpose_plus_tpu_torch.postproc.paf import Connections


@dataclasses.dataclass
class Subsets:
    """Raw human tables (before filtering/compaction), batched."""

    parts: torch.Tensor  # (B, M, P) int32 global peak id, -1 empty
    score: torch.Tensor  # (B, M) float32 running score (peaks + connections)
    count: torch.Tensor  # (B, M) int32 number of assigned parts (0 = empty)


def assemble(conns: Connections, peak_score: torch.Tensor, max_peaks: int,
             max_humans: int) -> Subsets:
    """Merge accepted connections into subsets; peak_score (B, P, K), P
    the parts of the skeleton whose limbs the connections follow."""
    parts, score, count = merge.assemble(
        conns.slot_a, conns.slot_b, conns.score, conns.valid,
        peak_score.contiguous(), max_peaks, max_humans)
    return Subsets(parts=parts, score=score, count=count)
