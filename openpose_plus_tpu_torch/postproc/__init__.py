"""Post-processing: heatmap peaks -> PAF scoring -> skeletons, in PyTorch.

Port of `openpose_plus_tpu.postproc` with the batch dimension written out.
The serial tail (greedy assignment, subset merge) runs as hand-written CUDA
kernels on a GPU and as their plain PyTorch versions on the CPU.
"""

from openpose_plus_tpu_torch.postproc.decode import (
    HumanBatch, decode_maps, merge_dedup)

__all__ = ["HumanBatch", "decode_maps", "merge_dedup"]
