"""Post-processing: heatmap peaks -> PAF scoring -> skeletons, in PyTorch.

Port of `openpose_plus_tpu.postproc` with the batch dimension written out.
The serial tail (greedy assignment, subset merge) runs as hand-written CUDA
kernels on a GPU and as their plain PyTorch versions on the CPU.
"""

from openpose_plus_tpu_torch.postproc.decode import (
    HumanBatch, build_decoder, decode_maps, merge_dedup)

__all__ = ["HumanBatch", "build_decoder", "decode_maps", "merge_dedup"]
