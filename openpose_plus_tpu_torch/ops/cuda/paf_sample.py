"""Nearest-neighbour PAF sampling: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `openpose_plus_tpu/ops/pallas/paf_sample.py ::
sample_paf_pallas` (body `_sample_kernel`); kernel source
`openpose_plus_tpu_torch/csrc/paf_sample.cu`. Both PAF channels of every
limb are sampled at integer (y, x) points, bit-identical to a gather; the
port batches the TPU kernel's single image as (B, ...). On the H100 the
kernel is bound by latency and scattered reads: one thread per sample.

`sample_paf` calls the op `openpose_plus_tpu_torch::sample_paf`
(torch.library), which dispatches on the device of `paf`: a CPU tensor
takes `sample_paf_plain`, a CUDA tensor launches the kernel or raises. Each
launch adds one to the module-level `launches` count.
"""

from __future__ import annotations

import torch

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.ops import NAMESPACE, check_device, device_cache

launches = 0   # kernel launches in this process (see module docstring)


@device_cache
def limb_channels(device: torch.device, skeleton: skeletons.Skeleton
                  ) -> torch.Tensor:
    """(L, 2) int64 PAF channels (x, y) of each of the skeleton's limbs,
    one cached copy per device (the kernel's table)."""
    return torch.as_tensor(skeleton.paf_channels_array(),
                           device=device).long()


def sample_paf_plain(paf: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     chans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """paf (B, H, W, C) float32, sy/sx (B, L, ...) int32 in-bounds coords,
    chans (L, 2) int64 -> px, py shaped like sy: the limb's two PAF
    channels at each point (an exact gather)."""
    b, h, w, c = paf.shape
    flat = paf.reshape(b, h * w, c)
    idx = (sy.long() * w + sx.long()).reshape(b, sy.shape[1], -1)  # (B,L,N)
    px = flat[:, :, chans[:, 0]].transpose(1, 2).gather(2, idx)
    py = flat[:, :, chans[:, 1]].transpose(1, 2).gather(2, idx)
    return px.reshape(sy.shape), py.reshape(sy.shape)


@torch.library.custom_op(
    f"{NAMESPACE}::sample_paf", mutates_args=(), device_types="cpu",
    schema="(Tensor paf, Tensor sy, Tensor sx, Tensor chans) -> (Tensor, "
           "Tensor)")
def _sample_paf_op(paf: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   chans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return sample_paf_plain(paf, sy, sx, chans)


@_sample_paf_op.register_fake
def _(paf, sy, sx, chans):
    px = sy.new_empty(sy.shape, dtype=paf.dtype)
    return px, torch.empty_like(px)


@_sample_paf_op.register_kernel("cuda")
def _sample_paf_cuda(paf: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     chans: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    if any(t.device != paf.device for t in (sy, sx, chans)):
        raise ValueError("sample_paf: all tensors must be on one device")
    if paf.dim() != 4 or sy.dim() < 2 or sy.shape != sx.shape or (
            sy.shape[0] != paf.shape[0]) or tuple(chans.shape) != (
            sy.shape[1], 2):
        raise ValueError(
            f"sample_paf: paf {tuple(paf.shape)}, sy {tuple(sy.shape)}, sx "
            f"{tuple(sx.shape)}, chans {tuple(chans.shape)} are not (B, H, W, "
            "C), (B, L, ...) twice, (L, 2)")
    if (paf.dtype, sy.dtype, sx.dtype, chans.dtype) != (
            torch.float32, torch.int32, torch.int32, torch.int64):
        raise ValueError("sample_paf kernel takes float32 paf, int32 sy/sx "
                         "and int64 chans")
    if not all(t.is_contiguous() for t in (paf, sy, sx, chans)):
        raise ValueError("sample_paf: inputs must be contiguous")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    px = torch.empty(sy.shape, dtype=torch.float32, device=paf.device)
    py = torch.empty_like(px)
    if px.numel() == 0:
        return px, py
    b, h, w, c = paf.shape
    n_limbs = sy.shape[1]
    lib = build.load()
    err = lib.sample_paf_launch(
        paf.data_ptr(), sy.data_ptr(), sx.data_ptr(), chans.data_ptr(),
        px.data_ptr(), py.data_ptr(), b, h, w, c, n_limbs,
        px.numel() // (b * n_limbs), paf.device.index,
        torch.cuda.current_stream(paf.device).cuda_stream)
    build.check(lib, err, "sample_paf_launch")
    launches += 1
    return px, py


def sample_paf(paf: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
               chans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper (the op); same contract as `sample_paf_plain`.
    On the card every input must be contiguous."""
    check_device("sample_paf", paf)
    return _sample_paf_op(paf, sy, sx, chans)
