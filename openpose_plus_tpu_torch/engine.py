"""Inference engine: preprocess -> CNN forward -> grouping, on one device.

Port of `openpose_plus_tpu/engine.py` (the served `Engine.infer` path). The
whole pipeline runs on the engine's device — uint8 frames in, `HumanBatch`
out — with the decoder's serial tail in the hand-written CUDA kernels on a
GPU. Nothing is compiled ahead of time: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from openpose_plus_tpu.config import Config, PostprocConfig, default_config
from openpose_plus_tpu_torch.checkpoint import from_flax
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.postproc import HumanBatch, decode_maps


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> float32 in [-0.5, 0.5] (/255 - 0.5)."""
    return images.to(torch.float32) / 255.0 - 0.5


def _forward(model: torch.nn.Module, images: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    out = model(preprocess_images(images))
    return out["conf"][-1], out["paf"][-1]


def infer_step(model: torch.nn.Module, images: torch.Tensor,
               postproc_cfg: PostprocConfig, chunk: int = 0) -> HumanBatch:
    """The full engine step (preprocess -> CNN -> decode). With chunk > 0
    and a batch that is a larger multiple of it, the batch runs as a loop
    over chunk-sized sub-batches."""
    b = images.shape[0]
    if chunk and b > chunk and b % chunk == 0:
        return HumanBatch.cat([
            infer_step(model, images[i:i + chunk], postproc_cfg)
            for i in range(0, b, chunk)])
    return decode_maps(*_forward(model, images), postproc_cfg)


class Engine:
    """End-to-end pose estimator on one torch device.

    config: full Config (model + postproc sections are used).
    params: the port's state_dict, or a flat Flax dict
        ('params/conv1/kernel' -> array, as `checkpoint.load_npz` returns)
        which goes through the weight bridge; random init from `seed`
        otherwise.
    device: where the model, the decoder and the results live.
    chunk: serve batches larger than `chunk` as a loop of sub-batches.
    """

    def __init__(self, config: Optional[Config] = None,
                 params: Optional[Mapping] = None, seed: int = 0,
                 device: str | torch.device = "cpu", chunk: int = 0,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving is ROADMAP.md item 'Distributed'")
        self.config = config or default_config()
        self.device = torch.device(device)
        self.chunk = chunk
        self.model = get_model(self.config.model)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            common.init_params(self.model, gen)
        else:
            if any("/" in key for key in params):
                params = from_flax(params)
            self.model.load_state_dict(params, strict=True)
        self.model.to(self.device).eval()

    def _images(self, images) -> torch.Tensor:
        images = torch.as_tensor(images, device=self.device)
        m = self.config.model
        if images.dim() == 4 and images.shape[-1] in (12, 48):
            raise NotImplementedError(
                "space-to-depth input layouts are ROADMAP.md item 'Engine "
                "main path'; feed plain (B, hin, win, 3) uint8 images")
        if images.dim() != 4 or tuple(images.shape[1:]) != (m.hin, m.win, 3):
            raise ValueError(f"expected (B, {m.hin}, {m.win}, 3) images, "
                             f"got {tuple(images.shape)}")
        if images.dtype != torch.uint8:
            raise ValueError(f"expected uint8 images, got {images.dtype}")
        return images

    @torch.inference_mode()
    def infer(self, images: np.ndarray | torch.Tensor,
              flip_tta: bool = False) -> HumanBatch:
        """images: (B, hin, win, 3) uint8 RGB -> skeletons (on `device`)."""
        if flip_tta:
            raise NotImplementedError(
                "flip_tta is ROADMAP.md item 'Flip-TTA and the quality "
                "decoder'")
        return infer_step(self.model, self._images(images),
                          self.config.postproc, self.chunk)

    @torch.inference_mode()
    def forward(self, images: np.ndarray | torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """images -> (conf, paf) final-stage maps, NHWC float32."""
        return _forward(self.model, self._images(images))

    def infer_multiscale(self, *args, **kwargs) -> HumanBatch:
        raise NotImplementedError(
            "infer_multiscale is ROADMAP.md item 'Flip-TTA and the quality "
            "decoder'")

    def calibrate(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "int8 calibration is ROADMAP.md item 'Calibrated int8'")
