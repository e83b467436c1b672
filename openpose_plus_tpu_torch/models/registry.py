"""Model registry: string name -> torch module
(`openpose_plus_tpu/models/registry.py`, the same names and aliases, and
the port's own `body25`, OpenPose's BODY_25)."""

from __future__ import annotations

from torch import nn

from openpose_plus_tpu_torch.config import ModelConfig
from openpose_plus_tpu_torch.models.body25 import Body25Pose
from openpose_plus_tpu_torch.models.hao28 import Hao28Pose
from openpose_plus_tpu_torch.models.mobilenet_thin import MobileNetThinPose
from openpose_plus_tpu_torch.models.vgg19 import VGG19Pose
from openpose_plus_tpu_torch.models.vggtiny import VGGTinyPose

_REGISTRY = {
    "vgg19": VGG19Pose,
    "vgg": VGG19Pose,            # reference alias --model=vgg
    "vggtiny": VGGTinyPose,
    "mobilenet_thin": MobileNetThinPose,
    "mobilenet": MobileNetThinPose,
    "hao28_experimental": Hao28Pose,
    "hao28": Hao28Pose,
    "body25": Body25Pose,        # the port's own: no JAX counterpart
}


def get_model(cfg: ModelConfig) -> nn.Module:
    """Build the model named by cfg.name (float32 params, random values:
    see `common.init_params`)."""
    try:
        cls = _REGISTRY[cfg.name]
    except KeyError:
        raise ValueError(
            f"unknown model {cfg.name!r}; have {sorted(set(_REGISTRY))}"
        ) from None
    return cls(cfg)


def model_names() -> list[str]:
    return sorted(set(_REGISTRY))
