"""Model registry: string name -> torch module (the ported subset of
`openpose_plus_tpu/models/registry.py`)."""

from __future__ import annotations

from torch import nn

from openpose_plus_tpu_torch.config import ModelConfig
from openpose_plus_tpu_torch.models.mobilenet_thin import MobileNetThinPose

_REGISTRY = {
    "mobilenet_thin": MobileNetThinPose,
    "mobilenet": MobileNetThinPose,
}


def get_model(cfg: ModelConfig) -> nn.Module:
    """Build the model named by cfg.name (float32 params, random values:
    see `common.init_params`)."""
    if cfg.name not in _REGISTRY:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (ROADMAP.md item 'Rest of "
            f"the zoo'); ported: {sorted(_REGISTRY)}")
    return _REGISTRY[cfg.name](cfg)
