from openpose_plus_tpu_torch.models.registry import get_model

__all__ = ["get_model"]
