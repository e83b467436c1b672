from openpose_plus_tpu_torch.models.registry import get_model, model_names

__all__ = ["get_model", "model_names"]
