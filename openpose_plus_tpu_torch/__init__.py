"""openpose_plus_tpu_torch — the PyTorch/CUDA port of openpose_plus_tpu.

Runs the served MobileNet-thin inference path on an NVIDIA GPU (uint8
frames in, `HumanBatch` out) with the decoder's serial tail in hand-written
Hopper kernels. Imports `torch`, never `jax`; reuses the JAX package's
jax-free `config` and `skeleton` modules.

    from openpose_plus_tpu_torch import Engine, default_config
    engine = Engine(default_config("mobilenet_thin"), device="cuda")
    humans = engine.infer(images_uint8)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy exports: `import openpose_plus_tpu_torch` stays cheap.
    if name == "Engine":
        from openpose_plus_tpu_torch.engine import Engine
        return Engine
    if name in ("Config", "default_config"):
        from openpose_plus_tpu import config as _c
        return getattr(_c, name)
    if name == "get_model":
        from openpose_plus_tpu_torch.models import get_model
        return get_model
    if name == "HumanBatch":
        from openpose_plus_tpu_torch.postproc import HumanBatch
        return HumanBatch
    raise AttributeError(name)


__all__ = ["Engine", "Config", "default_config", "get_model", "HumanBatch",
           "__version__"]
