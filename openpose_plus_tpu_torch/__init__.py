"""openpose_plus_tpu_torch — the PyTorch/CUDA port of openpose_plus_tpu.

Runs inference for the model zoo (MobileNet-thin, VGG19, VGG-tiny, hao28)
on an NVIDIA GPU (uint8 frames in, plain or space-to-depth layouts,
`HumanBatch` out), with flip-TTA, scale search and the `quality()` decoder,
and the decoder's serial tail in hand-written Hopper kernels; calibrated
int8 serving (`compute_dtype="int8"`, `Engine.calibrate`) with the int8
convs in a hand-written int8 tensor-core kernel; COCO
keypoint evaluation (`eval_coco`, the GT-map oracle in `ap_oracle`); and
training (`train`: loss, Adam or momentum, the host pipeline in
`data.pipeline`, `train_loop` with resume, on one device or on a (data,
spatial) mesh of ranks in `parallel`; `ap_bench` trains on the seeded
scene bank and measures AP).
Imports `torch`, never `jax`, and nothing of the JAX package: `config`,
`skeleton` and `data` are the port's own copies, pinned equal to the
originals by the tests. `Engine` runs on the card unless it is given
`device="cpu"`.

    from openpose_plus_tpu_torch import Engine, default_config
    engine = Engine(default_config("mobilenet_thin"), device="cuda")
    humans = engine.infer(images_uint8)
    humans = engine.infer(images_uint8, flip_tta=True)
    humans = engine.infer_multiscale(images_uint8, combine="dedup")
    vgg = Engine(default_config("vgg19"), device="cuda")

    python -m openpose_plus_tpu_torch.train --model mobilenet_thin \
        --train-images DIR --train-annotations FILE --device cuda
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy exports: `import openpose_plus_tpu_torch` stays cheap.
    if name == "Engine":
        from openpose_plus_tpu_torch.engine import Engine
        return Engine
    if name in ("Config", "default_config"):
        from openpose_plus_tpu_torch import config as _c
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
