"""The port's operators: the hand-written CUDA kernels (`ops.cuda`), each a
`torch.library` op of the `openpose_plus_tpu_torch` namespace, and the
per-device constant cache the decoder and the int8 layers share."""

from __future__ import annotations

import functools

import torch

NAMESPACE = "openpose_plus_tpu_torch"


def device_cache(fn):
    """`functools.lru_cache` for a function that builds a constant tensor
    (on a device named among its arguments), bypassed while torch.export
    or torch.compile traces: a tensor made under tracing is a FakeTensor,
    which must neither be kept for later eager calls nor be served to a
    trace from the cache. Fill it eagerly before a CUDA-graph capture (a
    first fill inside one would record a pageable host-to-device copy)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        return cached(*args)

    return wrapper


def check_device(name: str, t: torch.Tensor) -> None:
    """The ops take CPU tensors (their plain versions) and CUDA tensors
    (their kernels); anything else raises before dispatch (a meta tensor
    would otherwise reach the op's fake implementation)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
