"""Weight bridge between the JAX package's flat npz layout and torch.

The JAX package saves parameters as a flat npz of 'scope/name' keys
(`openpose_plus_tpu.checkpoint.save_npz`), e.g.
'params/stages/stage2_paf/SepConvRelu_1/dw_kernel'. The port names its
submodules after the Flax scopes, so the mapping is mechanical: drop the
leading 'params' collection, join the scopes with '.', rename the leaf, and
move every 4-D kernel from HWIO to OIHW. One permutation serves all three
kernel kinds:

    dense      (k, k, Cin, Cout) -> (Cout, Cin, k, k)
    depthwise  (3, 3, 1, C)      -> (C, 1, 3, 3)     (groups=C)
    pointwise  (1, 1, C, F)      -> (F, C, 1, 1)
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias",
                  "dw_kernel": "dw_weight", "dw_bias": "dw_bias",
                  "pw_kernel": "pw_weight", "pw_bias": "pw_bias"}
_TORCH_TO_LEAF = {v: k for k, v in _LEAF_TO_TORCH.items()}
_COLLECTION = "params"


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Flat 'params/conv1/kernel' -> ndarray dict, as the JAX `save_npz`
    writes it (np.savez appends '.npz' to bare paths; either spelling)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        return dict(f)


def from_flax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax dict -> torch state_dict (float32, OIHW kernels)."""
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        scopes = key.split("/")
        if scopes[0] != _COLLECTION or scopes[-1] not in _LEAF_TO_TORCH:
            raise KeyError(f"not a float model parameter: {key!r}")
        arr = np.array(value, dtype=np.float32)       # an owned copy
        if arr.ndim == 4:
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        name = ".".join(scopes[1:-1] + [_LEAF_TO_TORCH[scopes[-1]]])
        out[name] = torch.from_numpy(arr)
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """torch state_dict -> flat Flax dict (inverse of `from_flax`)."""
    out: dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        scopes = name.split(".")
        if scopes[-1] not in _TORCH_TO_LEAF:
            raise KeyError(f"not a model parameter: {name!r}")
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        key = "/".join([_COLLECTION] + scopes[:-1]
                       + [_TORCH_TO_LEAF[scopes[-1]]])
        out[key] = np.ascontiguousarray(arr)
    return out
