"""Training checkpoints with resume, and the weight bridge between the JAX
package's flat npz layout and torch.

Checkpoints (`openpose_plus_tpu/checkpoint.py::save/latest_step/restore`):
one directory a step under the checkpoint path, `<path>/<step>/state.pt`
holding the step and the `state_dict` of the model, the optimizer and the
lr schedule (`torch.save`); only the newest `keep` are kept, and a save is
written under a temporary name and renamed into place, so an interrupted
save never leaves a step directory behind.

The JAX package saves parameters as a flat npz of 'scope/name' keys
(`openpose_plus_tpu.checkpoint.save_npz`), e.g.
'params/stages/stage2_paf/SepConvRelu_1/dw_kernel'. The port names its
submodules after the Flax scopes, so the mapping is mechanical: drop the
leading 'params' collection, join the scopes with '.', rename the leaf, and
move every 4-D kernel from HWIO to OIHW. An int8 model's `calib` collection
('calib/conv1_1/act_scale', 'calib/stages/stage2_in_scale') maps the same
way onto the buffers of the same names (0-d float32). One permutation
serves all three kernel kinds:

    dense      (k, k, Cin, Cout) -> (Cout, Cin, k, k)
    depthwise  (3, 3, 1, C)      -> (C, 1, 3, 3)     (groups=C)
    pointwise  (1, 1, C, F)      -> (F, C, 1, 1)

A checkpoint loads driven by the model's names, as the reference's
`load_npz(path, template)` rebuilds its template (`from_flax(flat,
like=model.state_dict())`): each parameter is taken under its flattened
name, or else under the legacy name of checkpoints from before the ConvRelu
flattening, which held the conv in an nn.Conv child ('.../ConvRelu_1/
Conv_0/kernel' for '.../ConvRelu_1/kernel'); npz entries the model does not
have are ignored. A rule on the model's names never rewrites a current
'Conv_0' scope (the stage heads' 'stages/stage2_conf/Conv_0').
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Mapping, Optional

import numpy as np
import torch

from openpose_plus_tpu_torch.models.common import is_calib_leaf

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias",
                  "dw_kernel": "dw_weight", "dw_bias": "dw_bias",
                  "pw_kernel": "pw_weight", "pw_bias": "pw_bias"}
_TORCH_TO_LEAF = {v: k for k, v in _LEAF_TO_TORCH.items()}
_COLLECTION = "params"
_CALIB = "calib"


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Flat 'params/conv1/kernel' -> ndarray dict, as the JAX `save_npz`
    writes it (np.savez appends '.npz' to bare paths; either spelling)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        return dict(f)


def _to_torch(value) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)            # an owned copy
    if arr.ndim == 4:
        arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return torch.from_numpy(arr)


def _flax_key(name: str) -> str:
    """A torch state_dict name -> its flat Flax key."""
    scopes = name.split(".")
    if is_calib_leaf(scopes[-1]):
        return "/".join([_CALIB] + scopes)
    if scopes[-1] not in _TORCH_TO_LEAF:
        raise KeyError(f"not a model parameter: {name!r}")
    return "/".join([_COLLECTION] + scopes[:-1]
                    + [_TORCH_TO_LEAF[scopes[-1]]])


def _flax_shape(tensor: torch.Tensor) -> tuple[int, ...]:
    shape = tuple(tensor.shape)
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 \
        else shape


def from_flax(flat: Mapping[str, np.ndarray],
              like: Optional[Mapping[str, torch.Tensor]] = None
              ) -> dict[str, torch.Tensor]:
    """Flat Flax dict -> torch state_dict (float32, OIHW kernels; the
    calib scales as 0-d buffers).

    Without `like`, every key of `flat` is converted (KeyError for one that
    is neither a parameter nor a calib scale). With `like` (a model's
    state_dict), the model's names drive the load, as the reference's
    `load_npz` does: each name is taken under its Flax key or its legacy
    'Conv_0' key (module docstring); KeyError if both are absent (a calib
    scale may be: an int8 model then keeps its zero scale), ValueError
    naming both shapes if they differ; entries the model lacks are
    ignored."""
    out: dict[str, torch.Tensor] = {}
    if like is None:
        for key, value in flat.items():
            scopes = key.split("/")
            if scopes[0] == _CALIB and is_calib_leaf(scopes[-1]):
                name = ".".join(scopes[1:])
            elif scopes[0] == _COLLECTION and scopes[-1] in _LEAF_TO_TORCH:
                name = ".".join(scopes[1:-1] + [_LEAF_TO_TORCH[scopes[-1]]])
            else:
                raise KeyError(
                    f"not a model parameter or calib scale: {key!r}")
            out[name] = _to_torch(value)
        return out
    for name, tensor in like.items():
        key = _flax_key(name)
        if key not in flat:
            scopes = key.split("/")
            legacy = "/".join(scopes[:-1] + ["Conv_0", scopes[-1]])
            if legacy in flat:
                key = legacy
            elif is_calib_leaf(scopes[-1]):
                continue
            else:
                raise KeyError(f"npz missing parameter {key!r}")
        shape = np.shape(flat[key])
        if shape != _flax_shape(tensor):
            raise ValueError(f"shape mismatch for {key!r}: npz {shape} vs "
                             f"model {_flax_shape(tensor)}")
        out[name] = _to_torch(flat[key])
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """torch state_dict -> flat Flax dict (inverse of `from_flax`)."""
    out: dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        out[_flax_key(name)] = arr.copy()        # C order; 0-d stays 0-d
    return out


def load_model_state(model: torch.nn.Module,
                     state: Mapping[str, torch.Tensor]) -> None:
    """`model.load_state_dict(state)`, strict except for the int8 calib
    scales: an int8 model keeps zero scales where `state` has none (float
    weights serve every compute mode, as in the reference), and a float
    model ignores scales it has no buffers for."""
    own = set(model.state_dict())
    state = {k: v for k, v in state.items()
             if k in own or not is_calib_leaf(k.rsplit(".", 1)[-1])}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not is_calib_leaf(k.rsplit(".", 1)[-1])]
    if missing or unexpected:
        raise RuntimeError(f"load_model_state: missing keys {missing}, "
                           f"unexpected keys {unexpected}")


# ------------------------------------------------------------ checkpoints ---

_STATE_FILE = "state.pt"


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(name) for name in os.listdir(path)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(path, name, _STATE_FILE)))


def save(path: str, state: Any, step: int, keep: int = 3) -> None:
    """Save a TrainState (anything with `state_dict()`) under path/<step>,
    atomically, then delete all but the newest `keep` steps."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(int(step)))
    tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=path)
    try:
        torch.save(state.state_dict(), os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, str(old)), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    """The newest saved step under `path`, or None."""
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, template: Any, step: Optional[int] = None) -> Any:
    """Load path/<step> (the newest by default) into `template` (a
    TrainState: its model, optimizer and schedule, on their device) and
    return it."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    state = torch.load(os.path.join(path, str(int(step)), _STATE_FILE),
                       map_location=template.device, weights_only=True)
    template.load_state_dict(state)
    return template


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """A model's state_dict as the JAX package's flat npz ('params/...'
    keys, HWIO kernels; `openpose_plus_tpu.checkpoint.load_npz` reads it).
    np.savez appends '.npz' to a bare path; the path written is returned."""
    np.savez(path, **to_flax(state_dict))
    return path if path.endswith(".npz") else path + ".npz"
