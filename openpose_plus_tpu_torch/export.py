"""Serialized engine artifacts via torch.export (port of
`openpose_plus_tpu/export.py`).

The reference freezes the whole engine step (uint8 preprocess -> CNN ->
on-device grouping) into a jax.export StableHLO artifact that reloads and
runs without the model-building code, weights baked in, like the original
project's frozen graph. Here the same step goes through
`torch.export.export` into an ExportedProgram (`engine.pt2`, written by
`torch.export.save`): the graph's nodes are ATen ops and the port's
`openpose_plus_tpu_torch::` kernel ops, and its state holds the weights.
Loading imports the op registrations, `config`, `host`, `graphs` and
`postproc.HumanBatch`, never `openpose_plus_tpu_torch.models` or `engine`;
on the card the loaded graph launches the same hand-written kernels, and
`ExportedEngine.infer` replays it as one CUDA graph a call (the reference
jits the loaded artifact).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from openpose_plus_tpu_torch.graphs import capture_graph
from openpose_plus_tpu_torch.postproc import HumanBatch

_MANIFEST = "manifest.json"
_ARTIFACT = "engine.pt2"
FIELDS = tuple(f.name for f in dataclasses.fields(HumanBatch))
FORMAT = "torch.export"


class _InferStep(torch.nn.Module):
    """`engine.infer_step` as a module (the model's weights become the
    program's state), returning the HumanBatch fields as a tuple."""

    def __init__(self, model: torch.nn.Module, postproc_cfg):
        super().__init__()
        self.model = model
        self.postproc_cfg = postproc_cfg

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        from openpose_plus_tpu_torch.engine import infer_step

        out = infer_step(self.model, images, self.postproc_cfg)
        return tuple(getattr(out, name) for name in FIELDS)


def save_engine(engine, path: str, batch_size: int = 1,
                input_layout: str = "plain") -> None:
    """Export the engine for a fixed batch size to `path/` (a directory):
    `engine.pt2` (torch.export.save of the traced step, weights baked in,
    on the engine's device; an int8 engine's packed int8 weights, so the
    artifact never quantizes a weight) and `manifest.json`.

    input_layout: "plain" (B,hin,win,3), "s2d" (B,hin/2,win/2,12) or
    "s2d2" (B,hin/4,win/4,48), baked into the program's input signature
    and recorded in the manifest."""
    from openpose_plus_tpu_torch.engine import check_input_layout
    from openpose_plus_tpu_torch.models.common import frozen_int8_weights

    if engine._needs_calibration():
        raise ValueError(
            "int8 engine exported before calibration: the activation "
            "scales would be frozen at zero. Call Engine.calibrate() on "
            "representative images first.")
    m = engine.config.model
    shape = m.input_shape(batch_size, check_input_layout(m, input_layout))
    example = torch.zeros(shape, dtype=torch.uint8, device=engine.device)
    with torch.no_grad(), frozen_int8_weights(engine.model):
        program = torch.export.export(
            _InferStep(engine.model, engine.config.postproc), (example,),
            strict=False)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _ARTIFACT))
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump({
            "model": m.name,
            "batch_size": batch_size,
            "hin": m.hin,
            "win": m.win,
            "input_layout": input_layout,
            "format": FORMAT,
            "platforms": [engine.device.type],
            "device": str(engine.device),
            # the full config, so ExportedEngine.config reports what the
            # artifact was built with (stride, dtype, postproc settings)
            "model_config": dataclasses.asdict(m),
            "postproc_config": dataclasses.asdict(engine.config.postproc),
        }, f, indent=2)


class ExportedEngine:
    """A loaded artifact: infer(images u8) -> HumanBatch.

    Duck-types the slice of Engine the CLI uses (`infer`, `config`,
    `batch_size`), so `infer --engine-dir` runs a frozen artifact with no
    model code. Accepts plain (B, hin, win, 3) images whatever the
    artifact's baked input_layout (the space-to-depth permutation is
    applied on the host when the signature needs it), or the baked layout
    directly.

    On a CUDA artifact the first `infer` captures the program in a CUDA
    graph over a static input of the artifact's batch shape (the warm-up
    calls, the capture, one replay); every call copies its images in,
    replays the graph and returns fresh copies of its outputs. A CPU
    artifact runs the program eagerly."""

    def __init__(self, path: str):
        # the kernel ops the program calls must be registered before load
        from openpose_plus_tpu_torch.ops.cuda import (  # noqa: F401
            bias_act, greedy, int8_conv, merge, paf_sample, sepconv)

        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} artifact (format "
                             f"{self.manifest.get('format')!r})")
        self.device = torch.device(self.manifest["device"])
        self._program = torch.export.load(os.path.join(path, _ARTIFACT))
        self._call = self._program.module()
        if self.device.type == "cuda":
            _constants_to(self._call, self.device)
        self._graph = None       # (graph, static input, static outputs)

    @property
    def config(self):
        from openpose_plus_tpu_torch.config import default_config

        cfg = default_config(self.manifest["model"])
        mc = dataclasses.replace(cfg.model, **self.manifest["model_config"])
        pc = dataclasses.replace(cfg.postproc,
                                 **self.manifest["postproc_config"])
        return cfg.replace(model=mc, postproc=pc)

    @property
    def batch_size(self) -> int:
        return int(self.manifest["batch_size"])

    @torch.inference_mode()
    def infer(self, images: np.ndarray | torch.Tensor) -> HumanBatch:
        from openpose_plus_tpu_torch import host

        level = host.INPUT_LAYOUTS.index(self.manifest["input_layout"])
        if level and images.shape[-1] == 3:       # plain images: pack them
            images = np.stack([host.pack(f, level) for f in np.asarray(
                torch.as_tensor(images, dtype=torch.uint8).cpu())])
        x = torch.as_tensor(images, device=self.device)
        if self.device.type != "cuda":
            return HumanBatch(**dict(zip(FIELDS, self._call(x))))
        if self._graph is None:
            static_in = x.clone()
            graph, out = capture_graph(lambda: self._call(static_in),
                                       self.device)
            self._graph = (graph, static_in, out)
        graph, static_in, out = self._graph
        if x.shape != static_in.shape or x.dtype != static_in.dtype:
            raise ValueError(f"expected {static_in.dtype} images of shape "
                             f"{tuple(static_in.shape)}, the artifact's, "
                             f"got {x.dtype} {tuple(x.shape)}")
        static_in.copy_(x)
        graph.replay()
        return HumanBatch(**{name: t.clone() for name, t in zip(FIELDS, out)})


def _constants_to(module: torch.fx.GraphModule, device: torch.device
                  ) -> None:
    """The program's host-made constants (the decoder's smoothing operator
    and tables, built from numpy while it was traced: `lift_fresh_copy`
    of a CPU tensor, a check that it is on the CPU, a copy to the card)
    moved to `device` once, with their CPU checks dropped: left on the CPU
    they are copied over at every call, which a CUDA-graph capture
    refuses."""
    copy, check = (torch.ops.aten.lift_fresh_copy.default,
                   torch.ops.aten._assert_tensor_metadata.default)
    graph = module.graph
    for node in list(graph.nodes):
        if node.op != "get_attr":
            continue
        owner, _, name = node.target.rpartition(".")
        parent = module.get_submodule(owner)
        value = getattr(parent, name)
        if (not isinstance(value, torch.Tensor)
                or isinstance(value, torch.nn.Parameter)
                or value.device.type != "cpu"):
            continue
        setattr(parent, name, value.to(device))
        copies = [u for u in node.users if u.target is copy]
        for user in [*node.users, *(u for c in copies for u in c.users)]:
            if user.target is check:
                graph.erase_node(user)
    graph.lint()
    module.recompile()


def load_engine(path: str) -> ExportedEngine:
    return ExportedEngine(path)
