"""Inference engine: preprocess -> CNN forward -> grouping, on one device.

Port of `openpose_plus_tpu/engine.py`: the served `Engine.infer` path, flip
test-time augmentation, scale search (`infer_multiscale`, "avg" and "dedup"),
the space-to-depth input layouts, and calibrated int8 serving (`calibrate`,
`calibrate_from_paths`, implicit calibration on the first batch), and
`compile`, the reference's ahead-of-time build: a CUDA-graph capture of the
served step at one batch size and layout. The whole pipeline runs on the
engine's device — uint8 frames in, `HumanBatch` out — with the decoder's
serial tail in the hand-written CUDA kernels on a GPU. On a GPU, flip-TTA
and the scale search are captured at their first call of a shape (the
reference jits them), so later calls replay one CUDA graph each; plain
`infer` replays a graph at the shapes `compile` built and runs eagerly at
others. A CPU engine runs every call eagerly. `Engine(mesh=)` serves a
global batch across the ranks of a `DeviceMesh` (`parallel/sharding.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openpose_plus_tpu_torch.checkpoint import from_flax, load_model_state
from openpose_plus_tpu_torch.config import Config, PostprocConfig, default_config
from openpose_plus_tpu_torch.graphs import capture_graph
from openpose_plus_tpu_torch.host import INPUT_LAYOUTS
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.parallel import sharding
from openpose_plus_tpu_torch.postproc import (
    HumanBatch, decode_maps, merge_dedup)
from openpose_plus_tpu_torch.postproc.flip import mirror_maps
from openpose_plus_tpu_torch.utils.tracer import count, scope

_CHANNELS = (3, 12, 48)          # per INPUT_LAYOUTS level


def check_input_layout(model_cfg, input_layout: str) -> int:
    """Validate a named input layout against the model's geometry and
    supported lowerings; returns the s2d level (`openpose_plus_tpu.engine.
    check_input_layout`, the same errors)."""
    try:
        level = INPUT_LAYOUTS.index(input_layout)
    except ValueError:
        raise ValueError(f"input_layout must be one of {INPUT_LAYOUTS}, "
                         f"got {input_layout!r}") from None
    if level > model_cfg.preferred_input_layout():
        raise ValueError(
            f"input_layout {input_layout!r} is not supported by model "
            f"{model_cfg.name!r} at {model_cfg.hin}x{model_cfg.win} "
            f"({model_cfg.compute_dtype}); max supported level is "
            f"{INPUT_LAYOUTS[model_cfg.preferred_input_layout()]!r}")
    return level


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> float32 in [-0.5, 0.5] (/255 - 0.5); the
    s2d layouts are the same bytes permuted, and normalize the same."""
    return images.to(torch.float32) / 255.0 - 0.5


def resize_linear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC float resize to (h, w), matching `jax.image.resize(...,
    method="linear")`: half-pixel centers, and a triangle filter widened by
    the scale factor along an axis that shrinks (antialiasing).

    torch's `antialias=True` matches it where the output is smaller than
    the input, `antialias=False` where it is larger: the two differ in how
    they round the float32 sample positions of an upscale (368x432 ->
    552x648: 4.8e-7 without antialiasing, 3.8e-5 with it; 69x81 -> 46x54:
    2.4e-7 with it, 1.18 without). tests/test_torch_tta.py pins the sizes
    of the scale search."""
    h_in, w_in = x.shape[1], x.shape[2]
    h, w = size
    if (h, w) == (h_in, w_in):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=h < h_in or w < w_in)
    return y.permute(0, 2, 3, 1).contiguous()   # laid out as a plain input


def _final_maps(model: torch.nn.Module, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (a preprocessed float image) -> its final (conf, paf), float32."""
    out = model(x)
    return out["conf"][-1].float(), out["paf"][-1].float()


def _forward(model: torch.nn.Module, images: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    return _final_maps(model, preprocess_images(images))


def infer_step(model: torch.nn.Module, images: torch.Tensor,
               postproc_cfg: PostprocConfig, chunk: int = 0) -> HumanBatch:
    """The full engine step (preprocess -> CNN -> decode). With chunk > 0
    and a batch that is a larger multiple of it, the batch runs as a loop
    over chunk-sized sub-batches."""
    b = images.shape[0]
    if chunk and b > chunk and b % chunk == 0:
        return HumanBatch.cat([
            infer_step(model, images[i:i + chunk], postproc_cfg)
            for i in range(0, b, chunk)])
    return decode_maps(*_forward(model, images), postproc_cfg)


def _flip_average(model: torch.nn.Module, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Maps of x averaged with the mirrored-back maps of its W-flip."""
    conf, paf = _final_maps(model, x)
    conf_m, paf_m = mirror_maps(*_final_maps(model, x.flip(2)))
    return (conf + conf_m) * 0.5, (paf + paf_m) * 0.5


def infer_tta(model: torch.nn.Module, images: torch.Tensor,
              postproc_cfg: PostprocConfig) -> HumanBatch:
    """Flip test-time augmentation (`_infer_tta_impl`): two forwards, the
    image and its W-flip (of the plain image, for the s2d layouts), the
    second mirrored back, averaged in float32, decoded once."""
    return decode_maps(*_flip_average(
        model, preprocess_images(common.to_plain(images))), postproc_cfg)


def scaled_size(base: int, scale: float, stride: int) -> int:
    """A scaled input side snapped to the stride, Python's round as in the
    reference (`engine.py:327-328`)."""
    return max(stride, int(round(base * scale / stride)) * stride)


def _scaled_inputs(x0: torch.Tensor, scales: tuple[float, ...],
                   stride: int) -> list[torch.Tensor]:
    """The preprocessed float32 plain image resized to each scale (the
    float image, not the uint8 one, as the reference)."""
    base_h, base_w = x0.shape[1], x0.shape[2]
    return [resize_linear(x0, (scaled_size(base_h, s, stride),
                               scaled_size(base_w, s, stride)))
            for s in scales]


def infer_multiscale_avg(model: torch.nn.Module, images: torch.Tensor,
                         postproc_cfg: PostprocConfig,
                         scales: tuple[float, ...], flip: bool, stride: int
                         ) -> HumanBatch:
    """Scale search, combine="avg" (`_infer_multiscale_impl`): float32 maps
    of every scale (and flip), resized back to the base output grid,
    averaged, decoded once."""
    x0 = preprocess_images(common.to_plain(images))
    hout, wout = x0.shape[1] // stride, x0.shape[2] // stride
    conf_acc = paf_acc = None
    n = 0
    for xi in _scaled_inputs(x0, scales, stride):
        variants = [_final_maps(model, xi)]
        if flip:
            variants.append(mirror_maps(*_final_maps(model, xi.flip(2))))
        for conf, paf in variants:
            conf = resize_linear(conf, (hout, wout))
            paf = resize_linear(paf, (hout, wout))
            conf_acc = conf if conf_acc is None else conf_acc + conf
            paf_acc = paf if paf_acc is None else paf_acc + paf
            n += 1
    inv = 1.0 / n
    return decode_maps(conf_acc * inv, paf_acc * inv, postproc_cfg)


def infer_multiscale_dedup(model: torch.nn.Module, images: torch.Tensor,
                           postproc_cfg: PostprocConfig,
                           scales: tuple[float, ...], flip: bool,
                           stride: int, oks_threshold: float = 0.5
                           ) -> HumanBatch:
    """Scale search, combine="dedup" (`_infer_multiscale_dedup_impl`):
    each scale decoded at its own resolution (a within-scale flip average
    first), then the per-scale skeletons merged by `merge_dedup`."""
    batches = []
    for xi in _scaled_inputs(preprocess_images(common.to_plain(images)),
                             scales, stride):
        maps = _flip_average(model, xi) if flip else _final_maps(model, xi)
        batches.append(decode_maps(*maps, postproc_cfg))
    return merge_dedup(batches, oks_threshold)


class Engine:
    """End-to-end pose estimator on one torch device.

    config: full Config (model + postproc sections are used).
    params: the port's state_dict, or a flat Flax dict
        ('params/conv1/kernel' -> array, as `checkpoint.load_npz` returns)
        which goes through the weight bridge (`checkpoint.from_flax` on
        the model's names, so the legacy ConvRelu layout loads too);
        random init from `seed` otherwise.
    device: where the model, the decoder and the results live; the card
        by default. A CPU run asks for it (`device="cpu"`): without a CUDA
        device the default raises rather than falling back to the CPU.
    chunk: serve batches larger than `chunk` as a loop of sub-batches
        (`infer` without flip-TTA, as in the reference).
    fast_init: accepted for the reference's callers and changes nothing:
        the seeded init is already cheap (an int8 engine's scales start at
        zero either way).

    mesh: a `torch.distributed` `DeviceMesh` (`parallel.sharding.
        build_mesh`) to serve a global batch over its data axis, the
        reference's `Engine(mesh=)`: every rank calls with the same global
        batch, runs its contiguous slice of batch / n images on its own
        device, and gets the whole result back (the rows of every rank,
        gathered by `sharding.all_gather_rows`), as a JAX caller gets a
        global array. On a (data, spatial) mesh the batch goes over the
        data axis and is replicated over the spatial one, as the
        reference's `in_shardings` place it: the ranks of a spatial row
        serve the same slice whole. The parameters are the mesh's first
        rank's, broadcast at construction; an int8 engine's calibration
        takes the max over the data axis. A batch the data axis does not
        divide raises.

    `compile(batch_size, input_layout)` captures `infer` at that shape in a
    CUDA graph (see there); later `infer` calls at the shape replay it. On a
    CUDA engine `infer(flip_tta=True)` and `infer_multiscale` capture at
    their first call of an input shape (and, for the scale search, of its
    (scales, flip, combine)): CAPTURE_WARMUP eager calls, the capture, one
    replay; later calls copy their images in and replay that graph. Each
    graph has its own memory pool and every call returns fresh copies of
    its outputs. On a mesh only the rank's own slice is captured; the
    gather runs after the replay.

    An int8 engine (`compute_dtype="int8"`) takes float parameters with or
    without its calibration scales (a float state_dict, or a Flax dict
    without `calib/`: zero scales); `infer`, `infer_multiscale` and
    `forward` calibrate on the first batch they see unless every scale is
    already > 0. `calibrate` / `calibrate_from_paths` do it explicitly.

    Images are uint8 RGB in one of INPUT_LAYOUTS: plain (B, hin, win, 3),
    s2d (B, hin/2, win/2, 12) or s2d^2 (B, hin/4, win/4, 48), as far as
    `ModelConfig.preferred_input_layout()` allows.
    """

    def __init__(self, config: Optional[Config] = None,
                 params: Optional[Mapping] = None, seed: int = 0,
                 fast_init: bool = False, mesh=None, chunk: int = 0,
                 device: str | torch.device = "cuda"):
        self.config = config or default_config()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Engine: device {self.device}, but no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU")
        self.chunk = chunk
        self.model = get_model(self.config.model)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            common.init_params(self.model, gen)
        else:
            if any("/" in key for key in params):
                # driven by the model's names: legacy 'Conv_0' keys load,
                # entries the model lacks are ignored
                params = from_flax(params, like=self.model.state_dict())
            load_model_state(self.model, params)
        self.model.to(self.device).eval()
        # (index on the data axis, its size, its group), or None
        self._data_axis = self._mesh_axis(mesh)
        if mesh is not None:
            sharding.replicate(self.model, sharding.mesh_group(mesh))
        self._calib = [b for name, b in self.model.named_buffers()
                       if common.is_calib_leaf(name.rsplit(".", 1)[-1])]
        self._calibrated = False
        # compiled input shapes -> (graph, static input, static outputs),
        # or None until captured
        self._graphs: dict[tuple[int, ...], Optional[tuple]] = {}
        # flip-TTA and the scale search, captured at their first call:
        # ("tta", shape) or ("multiscale", shape, scales, flip, combine)
        # -> (graph, static input, static outputs)
        self._accuracy_graphs: dict[tuple, tuple] = {}

    @staticmethod
    def _mesh_axis(mesh) -> Optional[tuple]:
        if mesh is None:
            return None
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(parallel.sharding.build_mesh), got "
                            f"{type(mesh).__name__}")
        return sharding.data_axis(mesh)

    def _local_batch(self, batch: int) -> int:
        """This rank's share of a global batch."""
        if self._data_axis is None:
            return batch
        n = self._data_axis[1]
        if batch % n:
            raise ValueError(f"batch of {batch} images is not divisible by "
                             f"the mesh's data axis ({n} ranks)")
        return batch // n

    def _local(self, images):
        """This rank's contiguous rows of a global batch (the batch itself
        without a mesh)."""
        if self._data_axis is None:
            return images
        per = self._local_batch(images.shape[0])
        r = self._data_axis[0]
        return images[r * per:(r + 1) * per]

    def _gather(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        if self._data_axis is None:
            return list(tensors)
        return sharding.all_gather_rows(tensors, self._data_axis[2])

    def _gather_humans(self, humans: HumanBatch) -> HumanBatch:
        if self._data_axis is None:
            return humans
        names = [f.name for f in dataclasses.fields(humans)]
        return HumanBatch(**dict(zip(names, self._gather(
            *(getattr(humans, n) for n in names)))))

    def _images(self, images) -> torch.Tensor:
        images = torch.as_tensor(images, device=self.device)
        m = self.config.model
        channels = images.shape[-1] if images.dim() == 4 else None
        if channels not in _CHANNELS:
            raise ValueError(f"expected (B, H, W, C) images with C in "
                             f"{_CHANNELS}, got {tuple(images.shape)}")
        level = check_input_layout(m, INPUT_LAYOUTS[_CHANNELS.index(channels)])
        expect = m.input_shape(images.shape[0], level)
        if tuple(images.shape) != expect:
            raise ValueError(f"expected {INPUT_LAYOUTS[level]} images of "
                             f"shape {expect}, got {tuple(images.shape)}")
        if images.dtype != torch.uint8:
            raise ValueError(f"expected uint8 images, got {images.dtype}")
        return images

    def _serving(self, images) -> torch.Tensor:
        """This rank's checked images, after the implicit calibration of an
        int8 engine on the first batch it serves."""
        with scope("engine.inputs"):
            images = self._images(self._local(images))
            if self._needs_calibration():
                self._calibrate(images)
            return images

    @torch.inference_mode()
    def infer(self, images: np.ndarray | torch.Tensor,
              flip_tta: bool = False) -> HumanBatch:
        """images (uint8, any of INPUT_LAYOUTS) -> skeletons (on `device`).
        flip_tta averages the maps with those of the horizontally flipped
        image, mirrored back (2 forwards, 1 decode); on a CUDA engine it
        replays one graph a call (captured at the shape's first call).
        Traced as the span `engine.infer`, whose call id its inner spans
        carry, and the counter `engine.calls`."""
        with scope("engine.infer", call=True):
            count("engine.calls")
            images = self._serving(images)
            if flip_tta:
                out = self._accuracy(("tta", tuple(images.shape)), images,
                                     lambda x: infer_tta(
                                         self.model, x, self.config.postproc))
            elif tuple(images.shape) in self._graphs:
                out = self._replay(images)
            else:
                out = _eager(lambda x: infer_step(
                    self.model, x, self.config.postproc, self.chunk), images)
            return self._gather_humans(out)

    @torch.inference_mode()
    def infer_multiscale(self, images: np.ndarray | torch.Tensor,
                         scales: tuple[float, ...] = (0.5, 1.0, 1.5),
                         flip_tta: bool = False,
                         combine: str = "avg") -> HumanBatch:
        """Scale search: run the CNN at several input scales (each side
        snapped to the stride), with the flip as well if `flip_tta`.
        combine="avg" resizes every map stack to the base output grid,
        averages and decodes once; "dedup" decodes each scale at its own
        resolution and merges the skeletons by OKS-NMS (`merge_dedup`;
        (B, M * len(scales), ...) rows). On a CUDA engine one graph replay
        a call, captured at the first call of the shape and (scales, flip,
        combine)."""
        if combine not in ("avg", "dedup"):
            raise ValueError(f"combine must be 'avg' or 'dedup', "
                             f"got {combine!r}")
        impl = (infer_multiscale_avg if combine == "avg"
                else infer_multiscale_dedup)
        images = self._serving(images)
        scales, flip = tuple(scales), bool(flip_tta)
        key = ("multiscale", tuple(images.shape), scales, flip, combine)
        return self._gather_humans(self._accuracy(key, images, lambda x: impl(
            self.model, x, self.config.postproc, scales, flip,
            self.config.model.stride)))

    @torch.inference_mode()
    def forward(self, images: np.ndarray | torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """images -> (conf, paf) final-stage maps, NHWC float32."""
        return tuple(self._gather(*_forward(self.model,
                                            self._serving(images))))

    @torch.inference_mode()
    def calibrate(self, images: np.ndarray | torch.Tensor) -> None:
        """Record the int8 activation scales from representative images
        (the TensorRT int8 calibration step): one forward with every int8
        layer in calibration mode, running its bf16 float path and keeping
        the running max |activation|. Call again to widen coverage; scales
        only grow. No-op for float compute modes. With a mesh, each rank
        runs its slice and the scales are the max over the ranks."""
        if self._calib:
            self._calibrate(self._images(self._local(images)))

    def _calibrate(self, images: torch.Tensor) -> None:
        common.set_calibrating(self.model, True)
        try:
            self.model(preprocess_images(images))
        finally:
            common.set_calibrating(self.model, False)
        if self._data_axis is not None:
            flat = torch.cat([b.view(-1) for b in self._calib])
            torch.distributed.all_reduce(
                flat, torch.distributed.ReduceOp.MAX,
                group=self._data_axis[2])
            for b, v in zip(self._calib, flat.split(
                    [b.numel() for b in self._calib])):
                b.copy_(v.view_as(b))
        self._calibrated = True
        # the graphs hold int8 weights and rescales read at capture:
        # recapture at the next call
        self._graphs = dict.fromkeys(self._graphs)
        self._accuracy_graphs.clear()

    def calibrate_from_paths(self, paths, batch_size: int = 8) -> None:
        """Calibrate from image files, the TensorRT protocol's held-out
        calibration set (train-side images, not the eval images): each
        letterboxed to the engine's geometry, in batches of `batch_size`,
        the last padded by repeating its last image (scales only grow, so
        repeats change nothing). No-op for float compute modes."""
        if not self._calib:
            return
        from openpose_plus_tpu_torch.data.augment import letterbox
        from openpose_plus_tpu_torch.data.pipeline import _load_image

        m = self.config.model
        imgs = [letterbox(_load_image(p), m.hin, m.win)[0] for p in paths]
        for i in range(0, len(imgs), batch_size):
            chunk = imgs[i:i + batch_size]
            while len(chunk) < batch_size:
                chunk.append(chunk[-1])
            self.calibrate(np.stack(chunk))

    def _needs_calibration(self) -> bool:
        """An int8 engine needs calibration until every scale is > 0 (a
        partly calibrated one would saturate its zero-scale layers); the
        answer is kept once every scale is > 0."""
        if not self._calib or self._calibrated:
            return False
        self._calibrated = bool(torch.stack(self._calib).min() > 0)
        return not self._calibrated

    def compile(self, batch_size: int, input_layout: str = "plain") -> None:
        """Build the served step for a fixed batch size and input layout,
        the reference's ahead-of-time compile (the TensorRT "engine build"
        step). input_layout: "plain" (B,hin,win,3), "s2d" (B,hin/2,win/2,
        12) or "s2d2" (B,hin/4,win/4,48), validated as the reference does.

        On a CUDA engine: CAPTURE_WARMUP eager calls on a side stream (they
        build the kernels and fill every lazy cache), then `infer_step`
        (with `chunk`, without flip-TTA, as the reference compiles only
        `_infer`) captured in a `torch.cuda.CUDAGraph` over a static uint8
        input. A later `infer` of that shape copies its images in, replays
        the graph and returns fresh copies of its outputs (the next replay
        overwrites the graph's own). Other shapes run eagerly; flip-TTA and
        the scale search capture at their own first call. An int8 engine
        that still needs calibration captures at its first `infer` of the
        shape, after calibrating; `calibrate`
        drops the graphs, which are captured again at the next `infer`. A
        capture that fails raises. Weights changed after a capture are
        not seen by an int8 graph (its packed int8 weights are taken at
        capture): compile again.

        With a mesh, `batch_size` is the global batch and each rank
        captures its slice of it.

        On a CPU engine: the layout is validated and one warm-up call runs
        (the counterpart of XLA compiling for the CPU); `infer` stays
        eager."""
        m = self.config.model
        shape = m.input_shape(self._local_batch(batch_size),
                              check_input_layout(m, input_layout))
        if self.device.type != "cuda":
            with torch.inference_mode():
                infer_step(self.model, torch.zeros(shape, dtype=torch.uint8,
                                                   device=self.device),
                           self.config.postproc, self.chunk)
            return
        self._graphs[shape] = None
        if not self._needs_calibration():
            self._capture(shape)

    @torch.inference_mode()
    def _capture(self, shape: tuple[int, ...]) -> None:
        static_in = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        graph, out = capture_graph(lambda: infer_step(
            self.model, static_in, self.config.postproc, self.chunk),
            self.device)
        self._graphs[shape] = (graph, static_in, out)

    def _replay(self, images: torch.Tensor) -> HumanBatch:
        shape = tuple(images.shape)
        if self._graphs[shape] is None:
            self._capture(shape)
        return _run_graph(self._graphs[shape], images)

    def _accuracy(self, key: tuple, images: torch.Tensor,
                  step: Callable[[torch.Tensor], HumanBatch]) -> HumanBatch:
        """step(images) eagerly on a CPU engine; on a CUDA engine through
        the graph of `key`, captured over a static copy of the images at
        the key's first call."""
        if self.device.type != "cuda":
            return _eager(step, images)
        if key not in self._accuracy_graphs:
            static_in = images.clone()
            graph, out = capture_graph(lambda: step(static_in), self.device)
            self._accuracy_graphs[key] = (graph, static_in, out)
        return _run_graph(self._accuracy_graphs[key], images)


def _eager(step: Callable[[torch.Tensor], HumanBatch],
           images: torch.Tensor) -> HumanBatch:
    """step(images) run op by op, at a shape with no graph: the span
    `engine.eager` and the counter `engine.eager_calls`."""
    count("engine.eager_calls")
    with scope("engine.eager"):
        return step(images)


def _run_graph(entry: tuple, images: torch.Tensor) -> HumanBatch:
    """(graph, static input, static outputs): the images copied in, one
    replay, fresh copies of the outputs (the next replay overwrites the
    graph's own); the spans `engine.copy_in`, `engine.replay` (the graph's
    launch) and `engine.outputs`, the counter `engine.replays`."""
    graph, static_in, out = entry
    count("engine.replays")
    with scope("engine.copy_in"):
        static_in.copy_(images)
    with scope("engine.replay"):
        graph.replay()
    with scope("engine.outputs"):
        return HumanBatch(**{f.name: getattr(out, f.name).clone()
                             for f in dataclasses.fields(out)})
