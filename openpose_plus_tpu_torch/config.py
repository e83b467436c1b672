"""The port's configuration: every section of `openpose_plus_tpu/config.py`
(model, post-processing, data, training, mesh), copied so that the port
imports nothing of the JAX package. Field names, defaults and the
`fidelity()` / `quality()` presets are the JAX package's (a port-only
model's `default_config` also sets its map channels);
`tests/test_torch_config.py` pins them equal to the originals. The mesh
section lays out the ranks of `parallel/` (a data axis and a spatial axis
that shards the image height).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture and map geometry."""

    name: str = "mobilenet_thin"
    n_heatmaps: int = 19
    n_pafs: int = 38
    hin: int = 368
    win: int = 432
    stride: int = 8            # backbone output stride
    n_stages: int = 6          # refinement stages
    compute_dtype: str = "bfloat16"   # "bfloat16", "float32" or "int8"
    width_multiplier: float = 0.75
    # Kept for the s2d input layouts' gate (`preferred_input_layout`); the
    # port turns an s2d input back into the plain image before conv1.
    stem_s2d: bool = True
    # recompute each stage branch's activations in the backward pass
    remat_stages: bool = False
    # Route the marked stride-1 3x3 bf16 separable layers through the
    # hand-written `fused_sepconv` kernel (inference only: training with
    # it raises).
    fused_inference: bool = False

    def preferred_input_layout(self) -> int:
        """Space-to-depth level of the largest uint8 input layout the model
        takes: 0 = plain (B,hin,win,3), 1 = (B,hin/2,win/2,12),
        2 = (B,hin/4,win/4,48)."""
        if not self.stem_s2d or self.compute_dtype == "int8":
            return 0
        if (self.name in ("mobilenet_thin", "mobilenet")
                and self.hin % 4 == 0 and self.win % 4 == 0):
            return 2
        if self.hin % 2 == 0 and self.win % 2 == 0:
            return 1
        return 0

    def train_lowering(self) -> "ModelConfig":
        """The config the JAX package's training programs build against
        (`config.py::train_lowering`): VGG19 trains with the plain stem
        (`stem_s2d=False`), every other model as it serves. The port's
        models never lower through s2d, so here the flag only gates the s2d
        input layouts (`preferred_input_layout`)."""
        if self.name in ("vgg19", "vgg") and self.stem_s2d:
            return dataclasses.replace(self, stem_s2d=False)
        return self

    def input_shape(self, batch: int, level: int | None = None
                    ) -> tuple[int, int, int, int]:
        """uint8 input shape for a space-to-depth level (default: the
        model's preferred layout)."""
        if level is None:
            level = self.preferred_input_layout()
        return {0: (batch, self.hin, self.win, 3),
                1: (batch, self.hin // 2, self.win // 2, 12),
                2: (batch, self.hin // 4, self.win // 4, 48)}[level]

    @property
    def hout(self) -> int:
        return self.hin // self.stride

    @property
    def wout(self) -> int:
        return self.win // self.stride


@dataclasses.dataclass(frozen=True)
class PostprocConfig:
    """Grouping parameters: static capacities (top-K peaks per part, M
    skeleton slots) and the reference PAF pipeline's thresholds."""

    max_peaks: int = 16          # top-K peak cap per part channel
    max_humans: int = 32         # skeleton slots per image
    peak_threshold: float = 0.05
    paf_n_samples: int = 10      # points sampled along each candidate limb
    paf_sample_threshold: float = 0.05
    paf_inlier_ratio: float = 0.8
    min_parts_per_human: int = 3
    min_human_score: float = 0.0
    upsample_factor: int = 2     # map upsampling before peak finding
    smooth_sigma: float = 1.25   # Gaussian smoothing before NMS (pixels)
    # Fragment-merge repair pass (`decode.merge_fragments`); 0 disables.
    fragment_merge_rel: float = 0.0
    fragment_merge_rounds: int = 8

    def fidelity(self, upsample: int = 8) -> "PostprocConfig":
        """High-fidelity settings: input-resolution maps, K=32, sigma 5."""
        return dataclasses.replace(self, max_peaks=32,
                                   upsample_factor=upsample,
                                   smooth_sigma=5.0)

    def quality(self, upsample: int = 8) -> "PostprocConfig":
        """`fidelity()` plus the fragment-merge pass at rel 0.5."""
        return dataclasses.replace(self.fidelity(upsample),
                                   fragment_merge_rel=0.5)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths, augmentation ranges, GT label widths and the host
    pipeline's workers."""

    train_images: str = "data/coco/train2017"
    train_annotations: str = "data/coco/annotations/person_keypoints_train2017.json"
    val_images: str = "data/coco/val2017"
    val_annotations: str = "data/coco/annotations/person_keypoints_val2017.json"
    rotate_max_deg: float = 40.0
    scale_min: float = 0.5
    scale_max: float = 1.1
    shift_frac: float = 0.25   # random-crop center shift, fraction of frame
    flip_prob: float = 0.5
    sigma: float = 8.0           # GT heatmap Gaussian sigma (input pixels)
    limb_width: float = 8.0      # GT PAF band half-width (input pixels)
    prefetch: int = 4
    num_workers: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule: Adam or momentum, staircase lr decay, L2 on
    the kernels, logging, checkpoints and visual dumps."""

    batch_size: int = 8
    n_steps: int = 600_000
    lr_init: float = 4e-5
    lr_decay_every: int = 136_120
    lr_decay_factor: float = 0.333
    weight_decay: float = 5e-4
    optimizer: str = "adam"      # "adam" | "momentum"
    momentum: float = 0.9
    # distributed strategy: "sync-sgd", "sma", "pair-avg" (parallel/kungfu.py)
    kf_optimizer: str = "sync-sgd"
    # "inv-sqrt-area": lr_init * sqrt(lr_ref_area / (hout * wout));
    # "none": lr_init as it is (train.effective_lr_init)
    lr_scaling: str = "none"
    lr_ref_area: int = 256
    log_every: int = 100
    checkpoint_every: int = 5000
    checkpoint_dir: str = "checkpoints"
    metrics_csv: str = ""        # one CSV row per log interval; "" = off
    vis_every: int = 0           # predicted-vs-GT heatmap dumps; 0 = off
    vis_dir: str = "vis"
    seed: int = 0
    donate_state: bool = True    # JAX buffer donation; the port updates in place


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout: a data axis and an optional spatial axis."""

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    spatial_parallelism: int = 1   # shards of the image H dimension
    multihost: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    postproc: PostprocConfig = dataclasses.field(
        default_factory=PostprocConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Models the JAX package lacks, with the map channels they predict
# (OpenPose's BODY_25: 25 parts and the background, 26 limbs).
PORT_ONLY_MODELS = {"body25": dict(n_heatmaps=26, n_pafs=52)}


def default_config(model_name: Optional[str] = None) -> Config:
    cfg = Config()
    if model_name is not None:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, name=model_name,
            **PORT_ONLY_MODELS.get(model_name, {})))
    return cfg
