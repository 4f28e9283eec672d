"""Frozen dataclass configuration with strict-key YAML/flag override.

Key/value parity with the reference global config
(reference lib/core/config.py:17-85): the same section names
(DATASET / MODEL / SPIN / AUG / TEST) and defaults (workers=16, batch_size=8,
min_frame_ratio=0.33, bbox_scale=1.2, input_shape=(224,224), FOCAL_LENGTH=5000,
IMG_RES=224), and the same strict-key check on override (unknown keys raise
ValueError, mirroring update_config at config.py:63-85).

Own copy of the JAX package's config: the same keys and defaults, so one
YAML override file configures either package. Fields that belong to later
slices of the port (the PARALLEL model axes) are accepted here and rejected
by the entry points that do not run them yet.
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple

_REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@dataclass(frozen=True)
class DatasetConfig:
    workers: int = 16
    batch_size: int = 8
    min_frame_ratio: float = 0.33
    bbox_scale: float = 1.2
    default_information: str = osp.join(
        _REPO_ROOT, "poserisk_release_tpu_torch", "default_information.json"
    )
    # JPEG round-trip ingest parity mode: route every decoded frame through
    # '{output}/tmp/%09d.jpg' exactly like the reference (funcs_utils.py:42,
    # demo_dataset.py:59) so detector/SPIN inputs carry the same JPEG
    # artifacts. Off by default.
    jpeg_ingest: bool = False
    # Video-decode threads. 1 (default) = the serial one-window-lookahead
    # decoder. > 1 splits the clip into window-aligned segments decoded by
    # that many capture threads (io.video.iter_windows_parallel); frames are
    # bit-identical to serial decode.
    decode_workers: int = 1

    def __post_init__(self) -> None:
        if self.decode_workers < 1:
            raise ValueError(
                f"DATASET.decode_workers must be >= 1, got {self.decode_workers}")


@dataclass(frozen=True)
class ModelConfig:
    input_shape: Tuple[int, int] = (224, 224)


@dataclass(frozen=True)
class SpinConfig:
    spin_dir: str = osp.join(_REPO_ROOT, "data", "spin_data")
    smpl_mean_params: str = osp.join(_REPO_ROOT, "data", "spin_data", "smpl_mean_params.npz")
    checkpoint: str = osp.join(_REPO_ROOT, "data", "spin_data", "model_checkpoint.pt")
    smpl_model_dir: str = osp.join(_REPO_ROOT, "data", "human_models")
    focal_length: float = 5000.0
    img_res: int = 224
    # Number of iterative-error-feedback refinement steps in the HMR head.
    ief_iters: int = 3
    # Mixed-precision boundary of the int8 SPIN backbone: only residual
    # stages >= this are quantized (the stem is stage 0).
    int8_min_stage: int = 0
    # Pose-stride throughput mode: run crop+SPIN only on every Nth tracked
    # frame and slerp the skipped frames' joint rotations between the
    # surrounding anchors; Euler/joints/scoring still cover every frame.
    # 1 = the reference's pose-every-frame contract.
    pose_stride: int = 1
    # Space-to-depth stem layout of the JAX package (same weights, same
    # outputs). The port always runs the plain 7x7 stem; the key stays so
    # shared YAML files load.
    stem_s2d: bool = True

    def __post_init__(self) -> None:
        if self.pose_stride < 1:
            raise ValueError(
                f"SPIN.pose_stride must be >= 1, got {self.pose_stride}")


@dataclass(frozen=True)
class AugConfig:
    flip: bool = False
    rotate_factor: float = 0.0


@dataclass(frozen=True)
class TestConfig:
    pass


@dataclass(frozen=True)
class DetectorConfig:
    """YOLOv3 person detector settings (reference: lib/core/base.py:38-46)."""

    img_size: int = 416
    detection_threshold: float = 0.1
    nms_threshold: float = 0.45
    weights: str = osp.join(_REPO_ROOT, "data", "detector", "yolov3.weights")
    # Frames per decoded window fed to the detector (the reference used 8,
    # lib/core/base.py:41).
    batch_size: int = 64
    # Rectangular detector canvas (ops/crop.rect_canvas_geometry): the
    # square letterbox's content on a canvas padded only to a multiple of 32.
    rect_letterbox: bool = False
    # int8 post-training quantization of the conv tower; only convs whose
    # input sits at >= int8_min_downsample are quantized.
    int8: bool = False
    int8_min_downsample: int = 1
    # Device-side top-k detection pre-selection (YoloDetector._pull_detections;
    # results never depend on it). 0 disables.
    max_device_dets: int = 256
    # Opt-in throughput mode: run the detector only on every Nth frame
    # (global index stride) and fill each track's gaps by linear bbox
    # interpolation (tracking/mpt.interpolate_track_gaps). 1 = the
    # reference's detect-every-frame contract.
    detection_stride: int = 1
    # Motion-adaptive upgrade of detection_stride (tracking/mpt.
    # adaptive_window_detections): detection_stride becomes the MAX
    # interval. Requires detection_stride > 1.
    adaptive_stride: bool = False
    adaptive_tol: float = 0.2
    # Explicit int8 calibration source (io/video.load_calibration_frames)
    # and the per-video re-calibration of shared instances.
    calibration: str = ""
    calibration_frames: int = 64
    recalibrate_per_video: bool = False

    def __post_init__(self) -> None:
        if self.detection_stride < 1:
            raise ValueError(
                f"DETECTOR.detection_stride must be >= 1, got {self.detection_stride}")
        if self.adaptive_stride and self.detection_stride <= 1:
            raise ValueError(
                "DETECTOR.adaptive_stride needs detection_stride > 1 (the "
                "stride is the adaptive schedule's MAX interval)")


@dataclass(frozen=True)
class ParallelConfig:
    """Device layout. frames_per_step is the pose chunk per data rank. The
    data, model (tp), stage (pp), expert (ep) and spatial (sp: crop rows)
    axes describe a mesh over torch.distributed ranks (parallel/spmd.
    mesh_from_config), which the estimator builds when any model axis is
    > 1 or num_devices > 1."""

    data_axis: str = "data"
    # Data-axis size. 0 => all devices left over after the model axes.
    num_devices: int = 0
    # Crops per pose step (frames per data shard per step).
    frames_per_step: int = 64
    model: int = 1
    spatial: int = 1
    stage: int = 1
    stage_microbatches: int = 4
    expert: int = 1

    def __post_init__(self) -> None:
        for name in ("model", "spatial", "stage", "expert",
                     "stage_microbatches"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"PARALLEL.{name} must be >= 1, got {getattr(self, name)}")
        if self.expert > 1 and self.expert < 3:
            raise ValueError(
                "PARALLEL.expert must be >= 3 when enabled (one row per "
                f"gendered SMPL model), got {self.expert}")


@dataclass(frozen=True)
class Config:
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    SPIN: SpinConfig = field(default_factory=SpinConfig)
    AUG: AugConfig = field(default_factory=AugConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DETECTOR: DetectorConfig = field(default_factory=DetectorConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **sections: Mapping[str, Any]) -> "Config":
        """Return a new Config with per-section field overrides.

        Strict-key semantics: an unknown section or field raises ValueError,
        matching the reference's update_config behaviour.
        """
        updates = {}
        for section_name, section_overrides in sections.items():
            if not hasattr(self, section_name):
                raise ValueError(f"{section_name} not exist in config")
            section = getattr(self, section_name)
            if dataclasses.is_dataclass(section) and isinstance(section_overrides, Mapping):
                valid = {f.name for f in dataclasses.fields(section)}
                for key in section_overrides:
                    if key not in valid:
                        raise ValueError(f"{section_name}.{key} not exist in config")
                updates[section_name] = dataclasses.replace(section, **section_overrides)
            else:
                raise ValueError(f"{section_name} override must be a mapping of fields")
        return dataclasses.replace(self, **updates)


def default_config() -> Config:
    return Config()


def load_yaml_config(path: str, base: Config | None = None) -> Config:
    """Load a YAML override file onto the default config (strict keys).

    Section keys are case-insensitive aliases of the dataclass sections so the
    reference's upper-case YAML section names keep working.
    """
    import yaml

    base = base or default_config()
    with open(path) as f:
        overrides = yaml.safe_load(f) or {}

    canonical = {f.name.upper(): f.name for f in dataclasses.fields(base)}
    mapped = {}
    for key, value in overrides.items():
        name = canonical.get(str(key).upper())
        if name is None:
            raise ValueError(f"{key} not exist in config")
        mapped[name] = value
    return base.replace(**mapped)
