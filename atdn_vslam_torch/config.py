"""Typed configuration tree: frozen dataclasses and a safe-YAML loader.

The port's own copy of ``atdn_vslam_tpu/config.py`` (same sections,
same keys, same defaults), so that one YAML file configures both
packages and the port never imports the JAX package. Knobs that only
steer TPU lowerings (``wpack``, the training compute dtypes) are kept
so the files stay interchangeable; the port ignores them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml


@dataclass(frozen=True)
class FlowNetConfig:
    """GMA / RAFT flow-network knobs (ref: utils/gma_parameters.py:1-34,
    GMA/core/network.py:31-34)."""

    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    num_heads: int = 1
    iters: int = 12
    #: bfloat16 convolutions on the GPU (the reference's autocast);
    #: the CPU always computes in float32
    mixed_precision: bool = True
    #: read by the JAX package only; the port's attention always goes
    #: through its CUDA kernel on the GPU
    use_pallas_attention: bool = True
    checkpoint_path: str = ""


@dataclass(frozen=True)
class OdometryModelConfig:
    """ATDNVO knobs (ref: odometry/network.py:20-27)."""

    in_channels: int = 2
    compressor: bool = True
    use_dropout: bool = False
    use_layernorm: bool = False
    lstm_size: int = 512
    train_compute_dtype: str = "bfloat16"
    wpack: bool = True


@dataclass(frozen=True)
class MappingModelConfig:
    """MappingVAE knobs (ref: localization/network.py:10-23)."""

    variational: bool = False
    channels: tuple[int, ...] = (16, 16, 32, 64, 128, 128)
    latent_channels: int = 128
    compute_dtype: str = "bfloat16"
    wpack: bool = True


@dataclass(frozen=True)
class LossConfig:
    """CLVO loss knobs (ref: odometry/loss.py:9-22)."""

    alpha: float = 1.0
    w: int = 3
    delta: float = 1.0
    khi: float = 100.0


@dataclass(frozen=True)
class TrainConfig:
    """Odometry training loop knobs (ref: README.md:51-78)."""

    batch_size: int = 24
    sequence_length: int = 6
    epochs: int = 1
    lr: float = 1e-2
    wd: float = 1e-3
    epsilon: float = 1e-8
    eta_min: float = 1e-9
    stage: int = 1
    augment_flow: bool = True
    train_sequences: tuple[str, ...] = (
        "00", "01", "02", "03", "04", "06", "08", "09", "10",
    )
    seed: int = 4265664478


@dataclass(frozen=True)
class MappingTrainConfig:
    """Online map-building training knobs (ref: neural_slam.py:305-321)."""

    epochs: int = 50
    batch_size: int = 16
    lr: float = 1e-3
    wd: float = 1e-3
    eta_min: float = 1e-5
    seed: int = 0


@dataclass(frozen=True)
class SlamConfig:
    """Runtime knobs (ref: neural_slam.py:54,72-74)."""

    image_height: int = 376
    image_width: int = 1232
    rotation_threshold_deg: float = 10.0
    translation_threshold: float = 15.0
    max_keyframes: int = 4096
    #: start each pair's GMA iterations from the previous pair's
    #: low-res flow, forward-warped to the new frame's pixel grid
    #: (ops/bilinear.py forward_warp_flow); the first pair starts from
    #: zero flow, which is exactly the cold start
    flow_warm_start: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (read by the JAX package's parallel paths)."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class Config:
    data_path: str = "data"
    keyframes_path: str = "keyframes"
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "log"
    flow: FlowNetConfig = field(default_factory=FlowNetConfig)
    odometry: OdometryModelConfig = field(default_factory=OdometryModelConfig)
    mapping: MappingModelConfig = field(default_factory=MappingModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mapping_train: MappingTrainConfig = field(default_factory=MappingTrainConfig)
    slam: SlamConfig = field(default_factory=SlamConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


_NESTED = {
    "flow": FlowNetConfig, "odometry": OdometryModelConfig,
    "mapping": MappingModelConfig, "loss": LossConfig,
    "train": TrainConfig, "mapping_train": MappingTrainConfig,
    "slam": SlamConfig, "mesh": MeshConfig,
}


def _build(cls: type, raw: dict[str, Any]) -> Any:
    kwargs: dict[str, Any] = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for key, value in raw.items():
        if key not in names:
            raise KeyError(f"Unknown config key {key!r} for {cls.__name__}")
        if key in _NESTED and isinstance(value, dict):
            kwargs[key] = _build(_NESTED[key], value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str | None = None) -> Config:
    """Load a config from safe YAML, or return defaults when no path
    is given. Unknown keys raise ``KeyError`` naming the key."""
    if path is None:
        return Config()
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _build(Config, raw)
