"""Configuration the port's entry points read (own copy of the serving
part of calipsync_tpu/config.py), loaded from the same JSON files.

A setting the port cannot honour yet raises when the config is loaded:
``mesh.model > 1`` (sharded HuBERT), ``mesh.dcn != 1`` (a host axis).
Sections and keys the port's entry points do not read (``train``,
``audio``, ``mesh.data``, ``model.attn_impl``, ...) are accepted and
ignored, as the JAX package's infer and serve commands ignore them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class CropConfig:
    """Mouth-crop geometry (reference: dataset/dataset.py:83-98)."""

    resize: int = 168          # square resize of the raw mouth bbox
    margin: int = 4            # center crop [margin : resize - margin]
    size: int = 160            # model input resolution
    mask_x: int = 5            # cv2.rectangle((5, 5, 150, 145)) semantics:
    mask_y: int = 5            # rows [y, y+h-1], cols [x, x+w-1] filled black
    mask_w: int = 150
    mask_h: int = 145


@dataclass(frozen=True)
class ModelConfig:
    n_channels: int = 6
    mode: str = "hubert"               # 'hubert' | 'wenet'
    n_blocks: int = 4
    dtype: str = "float32"             # compute dtype: 'float32'|'bfloat16'


@dataclass(frozen=True)
class MeshConfig:
    """The port serves on one card: ``model`` (sharded HuBERT) and
    ``dcn`` (a host axis) must stay 1. The JAX package's other mesh keys
    are ignored, as every key the port does not read."""

    dcn: int = 1
    model: int = 1


@dataclass(frozen=True)
class InferConfig:
    batch_size: int = 8
    fps: int = 25
    buffer_threshold_s: float = 1.0    # streaming synthesis window
    motion_min_pct: int = 5            # ping-pong segment length, % of total
    motion_max_pct: int = 15
    # 'bgr' (reference-exact uint8 crops), 'yuv420' (planar I420 packed on
    # the device, half the bytes) or 'adaptive' (default): each call's
    # measured fps feeds a table and the next call takes the faster
    # format (FrameSynthesizer._choose_call_format)
    transfer_format: str = "adaptive"
    # Streaming first-window head batch: the first device batch of each
    # synthesis call runs at this small padded shape so the first frame's
    # compute and copy are small, then the call continues at batch_size.
    # 0 = off. Output-identical (generation is per sample).
    first_window_batch: int = 4


@dataclass(frozen=True)
class PipelineConfig:
    crop: CropConfig = field(default_factory=CropConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    infer: InferConfig = field(default_factory=InferConfig)


def _from_dict(cls, data: dict) -> Any:
    # resolved hints: under `from __future__ import annotations` f.type is
    # a string, and a section would otherwise stay a plain dict
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(hints[f.name]) and isinstance(v, dict):
            v = _from_dict(hints[f.name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _check_supported(cfg: PipelineConfig) -> PipelineConfig:
    """Raise on a setting the port cannot honour yet."""
    if cfg.mesh.model > 1:
        raise NotImplementedError(
            f"mesh.model={cfg.mesh.model}: sharded HuBERT is not ported "
            "yet (ROADMAP.md A.3, mesh serving and mesh HuBERT); the "
            "port runs HuBERT on one card")
    if cfg.mesh.dcn != 1:
        raise NotImplementedError(
            f"mesh.dcn={cfg.mesh.dcn}: multi-host meshes are not ported "
            "yet (ROADMAP.md A.8, multi-GPU)")
    if cfg.model.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown model.dtype: {cfg.model.dtype!r}")
    return cfg


def load_config(path: str | pathlib.Path | None = None,
                overrides: Optional[dict] = None) -> PipelineConfig:
    """Load a PipelineConfig from JSON, with optional nested overrides."""
    data: dict = {}
    if path is not None:
        data = json.loads(pathlib.Path(path).read_text())
    if overrides:
        def merge(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v
        merge(data, overrides)
    return _check_supported(_from_dict(PipelineConfig, data))
