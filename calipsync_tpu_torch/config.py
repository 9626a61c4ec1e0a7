"""Configuration the port's entry points read (own copy of the serving
and training parts of calipsync_tpu/config.py), loaded from the same JSON
files.

The ``mesh`` section describes the ranks a command runs on (one process
a card, core/mesh.py): ``data``/``dcn`` for data-parallel training and
``model`` for sharded HuBERT. Sections and keys the port's entry points
do not read (``audio``, ``model.attn_impl``, ...) are accepted and
ignored, as the JAX package's commands ignore the ones they do not read.
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
class TrainConfig:
    """The JAX package's TrainConfig (calipsync_tpu/config.py:52-97), its
    fields and defaults."""

    batch_size: int = 16
    lr: float = 1e-3
    epochs: int = 20
    perceptual_weight: float = 0.1
    num_workers: int = 4               # host JPEG-decode threads
    seed: int = 0
    checkpoint_every: int = 0          # epochs; 0 = the final epoch only
    # Under data parallelism every BatchNorm takes its train-mode
    # statistics over the global batch (all ranks), as flax's
    # BatchNorm(axis_name=...); off, each rank's own rows.
    sync_batchnorm: bool = True
    # Every frame decoded once and its 160x160 crop kept on the card; a
    # step gathers crops by index. Off, or above resident_max_bytes, the
    # host decodes each batch (LipSyncDataset + Prefetcher).
    resident_data: bool = True
    resident_max_bytes: int = 4 << 30
    # K train steps a dispatch on the resident path
    # (train/trainer.py::make_resident_multi_step): on the card one CUDA
    # graph of the K steps, replayed once a (K, B) block. 1 = one step a
    # dispatch. As in the JAX package, an epoch's last n_batches % K
    # batches are dropped, and an epoch shorter than one block is
    # wrap-padded to K steps. The streaming path ignores it.
    steps_per_dispatch: int = 1
    # SIGTERM/SIGINT checkpoint the run at the next batch boundary and
    # return; resume=True redoes that epoch.
    preemption_safe: bool = True
    # Microbatches per Adam update: BN statistics per microbatch, the
    # gradients averaged.
    grad_accum: int = 1
    # Recompute the generator's activations in the backward pass.
    remat: bool = False
    # ZeRO-1: each data-parallel rank keeps the Adam moments of 1/D of
    # the parameters; the same update as the mean path
    # (train/trainer.py::Zero1Adam).
    zero1: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """The ranks a command runs on (one process a card, joined by the
    process group that torchrun or the CALIPSYNC_* variables describe;
    core/mesh.py). ``dcn == 1`` builds a 1-D ``(data,)`` mesh over the
    first ``data`` ranks (-1: all), ``dcn > 1`` (-1: one a node) the
    process-major ``(host, data)`` mesh; training shards its batch over
    every axis of it. ``model > 1`` shards HuBERT over that many ranks,
    tensor-parallel (``hubert_parallel='tp'``, core/tp.py) or pipelined
    ('pp', core/pp.py; ``pp_microbatches`` 0 = one a stage)."""

    data: int = -1
    axis_name: str = "data"
    dcn: int = 1
    dcn_axis_name: str = "host"
    model: int = 1
    model_axis_name: str = "model"
    hubert_parallel: str = "tp"
    pp_microbatches: int = 0


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
    train: TrainConfig = field(default_factory=TrainConfig)


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
    """Raise on a setting the port does not know."""
    if cfg.mesh.hubert_parallel not in ("tp", "pp"):
        raise ValueError(
            f"unknown mesh.hubert_parallel: {cfg.mesh.hubert_parallel!r}")
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
