"""Configuration the port's serving path reads (own copy of
calipsync_tpu/config.py ``CropConfig`` and the streaming head-batch
default of ``InferConfig``)."""

from __future__ import annotations

from dataclasses import dataclass


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
class InferConfig:
    # Streaming first-window head batch: the first device batch of each
    # synthesis call runs at this small padded shape so the first frame's
    # compute and copy are small, then the call continues at batch_size.
    # 0 = off. Output-identical (generation is per sample).
    first_window_batch: int = 4
