"""Inference-path mouth-crop geometry (own copy of
calipsync_tpu/vision/geometry.py ``CropParams`` and ``mouth_bbox_infer``),
reproducing the reference's boundary clamping
(the reference's image_infer_v1/tools/frame_synthesizer/infer_api.py:205-231).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CropParams:
    """Clamped crop region; ``width`` is the pre-clamp square side used for
    the paste-back resize (frame_synthesizer/infer_api.py:250,277)."""

    ymin: int
    ymax: int
    xmin: int
    xmax: int
    width: int


def mouth_bbox_infer(lms: np.ndarray, img_h: int, img_w: int) -> CropParams:
    """Square mouth bbox from landmarks 1, 31 and 52, clamped to the image
    as the reference does."""
    xmin = int(lms[1][0])
    ymin = int(lms[52][1])
    xmax = int(lms[31][0])
    width = xmax - xmin
    ymax = ymin + width

    if ymax > img_h:
        diff = ymax - img_h
        ymax = img_h
        ymin = max(0, ymin - diff)
    if ymin < 0:
        ymax = min(img_h, ymax - ymin)
        ymin = 0
    xmin = max(xmin, 0)
    xmax = min(xmax, img_w)
    return CropParams(ymin, ymax, xmin, xmax, width)
