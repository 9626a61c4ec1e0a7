"""Mouth-crop geometry of the training data and of inference (own copy of
calipsync_tpu/vision/geometry.py:32-153), pixel-exact with the reference:

  - training crop: the reference's dataset/dataset.py:73-134;
  - inference crop with boundary clamping: its
    image_infer_v1/tools/frame_synthesizer/infer_api.py:205-231.

The reference calls ``cv2.resize(img, (168, 168), cv2.INTER_AREA)``, whose
third positional argument is ``dst``, so it resizes with the default
INTER_LINEAR; so does this module. ``cv2.rectangle(img, (5, 5, 150, 145),
0, -1)`` fills rows [5, 149] and columns [5, 154], the slice
[5:150, 5:155] of :func:`mask_mouth`.
"""

from __future__ import annotations

from dataclasses import dataclass

import cv2
import numpy as np

from calipsync_tpu_torch.config import CropConfig

DEFAULT_CROP = CropConfig()


def load_landmarks(path: str) -> np.ndarray:
    """A .lms/.txt landmark file -> (N, 2) int32 (float text allowed)."""
    return np.loadtxt(path, dtype=np.float32).astype(np.int32)


_E18_CACHE: dict = {}


def _e18(v) -> str:
    """'%.18e' of a coordinate, cached for integer values: landmark
    coordinates are small ints, so formatting is a dict hit."""
    i = int(v)
    if i == v:
        s = _E18_CACHE.get(i)
        if s is None:
            s = _E18_CACHE[i] = "%.18e" % float(i)
        return s
    return "%.18e" % float(v)


def save_landmarks_txt(path: str, lms: np.ndarray,
                       fmt: str = "%.18e") -> None:
    """Write landmarks byte-equal to ``np.savetxt(path, lms, fmt)`` (own
    copy of calipsync_tpu/vision/geometry.py:54-68) for the pipelines' two
    formats, '%.18e' (step 3's positions) and '%d' (step 1's .lms), ~10x
    faster than savetxt's per-row formatting."""
    rows = np.asarray(lms)
    if fmt == "%d":
        text = "".join(f"{int(x)} {int(y)}\n" for x, y in rows)
    elif fmt == "%.18e":
        text = "".join(f"{_e18(x)} {_e18(y)}\n" for x, y in rows)
    else:
        np.savetxt(path, rows, fmt=fmt)
        return
    with open(path, "w") as f:
        f.write(text)


def mouth_bbox_train(lms: np.ndarray) -> tuple[int, int, int, int]:
    """Training-path square mouth bbox (xmin, ymin, xmax, ymax): x from
    lms[1] and lms[31], y from lms[52], the side its width; no clamping."""
    xmin = int(lms[1][0])
    ymin = int(lms[52][1])
    xmax = int(lms[31][0])
    return xmin, ymin, xmax, ymin + xmax - xmin


def crop_resize_168(img: np.ndarray, ymin: int, ymax: int, xmin: int,
                    xmax: int, cfg: CropConfig = DEFAULT_CROP) -> np.ndarray:
    """Crop the bbox and resize it to the 168x168 working square."""
    return cv2.resize(img[ymin:ymax, xmin:xmax], (cfg.resize, cfg.resize),
                      interpolation=cv2.INTER_LINEAR)


def center_160(crop168: np.ndarray,
               cfg: CropConfig = DEFAULT_CROP) -> np.ndarray:
    """168 -> its central 160 region [4:164, 4:164]."""
    m = cfg.margin
    return np.ascontiguousarray(crop168[m:cfg.resize - m, m:cfg.resize - m])


def mask_mouth(img160: np.ndarray,
               cfg: CropConfig = DEFAULT_CROP) -> np.ndarray:
    """A copy with the mouth rectangle blacked out."""
    out = img160.copy()
    out[cfg.mask_y:cfg.mask_y + cfg.mask_h,
        cfg.mask_x:cfg.mask_x + cfg.mask_w] = 0
    return out


def train_pair_uint8(img: np.ndarray, lms: np.ndarray, img_ex: np.ndarray,
                     lms_ex: np.ndarray, cfg: CropConfig = DEFAULT_CROP
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One training example's planes, uint8 HWC: (reference crop of
    img_ex, masked crop of img, target crop of img). The model input is
    concat([reference, masked]) / 255 and the label target / 255, both
    formed on the device."""
    x0, y0, x1, y1 = mouth_bbox_train(lms)
    real = center_160(crop_resize_168(img, y0, y1, x0, x1, cfg), cfg)
    ex0, ey0, ex1, ey1 = mouth_bbox_train(lms_ex)
    ref = center_160(crop_resize_168(img_ex, ey0, ey1, ex0, ex1, cfg), cfg)
    return ref, mask_mouth(real, cfg), real


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
