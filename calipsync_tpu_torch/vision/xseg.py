"""XSeg face-segmentation masks for step 3 (own copy of
calipsync_tpu/vision/xseg.py; the reference's generate_mask,
step3_prepare_infer_data.py:28-89, which it ships disabled):

  1. a lower-face square from the landmarks: x in [lms[1].x, lms[31].x],
     y from lms[52].y, the height equal to the width;
  2. context: +100% of the width up and to each side, +50% down, clamped
     to the frame;
  3. that crop resized to the model's 256x256, /255, through the
     segmentation net;
  4. the mask resized back to the crop, the lower-face square cut out and
     resized to the 168x168 lips_jpg grid;
  5. any out-of-range coordinate falls back to an all-ones mask.

The session is pluggable: any ``session(img (1, 256, 256, 3) float32) ->
mask`` callable, or a path to DeepFaceLab's ``xseg.onnx`` run through
OpenCV's DNN runtime. The synthesizer reads the saved masks when it
composites.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import cv2
import numpy as np


class CvDnnSession:
    """Minimal ONNX runner on cv2.dnn for NHWC single-input models."""

    def __init__(self, model_path: str):
        if not os.path.exists(model_path):
            raise FileNotFoundError(model_path)
        self.net = cv2.dnn.readNetFromONNX(model_path)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        self.net.setInput(img)
        return self.net.forward()


class XSegMaskGenerator:
    """Callable (frame, landmarks) -> (168, 168) float32 mask in [0, 1]."""

    MODEL_SIZE = (256, 256)

    def __init__(self, session: Optional[Callable] = None,
                 model_path: Optional[str] = None):
        if session is None:
            if model_path is None:
                raise ValueError("need a session or a model_path")
            session = CvDnnSession(model_path)
        self.session = session

    def __call__(self, frame: np.ndarray,
                 landmarks: np.ndarray) -> np.ndarray:
        fh, fw = frame.shape[:2]
        xmin = landmarks[1][0]
        ymin = landmarks[52][1]
        xmax = landmarks[31][0]
        width = xmax - xmin
        ymax = ymin + width  # square lower-face region

        new_xmin = max(0, int(xmin - width))
        new_ymin = max(0, int(ymin - width))
        new_xmax = min(fw, int(xmax + width))
        new_ymax = min(fh, int(ymax + width * 0.5))

        expanded = frame[new_ymin:new_ymax, new_xmin:new_xmax]
        if expanded.size == 0:
            return np.ones((168, 168), np.float32)
        resized = cv2.resize(expanded, self.MODEL_SIZE)
        inp = (resized.astype(np.float32) / 255.0)[None]

        mask = np.asarray(self.session(inp))
        if mask.ndim == 4 and mask.shape[1] == 1 and \
                mask.shape[2] == mask.shape[3]:  # NCHW runtime output
            mask = mask.transpose(0, 2, 3, 1)
        if mask.ndim == 3 and mask.shape[0] == 1 and \
                mask.shape[1] == mask.shape[2]:  # squeezed (1, H, W)
            mask = mask[0][..., None]
        elif mask.ndim == 2:  # bare (H, W)
            mask = mask[..., None]
        mask = mask.reshape(mask.shape[-3], mask.shape[-2], -1)[..., :1]
        if mask.shape[0] != mask.shape[1]:
            raise ValueError(
                f"xseg session returned an unrecognized mask layout "
                f"{mask.shape}; expected (H, W[, 1]), (1, H, W) or "
                f"NHWC/NCHW with a unit channel")
        mask = mask.clip(0.0, 1.0)
        expanded_mask = cv2.resize(
            mask, (expanded.shape[1], expanded.shape[0]))

        x1 = int(xmin - new_xmin)
        y1 = int(ymin - new_ymin)
        x2 = int(xmax - new_xmin)
        y2 = int(ymax - new_ymin)
        if (y1 < expanded_mask.shape[0] and x1 < expanded_mask.shape[1]
                and y2 <= expanded_mask.shape[0]
                and x2 <= expanded_mask.shape[1]):
            return cv2.resize(expanded_mask[y1:y2, x1:x2],
                              (168, 168)).astype(np.float32)
        return np.ones((168, 168), np.float32)
