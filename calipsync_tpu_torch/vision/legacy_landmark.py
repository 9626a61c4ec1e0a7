"""Legacy single-image landmark utility with eye-angle rotation
(counterpart of calipsync_tpu/vision/legacy_landmark.py).

Rebuild of the reference's utils/get_landmark.py:14-114 (unused by the
main pipeline but part of the reference's surface): detect a face, crop a
1.05x square, compute the inter-eye roll angle from detector keypoints,
rotate the crop level before PFLD, then rotate the landmarks back. PFLD
is the port's ``LipDetector``'s, on its device (the card by default), run
on the detector's worker thread as its other forwards are.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import cv2
import numpy as np


def eye_roll_angle(p_left_eye: np.ndarray, p_right_eye: np.ndarray) -> float:
    """Roll angle in degrees from the two eye keypoints."""
    return math.atan2(p_right_eye[1] - p_left_eye[1],
                      p_right_eye[0] - p_left_eye[0]) * 180.0 / math.pi


def square_crop_with_pad(img: np.ndarray, x1: int, y1: int, w: int, h: int,
                         expand: float = 1.05):
    """1.05x square crop around the bbox center, constant-border padded at
    image edges. Returns (crop, (x1, y1) offset)."""
    height, width = img.shape[:2]
    x2, y2 = x1 + w, y1 + h
    cx, cy = (x2 + x1) // 2, (y2 + y1) // 2
    size = int(max(w, h) * expand)
    x1, y1 = cx - size // 2, cy - size // 2
    x2, y2 = x1 + size, y1 + size
    dx, dy = max(0, -x1), max(0, -y1)
    x1, y1 = max(0, x1), max(0, y1)
    edx, edy = max(0, x2 - width), max(0, y2 - height)
    x2, y2 = min(width, x2), min(height, y2)
    crop = img[y1:y2, x1:x2]
    if dx or dy or edx or edy:
        crop = cv2.copyMakeBorder(crop, dy, edy, dx, edx,
                                  cv2.BORDER_CONSTANT, 0)
        x1, y1 = x1 - dx, y1 - dy
    return crop, (x1, y1)


class LegacyLandmark:
    """detect -> rotate-level -> PFLD -> rotate landmarks back.

    Args:
      lip_detector: vision.lip_detector.LipDetector (provides the PFLD
        forward via its _pfld_batch).
      keypoint_detector: an object whose ``detect_with_keypoints(img)``
        gives (bboxes_xywh, indices, (M, 5, 2) keypoints): the port's
        SCRFDDetector (cv2.dnn) or YoloV8FaceDetector (on the card).
    """

    def __init__(self, lip_detector, keypoint_detector):
        self.lip = lip_detector
        self.det = keypoint_detector

    def landmarks(self, img: np.ndarray
                  ) -> List[Tuple[np.ndarray, float]]:
        """Per detected face: ((110, 2) int32 landmarks, roll_degrees)."""
        bboxes, indices, kps = self.det.detect_with_keypoints(img)
        results = []
        for i in indices:
            x1, y1, w, h = (int(bboxes[i, 0]), int(bboxes[i, 1]),
                            int(bboxes[i, 2]), int(bboxes[i, 3]))
            crop, (ox, oy) = square_crop_with_pad(img, x1, y1, w, h)
            alpha = eye_roll_angle(kps[i, 0], kps[i, 1])
            ch, cw = crop.shape[:2]
            center = (cw // 2, ch // 2)
            rot = cv2.getRotationMatrix2D(center, alpha, 1)
            leveled = cv2.warpAffine(crop, rot, (cw, ch))

            lm = self.lip._worker.submit(self.lip._pfld_batch,
                                         [leveled]).result()[0]
            pts = (lm + self.lip.mean_face).reshape(-1, 2)
            pts[:, 0] *= cw
            pts[:, 1] *= ch
            # rotate landmarks back into the unleveled crop frame
            inv = cv2.getRotationMatrix2D(center, -alpha, 1)
            ones = np.ones((len(pts), 1), np.float64)
            pts = (np.hstack([pts, ones]) @ inv.T)
            pts[:, 0] += ox
            pts[:, 1] += oy
            results.append((pts.astype(np.int32), alpha))
        return results
