"""LipDetector: face detection -> square crop -> PFLD landmarks (counterpart
of calipsync_tpu/vision/lip_detector.py; the reference's
utils/lip_detector/lip_detector.py:29-120).

  - PFLD runs batched over all crops of a frame batch in one forward on
    the card (the reference runs one crop at a time), the batch padded to
    a power of 2; uint8 crops go up and are divided by 255 there.
  - PFLD takes the deploy form (``nn.pfld.fold_mobileone``).
  - Every detector and PFLD forward of one LipDetector runs on its own
    long-lived worker thread (:meth:`submit`): PyTorch caches cuDNN's
    execution plans per host thread, so a fresh thread a video would
    build them again.

The crop geometry is the reference's exactly: a square 1.05x max(w, h)
box around the detection's center, constant-border padded where it
leaves the image, resized to 192; landmarks = (pfld(crop) + mean_face) *
(w, h) + offset. All images are BGR uint8.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import cv2
import numpy as np
import torch

from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.pfld import PFLDGhostOne

PFLD_SIZE = 192


def load_mean_face(path: str) -> np.ndarray:
    """mean_face.txt: 220 whitespace-separated floats."""
    with open(path) as f:
        return np.asarray(f.read().split(), dtype=np.float32)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class LipDetector:
    def __init__(self, pfld_state_dict: dict, mean_face: np.ndarray,
                 face_detector, detect_stride: int = 1,
                 device: str | torch.device | None = None):
        """
        Args:
          pfld_state_dict: deploy-form (folded) PFLD weights, loaded
            strictly.
          mean_face: (220,) normalized mean landmark vector.
          face_detector: an object with ``detect(images) -> [(bboxes_xywh,
            indices)]`` (S3FDDetector, YoloV8FaceDetector or any other).
          detect_stride: run the face detector on every Nth frame of a
            sequential stream and reuse the previous detection's boxes in
            between; PFLD still runs on every frame. Valid only when
            ``detect_landmarks`` is fed frames in video order.
          device: 'cuda' (default; raises without a GPU) or 'cpu'.
        """
        self.device = resolve_device(device)
        self.mean_face = mean_face.astype(np.float32)
        self.detector = face_detector
        self.detect_stride = max(1, int(detect_stride))
        self._stride_carry = None  # last (bboxes, indices) seen
        self._stride_phase = 0     # frames since that detection
        model = PFLDGhostOne(deploy=True)
        model.load_state_dict(pfld_state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="calipsync-lip")

    def submit(self, images: Sequence[np.ndarray]) -> Future:
        """:meth:`detect_landmarks` on this detector's worker thread."""
        return self._worker.submit(self.detect_landmarks, images)

    def close(self) -> None:
        self._worker.shutdown(wait=True)

    def reset_stride(self) -> None:
        """Drop the carried ``detect_stride`` state (call between videos:
        the carry is valid only within one sequential frame stream)."""
        self._stride_carry = None
        self._stride_phase = 0

    def _detections(self, images: Sequence[np.ndarray]):
        """Detector results per image, honouring ``detect_stride``."""
        stride = self.detect_stride
        if not len(images):
            return []
        if stride <= 1:
            return self.detector.detect(images)
        need = [i for i in range(len(images))
                if (self._stride_phase + i) % stride == 0]
        if self._stride_carry is None and (not need or need[0] != 0):
            need.insert(0, 0)
        fresh = (self.detector.detect([images[i] for i in need])
                 if need else [])
        out, j = [], 0
        for i in range(len(images)):
            if j < len(need) and i == need[j]:
                self._stride_carry = fresh[j]
                j += 1
            out.append(self._stride_carry)
        self._stride_phase = (self._stride_phase + len(images)) % stride
        return out

    def _face_det(self, images: Sequence[np.ndarray]):
        """The reference's crop logic (lip_detector.py:29-80),
        pixel-exact."""
        detections = self._detections(images)
        crops_list, offsets_list = [], []
        for img, (bboxes, indices) in zip(images, detections):
            crops, offsets = [], []
            height, width = img.shape[:2]
            for i in indices:
                x1, y1 = int(bboxes[i, 0]), int(bboxes[i, 1])
                w, h = int(bboxes[i, 2]), int(bboxes[i, 3])
                x2, y2 = x1 + w, y1 + h
                cx, cy = (x2 + x1) // 2, (y2 + y1) // 2
                size = int(max(w, h) * 1.05)
                x1, y1 = cx - size // 2, cy - size // 2
                x2, y2 = x1 + size, y1 + size
                dx, dy = max(0, -x1), max(0, -y1)
                x1, y1 = max(0, x1), max(0, y1)
                edx, edy = max(0, x2 - width), max(0, y2 - height)
                x2, y2 = min(width, x2), min(height, y2)
                cropped = img[y1:y2, x1:x2]
                if dx > 0 or dy > 0 or edx > 0 or edy > 0:
                    cropped = cv2.copyMakeBorder(
                        cropped, dy, edy, dx, edx, cv2.BORDER_CONSTANT, 0)
                    y1, x1 = y1 - dy, x1 - dx
                crops.append(cropped)
                offsets.append((x1, y1))
            crops_list.append(crops)
            offsets_list.append(offsets)
        return crops_list, offsets_list

    @torch.inference_mode()
    def _pfld_batch(self, crops: List[np.ndarray]) -> np.ndarray:
        """All crops -> (N, 220) in one padded forward."""
        n = len(crops)
        batch = np.zeros((_bucket(n), PFLD_SIZE, PFLD_SIZE, 3), np.uint8)
        for i, c in enumerate(crops):
            batch[i] = cv2.resize(c, (PFLD_SIZE, PFLD_SIZE))
        x = torch.from_numpy(batch).to(self.device).float() / 255.0
        return self.model(x)[:n].cpu().numpy()

    def detect_landmarks(self, images: Sequence[np.ndarray]
                         ) -> List[Optional[List[np.ndarray]]]:
        """Per image: a list of (110, 2) int32 landmark arrays, or None."""
        crops_list, offsets_list = self._face_det(images)

        flat_crops, owners = [], []
        for img_i, crops in enumerate(crops_list):
            for c in crops:
                flat_crops.append(c)
                owners.append(img_i)

        results: List[Optional[List[np.ndarray]]] = [
            None if not crops else [] for crops in crops_list]
        if not flat_crops:
            return results

        landmarks = self._pfld_batch(flat_crops)

        flat_offsets = [o for offs in offsets_list for o in offs]
        flat_sizes = [(c.shape[1], c.shape[0]) for c in flat_crops]
        for lm, img_i, (ox, oy), (w, h) in zip(landmarks, owners,
                                               flat_offsets, flat_sizes):
            pre = (lm + self.mean_face).reshape(-1, 2).copy()
            pre[:, 0] = pre[:, 0] * w + ox
            pre[:, 1] = pre[:, 1] * h + oy
            if not np.isfinite(pre).all():
                # a non-finite output would cast to INT_MIN coordinates;
                # dropping the face routes it into the no-detection
                # fallbacks (gap fill, last good detection)
                continue
            # clamp to a float32-exact int32 subrange: casting a finite
            # float beyond int32 is undefined
            pre = np.clip(pre, -2**30, 2**30)
            results[img_i].append(pre.astype(np.int32))
        for i, r in enumerate(results):
            if r == []:  # every face dropped: the same as none
                results[i] = None
        return results
