"""Face detector backends behind the common ``detect(images)`` interface
(counterpart of calipsync_tpu/vision/detectors.py; the reference keeps the
detector pluggable, utils/lip_detector/lip_detector.py:21-22):

  - S3FD (nn/s3fd.py) and the native YOLOv8n-face (nn/yolo.py), both on
    the card, re-exported here;
  - the ultralytics YOLOv8-face adapter, the reference's own runtime
    (utils/lip_detector/tools/detect_face_yolo.py), where ``ultralytics``
    is installed; it is imported only when the adapter is built;
  - SCRFD, an anchor-based ONNX detector run by cv2.dnn on the host
    (reference utils/detect_face.py:6-106), FPN strides 8/16/32, 2
    anchors a cell.

All return ``[(bboxes_xywh float array, indices list)]`` per image, with
the last-good-detection fallback the pipelines rely on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from calipsync_tpu_torch.nn.s3fd import S3FDDetector, nms_np  # noqa: F401
from calipsync_tpu_torch.nn.yolo import YoloV8FaceDetector  # noqa: F401

Detection = Tuple[np.ndarray, list]


class YoloFaceDetector:
    """ultralytics YOLOv8n-face adapter (reference detect_face_yolo.py).

    Requires the optional ``ultralytics`` package + a yolov8n-face.pt
    checkpoint; raises a clear error otherwise.
    """

    def __init__(self, weight_path: str, conf_threshold: float = 0.5):
        try:
            from ultralytics import YOLO  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "YoloFaceDetector requires the 'ultralytics' package; use "
                "S3FDDetector (in-repo) instead") from e
        self.model = YOLO(weight_path)
        self.conf_threshold = conf_threshold
        self.last_detection: Optional[Detection] = None

    def detect(self, images: Sequence[np.ndarray]) -> List[Detection]:
        results = self.model(list(images), conf=self.conf_threshold,
                             verbose=False)
        out: List[Detection] = []
        for res in results:
            boxes = res.boxes.xyxy.cpu().numpy() if len(res.boxes) else \
                np.zeros((0, 4))
            if len(boxes) == 0:
                out.append(self.last_detection
                           if self.last_detection is not None
                           else (np.array([]), []))
                continue
            xywh = np.column_stack([boxes[:, :2],
                                    boxes[:, 2:4] - boxes[:, :2]])
            current = (xywh, list(range(len(boxes))))
            self.last_detection = current
            out.append(current)
        return out


class SCRFDDetector:
    """SCRFD ONNX face detector via cv2.dnn (reference utils/detect_face.py:
    6-106): 640x640 letterboxed input, FPN strides (8, 16, 32), 2 anchors
    per cell, distance-to-bbox decode, score threshold + NMS."""

    STRIDES = (8, 16, 32)
    NUM_ANCHORS = 2
    INPUT = 640

    def __init__(self, onnx_path: str, conf_threshold: float = 0.5,
                 nms_threshold: float = 0.4):
        import cv2

        self.net = cv2.dnn.readNetFromONNX(onnx_path)
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.last_detection: Optional[Detection] = None
        self._cv2 = cv2

    def _anchor_centers(self, h: int, w: int, stride: int) -> np.ndarray:
        ys, xs = np.mgrid[:h, :w]
        centers = np.stack([xs, ys], axis=-1).reshape(-1, 2) * stride
        return np.repeat(centers, self.NUM_ANCHORS, axis=0).astype(
            np.float32)

    def _detect_single(self, img: np.ndarray) -> np.ndarray:
        cv2 = self._cv2
        h0, w0 = img.shape[:2]
        scale = self.INPUT / max(h0, w0)
        resized = cv2.resize(img, (int(w0 * scale), int(h0 * scale)))
        canvas = np.zeros((self.INPUT, self.INPUT, 3), np.uint8)
        canvas[:resized.shape[0], :resized.shape[1]] = resized

        blob = cv2.dnn.blobFromImage(canvas, 1.0 / 128.0,
                                     (self.INPUT, self.INPUT),
                                     (127.5, 127.5, 127.5), swapRB=True)
        self.net.setInput(blob)
        outs = self.net.forward(self.net.getUnconnectedOutLayersNames())

        dets = []
        n_levels = len(self.STRIDES)
        for i, stride in enumerate(self.STRIDES):
            scores = outs[i].reshape(-1)
            bbox = outs[i + n_levels].reshape(-1, 4) * stride
            fh = fw = self.INPUT // stride
            centers = self._anchor_centers(fh, fw, stride)
            keep = scores > self.conf_threshold
            if not keep.any():
                continue
            c = centers[keep]
            d = bbox[keep]
            boxes = np.stack([c[:, 0] - d[:, 0], c[:, 1] - d[:, 1],
                              c[:, 0] + d[:, 2], c[:, 1] + d[:, 3]],
                             axis=1) / scale
            dets.append(np.column_stack([boxes, scores[keep]]))
        if not dets:
            return np.empty((0, 5), np.float32)
        dets = np.concatenate(dets, axis=0)
        return dets[nms_np(dets, self.nms_threshold)]

    def detect(self, images: Sequence[np.ndarray]) -> List[Detection]:
        out: List[Detection] = []
        for img in images:
            dets = self._detect_single(img)
            if len(dets) == 0:
                out.append(self.last_detection
                           if self.last_detection is not None
                           else (np.array([]), []))
                continue
            xywh = np.column_stack([dets[:, :2], dets[:, 2:4] - dets[:, :2]])
            current = (xywh, list(range(len(dets))))
            self.last_detection = current
            out.append(current)
        return out

    def _resize_keep_ratio(self, srcimg: np.ndarray):
        """Reference resize_image (utils/detect_face.py:17-34): aspect-kept
        resize + CENTERED constant-border pad to 640x640."""
        cv2 = self._cv2
        inp = self.INPUT
        padh, padw, newh, neww = 0, 0, inp, inp
        if srcimg.shape[0] != srcimg.shape[1]:
            hw_scale = srcimg.shape[0] / srcimg.shape[1]
            if hw_scale > 1:
                newh, neww = inp, int(inp / hw_scale)
                img = cv2.resize(srcimg, (neww, newh),
                                 interpolation=cv2.INTER_AREA)
                padw = int((inp - neww) * 0.5)
                img = cv2.copyMakeBorder(img, 0, 0, padw, inp - neww - padw,
                                         cv2.BORDER_CONSTANT, value=0)
            else:
                newh, neww = int(inp * hw_scale) + 1, inp
                img = cv2.resize(srcimg, (neww, newh),
                                 interpolation=cv2.INTER_AREA)
                padh = int((inp - newh) * 0.5)
                img = cv2.copyMakeBorder(img, padh, inp - newh - padh, 0, 0,
                                         cv2.BORDER_CONSTANT, value=0)
        else:
            img = cv2.resize(srcimg, (inp, inp),
                             interpolation=cv2.INTER_AREA)
        return img, newh, neww, padh, padw

    def detect_with_keypoints(self, img: np.ndarray):
        """Full reference SCRFD decode incl. the 5-point keypoint heads
        (utils/detect_face.py:57-106): returns (bboxes_xywh (N,4), kept
        indices, keypoints (N,5,2)) in source-image coordinates. This is
        what LegacyLandmark's eye-roll path consumes
        (utils/get_landmark.py:21-57)."""
        cv2 = self._cv2
        resized, newh, neww, padh, padw = self._resize_keep_ratio(img)
        blob = cv2.dnn.blobFromImage(resized, 1.0 / 128.0,
                                     (self.INPUT, self.INPUT),
                                     (127.5, 127.5, 127.5), swapRB=True)
        self.net.setInput(blob)
        outs = self.net.forward(self.net.getUnconnectedOutLayersNames())
        return decode_scrfd_with_keypoints(
            outs, img.shape[:2], newh, neww, padh, padw,
            self.conf_threshold, self.nms_threshold,
            strides=self.STRIDES, num_anchors=self.NUM_ANCHORS,
            input_size=self.INPUT)


def _distance2bbox(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """Anchor-center + 4 distances -> xyxy (reference distance2bbox)."""
    return np.stack([points[:, 0] - distance[:, 0],
                     points[:, 1] - distance[:, 1],
                     points[:, 0] + distance[:, 2],
                     points[:, 1] + distance[:, 3]], axis=-1)


def _distance2kps(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """Anchor-center + 2K offsets -> (N, 2K) keypoints (reference
    distance2kps: x offsets add center x, y offsets add center y)."""
    preds = []
    for i in range(0, distance.shape[1], 2):
        preds.append(points[:, i % 2] + distance[:, i])
        preds.append(points[:, i % 2 + 1] + distance[:, i + 1])
    return np.stack(preds, axis=-1)


def decode_scrfd_with_keypoints(outs, src_hw, newh, neww, padh, padw,
                                conf_threshold, nms_threshold,
                                strides=(8, 16, 32), num_anchors=2,
                                input_size=640):
    """Pure decode of SCRFD raw head outputs -> (bboxes_xywh, indices,
    kpss), matching the reference's utils/detect_face.py:66-106, including
    the centered-pad un-mapping and cv2.dnn.NMSBoxes. Split out from the
    network forward so the math is unit-testable without the ONNX model."""
    import cv2

    fmc = len(strides)
    scores_list, bboxes_list, kpss_list = [], [], []
    for idx, stride in enumerate(strides):
        scores = np.asarray(outs[idx]).reshape(-1)
        bbox_preds = np.asarray(outs[idx + fmc]).reshape(-1, 4) * stride
        kps_preds = np.asarray(outs[idx + fmc * 2])
        kps_preds = kps_preds.reshape(len(scores), -1) * stride
        height = width = input_size // stride
        centers = np.stack(np.mgrid[:height, :width][::-1],
                           axis=-1).astype(np.float32)
        centers = (centers * stride).reshape(-1, 2)
        if num_anchors > 1:
            centers = np.stack([centers] * num_anchors,
                               axis=1).reshape(-1, 2)
        pos = np.where(scores >= conf_threshold)[0]
        bboxes = _distance2bbox(centers, bbox_preds)
        kpss = _distance2kps(centers, kps_preds)
        kpss = kpss.reshape((kpss.shape[0], -1, 2))
        scores_list.append(scores[pos])
        bboxes_list.append(bboxes[pos])
        kpss_list.append(kpss[pos])

    scores = np.hstack(scores_list)
    bboxes = np.vstack(bboxes_list)
    kpss = np.vstack(kpss_list) if len(scores) else \
        np.zeros((0, 5, 2), np.float32)
    if len(scores) == 0:
        return np.zeros((0, 4), np.float32), [], kpss
    bboxes[:, 2:4] = bboxes[:, 2:4] - bboxes[:, 0:2]
    ratioh, ratiow = src_hw[0] / newh, src_hw[1] / neww
    bboxes[:, 0] = (bboxes[:, 0] - padw) * ratiow
    bboxes[:, 1] = (bboxes[:, 1] - padh) * ratioh
    bboxes[:, 2] = bboxes[:, 2] * ratiow
    bboxes[:, 3] = bboxes[:, 3] * ratioh
    kpss[:, :, 0] = (kpss[:, :, 0] - padw) * ratiow
    kpss[:, :, 1] = (kpss[:, :, 1] - padh) * ratioh
    indices = cv2.dnn.NMSBoxes(bboxes.tolist(), scores.tolist(),
                               conf_threshold, nms_threshold)
    indices = list(np.asarray(indices).reshape(-1))
    return bboxes, indices, kpss
