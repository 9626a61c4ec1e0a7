"""Video normalization: center-crop to portrait ratio + resize (the
port's own copy of calipsync_tpu/vision/normalize.py).

Rebuild of the reference's utils/video_preprocess.py:5-89 (the standalone
9:16 / 720x1280 normalizer whose caller is commented out at
all_pipeline.py:6,78-80 — shipped here as a usable utility).
"""

from __future__ import annotations

import os

import cv2
import numpy as np


def crop_to_portrait(frame: np.ndarray,
                     target_ratio: float = 9 / 16) -> np.ndarray:
    """Center-crop to the target aspect ratio (width/height)."""
    height, width = frame.shape[:2]
    current = width / height
    if current > target_ratio:
        new_width = int(height * target_ratio)
        margin = (width - new_width) // 2
        return frame[:, margin:margin + new_width]
    if current < target_ratio:
        new_height = int(width / target_ratio)
        margin = (height - new_height) // 2
        return frame[margin:margin + new_height, :]
    return frame


def process_frame(frame: np.ndarray, target_width: int = 720,
                  target_height: int = 1280) -> np.ndarray:
    """Crop to ratio (with 1% tolerance) and resize."""
    height, width = frame.shape[:2]
    target_ratio = target_width / target_height
    if abs(width / height - target_ratio) > 0.01:
        frame = crop_to_portrait(frame, target_ratio)
    return cv2.resize(frame, (target_width, target_height))


def extract_frames(video_path: str, frames_save_folder: str,
                   target_width: int = 720,
                   target_height: int = 1280) -> int:
    """Decode a video into normalized per-frame .npy files; returns count."""
    os.makedirs(frames_save_folder, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            np.save(os.path.join(frames_save_folder, f"{idx}.npy"),
                    process_frame(frame, target_width, target_height))
            idx += 1
    finally:
        cap.release()
    return idx
