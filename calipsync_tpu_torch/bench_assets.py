"""Synthetic speaker assets for benchmarks and smoke runs (own copy of
``make_synthetic_speaker`` in the repository's root bench.py), so a run
of the port needs nothing outside this package."""

import os

import cv2
import numpy as np


def make_synthetic_speaker(root: str, n_frames: int = 40,
                           res: int = 480, res_w: int = None,
                           seed: int = 42) -> str:
    """Synthetic step3 assets: structured frames (gradient background +
    face ellipse + mild texture) that compress and decode like real video
    frames — random noise would make JPEG decode pathologically slow and
    large. ``res`` is the frame height, ``res_w`` the width (default
    square)."""
    h, w = res, res_w or res
    infer = os.path.join(root, "infer_data")
    for d in ("frames", "positions", "lips_jpg", "masks"):
        os.makedirs(os.path.join(infer, d), exist_ok=True)
    rng = np.random.default_rng(seed)

    yy = np.linspace(40, 200, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 55, w, dtype=np.float32)[None, :]
    ch = yy + xx
    base = np.stack([ch, np.broadcast_to(yy * 0.8 + 30, ch.shape),
                     np.broadcast_to(230 - xx, ch.shape)], -1)

    for i in range(n_frames):
        img = base + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
        img = np.clip(img, 0, 255).astype(np.uint8)
        xmin = w // 4 + int(rng.integers(-8, 8))
        width = w // 3 + int(rng.integers(-10, 10))
        ymin = h // 2 + int(rng.integers(-8, 8))
        cx, cy = xmin + width // 2, ymin + width // 2
        cv2.ellipse(img, (cx, cy), (width // 2, int(width * 0.6)),
                    0, 0, 360, (150, 170, 210), -1)
        cv2.ellipse(img, (cx, cy + width // 4), (width // 5, width // 8),
                    0, 0, 360, (90, 90, 160), -1)
        n = str(i).zfill(6)
        cv2.imwrite(os.path.join(infer, "frames", f"{n}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        lms = np.zeros((110, 2), np.int64)
        theta = np.linspace(0, 2 * np.pi, 33, endpoint=False)
        lms[:33, 0] = (cx + 0.45 * width * np.cos(theta)).astype(np.int64)
        lms[:33, 1] = (cy + 0.45 * width * np.sin(theta)).astype(np.int64)
        lms[33:] = rng.integers(xmin, xmin + width, (77, 2))
        lms[1] = (xmin, cy)
        lms[31] = (xmin + width, cy)
        lms[52] = (cx, ymin)
        np.savetxt(os.path.join(infer, "positions", f"{n}.txt"), lms)
    return infer
