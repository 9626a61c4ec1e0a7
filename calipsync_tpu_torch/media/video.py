"""Video file output through OpenCV."""

from __future__ import annotations

import cv2


def open_video_writer(path: str, fps: int, width: int,
                      height: int) -> cv2.VideoWriter:
    """An mp4v VideoWriter, or RuntimeError when OpenCV cannot open one
    (it would otherwise drop every frame and leave an empty file)."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path!r} "
                           f"(mp4v, {width}x{height} at {fps} fps)")
    return writer
