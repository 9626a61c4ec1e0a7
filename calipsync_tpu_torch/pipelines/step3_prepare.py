"""Step 3: video -> inference assets (counterpart of
calipsync_tpu/pipelines/step3_prepare.py; the reference's
step3_prepare_infer_data.py:9-196). The layout the port's
``FrameSynthesizer`` and ``MultiStreamSynthesizer`` read:

    {out}/sample.jpg
    {out}/infer_data/frames/{i:06d}.jpg     (JPEG q95 full frames)
    {out}/infer_data/positions/{i:06d}.txt  (landmarks, '%.18e' text)
    {out}/infer_data/lips_jpg/{i:06d}.jpg   (168x168 mouth crops)
    {out}/infer_data/masks/{i:06d}.jpg      (XSeg masks, when a mask
                                             generator is given)
    {out}/srt/                              (the reference's ASR slicing
                                             hook, left empty)
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np

from calipsync_tpu_torch.data.dataset import Prefetcher
from calipsync_tpu_torch.vision.geometry import save_landmarks_txt


class InferPreprocessor:
    def __init__(self, lip_detector, batch_size: int = 32,
                 mask_generator=None):
        """mask_generator: an optional callable (frame, landmarks) ->
        (168, 168) float mask (vision/xseg.py)."""
        self.lip_detector = lip_detector
        self.batch_size = batch_size
        self.mask_generator = mask_generator

    def _write_batch(self, landmarks_list, frames, indices, infer_dir: str,
                     pool: ThreadPoolExecutor) -> None:
        write = pool.submit
        for lms, idx, frame in zip(landmarks_list, indices, frames):
            if lms is None or len(lms) == 0:
                continue
            n = str(idx).zfill(6)
            write(cv2.imwrite, os.path.join(infer_dir, "frames", f"{n}.jpg"),
                  frame, [cv2.IMWRITE_JPEG_QUALITY, 95])
            save_landmarks_txt(os.path.join(infer_dir, "positions",
                                            f"{n}.txt"), lms[0])
            lm = lms[0]
            xmin, ymin = int(lm[1][0]), int(lm[52][1])
            xmax = int(lm[31][0])
            width = xmax - xmin
            mouth = frame[ymin:ymin + width, xmin:xmax]
            if mouth.size > 0:
                write(cv2.imwrite,
                      os.path.join(infer_dir, "lips_jpg", f"{n}.jpg"),
                      cv2.resize(mouth, (168, 168)))
            if self.mask_generator is not None:
                mask = self.mask_generator(frame, lm)
                write(cv2.imwrite,
                      os.path.join(infer_dir, "masks", f"{n}.jpg"),
                      (np.clip(mask, 0, 1) * 255).astype(np.uint8))

    def process_video(self, video_path: str, output_dir: str) -> dict:
        # the detect_stride carry is valid only within one frame stream
        self.lip_detector.reset_stride()
        os.makedirs(output_dir, exist_ok=True)
        srt_dir = os.path.join(output_dir, "srt")
        os.makedirs(srt_dir, exist_ok=True)
        infer_dir = os.path.join(output_dir, "infer_data")
        for d in ("frames", "positions", "lips_jpg", "masks"):
            os.makedirs(os.path.join(infer_dir, d), exist_ok=True)

        cap = cv2.VideoCapture(video_path)
        ok, first = cap.read()
        if ok:
            cv2.imwrite(os.path.join(output_dir, "sample.jpg"), first)
        cap.release()

        cap = cv2.VideoCapture(video_path)

        def batches():
            buf, idxs, i = [], [], 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                buf.append(frame)
                idxs.append(i)
                i += 1
                if len(buf) >= self.batch_size:
                    yield buf, idxs
                    buf, idxs = [], []
            if buf:
                yield buf, idxs

        n = 0
        pf = Prefetcher(batches(), depth=2)
        pool = ThreadPoolExecutor(max_workers=4)
        inflight: deque = deque()
        try:
            for buf, idxs in pf:
                inflight.append((self.lip_detector.submit(buf), buf, idxs))
                if len(inflight) >= 2:
                    fut, b, ix = inflight.popleft()
                    self._write_batch(fut.result(), b, ix, infer_dir,
                                      pool=pool)
                    n = ix[-1] + 1
            while inflight:
                fut, b, ix = inflight.popleft()
                self._write_batch(fut.result(), b, ix, infer_dir, pool=pool)
                n = ix[-1] + 1
        finally:
            pf.close()    # stop the decode thread before releasing cap
            cap.release()
            pool.shutdown(wait=True)
        return {"infer_dir": infer_dir, "srt_dir": srt_dir,
                "processed_frames": n}
