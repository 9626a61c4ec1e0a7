"""Step 1: video -> training data directory (counterpart of
calipsync_tpu/pipelines/step1_preprocess.py; the reference's
step1_data_preprocess.py:14-251). The layout the dataset and trainer
read:

    {out}/aud.wav            16 kHz mono audio
    {out}/aud_hu.npy         (T/2, 2, hidden) HuBERT features
    {out}/full_body_img/{i}.jpg
    {out}/landmarks/{i}.lms  (110, 2) int landmarks
    {out}/faces/{i}.jpg      160x160 mouth crops (for inspection)

Frames decode with cv2.VideoCapture and stay BGR. Decoding runs a batch
ahead on a ``Prefetcher`` thread; detection and landmarks run a batch
ahead on the lip detector's own worker thread (``LipDetector.submit``),
the same thread for every video, because PyTorch caches cuDNN's plans per
host thread; JPEG writes go to a pool. The silence gate is the mean
frame RMS in dB, as librosa.feature.rms (reference :183-188): below
``min_db`` it raises.
"""

from __future__ import annotations

import os
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import cv2
import numpy as np

from calipsync_tpu_torch.audio.io import (extract_wav, have_ffmpeg,
                                          load_audio, save_wav)
from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.data.dataset import Prefetcher
from calipsync_tpu_torch.vision.geometry import (center_160, crop_resize_168,
                                                 save_landmarks_txt)


def frame_rms_db(audio: np.ndarray, frame_length: int = 2048,
                 hop_length: int = 512) -> float:
    """Mean of the framed RMS in dB (librosa.feature.rms, centered)."""
    x = np.pad(audio.astype(np.float64), (frame_length // 2,
                                          frame_length // 2))
    n = 1 + (len(x) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n)[:, None])
    rms = np.sqrt(np.mean(np.square(x[idx]), axis=1))
    mean_rms = float(np.mean(rms))
    return 20.0 * np.log10(mean_rms) if mean_rms > 0 else -100.0


class TrainPreprocessor:
    def __init__(self, lip_detector, hubert_extractor,
                 batch_size: int = 64, crop: CropConfig = CropConfig(),
                 min_db: float = -150.0, long_audio: str = "auto"):
        """
        Args:
          lip_detector: vision.lip_detector.LipDetector (every forward on
            its own worker thread, through ``submit``)
          hubert_extractor: audio.hubert_pipeline.HubertFeatureExtractor
          long_audio: which HuBERT path featurizes the clip: 'auto' (one
            pass up to one 20 s chunk, the chunked path beyond; the
            default), 'one_pass' (the whole clip in one forward, as the
            reference does; attention is quadratic in the clip's length,
            and the longest clip one card takes is in PERF.md) or
            'chunked' (always the chunked path).
        """
        self.lip_detector = lip_detector
        self.hubert = hubert_extractor
        self.batch_size = batch_size
        self.crop = crop
        self.min_db = min_db
        if long_audio not in ("auto", "one_pass", "chunked"):
            raise ValueError(f"unknown long_audio mode: {long_audio}")
        self.long_audio = long_audio

    def _frame_batches(self, video_path: str):
        cap = cv2.VideoCapture(video_path)
        buf = []
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                buf.append(frame)
                if len(buf) >= self.batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf
        finally:
            cap.release()

    def fix_missing_landmarks(self, output_dir: str) -> None:
        """Copy the nearest existing .lms into every gap, the previous
        frame first (reference :119-159)."""
        lms_dir = os.path.join(output_dir, "landmarks")
        frames = os.listdir(os.path.join(output_dir, "full_body_img"))
        if not frames:
            return
        max_frame = max(int(f.split(".")[0]) for f in frames)
        for i in range(max_frame + 1):
            path = os.path.join(lms_dir, f"{i}.lms")
            if os.path.exists(path):
                continue
            ref = None
            prev_i, next_i = i - 1, i + 1
            while prev_i >= 0 or next_i <= max_frame:
                if prev_i >= 0:
                    c = os.path.join(lms_dir, f"{prev_i}.lms")
                    if os.path.exists(c):
                        ref = c
                        break
                if next_i <= max_frame:
                    c = os.path.join(lms_dir, f"{next_i}.lms")
                    if os.path.exists(c):
                        ref = c
                        break
                prev_i -= 1
                next_i += 1
            if ref:
                shutil.copy2(ref, path)

    def _audio(self, video_path: str, output_dir: str,
               audio_path: Optional[str]) -> None:
        out_wav = os.path.join(output_dir, "aud.wav")
        if audio_path is None:
            side_car = os.path.splitext(video_path)[0] + ".wav"
            if os.path.exists(side_car):
                audio_path = side_car
            elif have_ffmpeg():
                extract_wav(video_path, out_wav)
                audio_path = out_wav
            else:
                raise RuntimeError(
                    "no ffmpeg on host: provide audio_path= or a .wav "
                    "side-car next to the video")
        audio = load_audio(audio_path, 16_000)
        if os.path.abspath(audio_path) != os.path.abspath(out_wav):
            save_wav(out_wav, audio, 16_000)
        if frame_rms_db(audio) < self.min_db:
            raise RuntimeError("audio level too low: no speaker detected")

        h = self.hubert
        extract = {"auto": getattr(h, "extract_auto", h.extract),
                   "one_pass": h.extract,
                   "chunked": getattr(h, "extract_features", h.extract),
                   }[self.long_audio]
        np.save(os.path.join(output_dir, "aud_hu.npy"), extract(audio))

    def process_video(self, video_path: str, output_dir: str,
                      audio_path: Optional[str] = None) -> dict:
        """``audio_path``: a wav with the video's audio. cv2 cannot demux
        audio, so without it a .wav side-car next to the video is read,
        else the track is extracted (PCM natively, other codecs with
        ffmpeg)."""
        # the detect_stride carry is valid only within one frame stream
        self.lip_detector.reset_stride()
        os.makedirs(output_dir, exist_ok=True)
        for d in ("landmarks", "faces", "full_body_img"):
            os.makedirs(os.path.join(output_dir, d), exist_ok=True)
        self._audio(video_path, output_dir, audio_path)

        start = time.time()
        total = 0
        pool = ThreadPoolExecutor(max_workers=16)
        pf = Prefetcher(self._frame_batches(video_path), depth=2)
        inflight: deque = deque()

        def handle(batch, indices, landmarks_list):
            for i, frame, lms in zip(indices, batch, landmarks_list):
                if lms is None or len(lms) == 0:
                    continue
                lm = lms[0]
                save_landmarks_txt(
                    os.path.join(output_dir, "landmarks", f"{i}.lms"),
                    lm, fmt="%d")
                xmin, ymin = int(lm[1][0]), int(lm[52][1])
                xmax = int(lm[31][0])
                ymax = ymin + (xmax - xmin)
                face = frame[ymin:ymax, xmin:xmax]
                if face.size > 0:
                    face = center_160(
                        crop_resize_168(frame, ymin, ymax, xmin, xmax,
                                        self.crop), self.crop)
                    pool.submit(cv2.imwrite,
                                os.path.join(output_dir, "faces",
                                             f"{i}.jpg"), face)

        try:
            for batch in pf:
                indices = list(range(total, total + len(batch)))
                for i, frame in zip(indices, batch):
                    pool.submit(cv2.imwrite,
                                os.path.join(output_dir, "full_body_img",
                                             f"{i}.jpg"), frame)
                inflight.append((self.lip_detector.submit(batch), batch,
                                 indices))
                if len(inflight) >= 2:
                    fut, b, ix = inflight.popleft()
                    handle(b, ix, fut.result())
                total += len(batch)
            while inflight:
                fut, b, ix = inflight.popleft()
                handle(b, ix, fut.result())
        finally:
            pf.close()    # joins the decode thread, then releases capture
            pool.shutdown(wait=True)

        self.fix_missing_landmarks(output_dir)
        return {"total_frames": total,
                "process_time": time.time() - start,
                "output_dir": output_dir}
