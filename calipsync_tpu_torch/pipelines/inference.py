"""Offline inference: audio file -> lip-synced video file (counterpart of
calipsync_tpu/pipelines/inference.py; the reference's inference.py batch
VideoStreamManager).

HuBERT features from the audio (the chunked long-audio path), frames from
infer/synthesizer.py, cv2.VideoWriter at 25 fps, then the source audio
muxed in (audio/io.py).

The reference runs the phases in sequence: extract all features, then
synthesize all frames, each handed to the encode thread. That is the
default here. ``pipelined=True`` overlaps HuBERT featurization (a worker
thread) with synthesis too; on the H100 it shortened neither the wall
time nor ``ttff_s`` of a 65 s file, both bound by the mp4v encode
(PERF.md §6, PR 4), so it stays opt-in. Both model threads launch on the
card's default stream, so their device work serializes; what overlaps is
the host work around it. The frames are bit-identical to the sequential
path's: synthesis spans are multiples of the synthesizer batch (the
ping-pong sequencer's partition is unchanged) and each feature slice
carries the 8-row audio-window margin (``row_range`` of
FrameSynthesizer.iterate_synthesized_frames).
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
from typing import Optional

import cv2
import numpy as np

from calipsync_tpu_torch.audio.io import mux_audio
from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
from calipsync_tpu_torch.media.video import open_video_writer

_MARGIN = 8  # audio-window radius in feature rows (audio/windows.py)


def _gather_rows(blocks, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) from an ordered list of (n_i, 2, hidden) blocks."""
    parts, pos = [], 0
    for b in blocks:
        n = len(b)
        s, e = max(lo - pos, 0), min(hi - pos, n)
        if s < e:
            parts.append(b[s:e])
        pos += n
        if pos >= hi:
            break
    if not parts:
        shape = (0,) + (tuple(blocks[0].shape[1:]) if blocks
                        else (2, 1024))
        return np.zeros(shape, np.float32)
    return np.concatenate(parts, axis=0)


class _FrameWriter:
    """Encode thread: pulls frames off a bounded queue into a VideoWriter
    (cv2's encode releases the GIL, so it overlaps synthesis)."""

    def __init__(self, fps: int):
        self.fps = fps
        self.writer: Optional[cv2.VideoWriter] = None
        self.tmp_video: Optional[str] = None
        self.n = 0
        self.q: queue.Queue = queue.Queue(maxsize=64)
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while True:
                frame = self.q.get()
                if frame is None:
                    return
                if self.writer is None:
                    h, w = frame.shape[:2]
                    fd, self.tmp_video = tempfile.mkstemp(suffix=".mp4")
                    os.close(fd)
                    self.writer = open_video_writer(self.tmp_video,
                                                    self.fps, w, h)
                self.writer.write(frame)
                self.n += 1
        except BaseException as e:  # surfaced to the producer in close()
            self.error = e
            while True:  # drain so the producer never blocks on put
                if self.q.get() is None:
                    return

    def put(self, frame) -> None:
        if self.error is not None:
            raise RuntimeError("frame writer failed") from self.error
        self.q.put(frame)

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()
        if self.writer is not None:
            self.writer.release()
        if self.error is not None:
            raise RuntimeError("frame writer failed") from self.error


class VideoStreamManager:
    """Batch (file-to-file) manager, reference-compatible interface."""

    def __init__(self, synthesizer: FrameSynthesizer, hubert_extractor,
                 fps: int = 25, pipelined: bool = False,
                 span_rows: Optional[int] = None):
        """``pipelined=True`` overlaps featurization with synthesis (the
        extractor needs ``extract_from_file_stream``). ``span_rows`` sets
        the feature rows synthesized per pipelined call (a multiple of the
        synthesizer batch)."""
        self.synthesizer = synthesizer
        self.hubert = hubert_extractor
        self.fps = fps
        self.pipelined = pipelined
        if span_rows is not None and span_rows % synthesizer.batch_size:
            raise ValueError("span_rows must be a multiple of the "
                             "synthesizer batch size")
        self.span_rows = span_rows

    def process_single_file(self, audio_path: str, output_path: str,
                            is_generate_sync_frame: bool = True) -> dict:
        run = self._run_pipelined if self.pipelined else \
            self._run_sequential
        n, tmp_video, ttff = run(audio_path, is_generate_sync_frame)
        if tmp_video is None:
            raise RuntimeError("no frames generated")
        side_car = mux_audio(tmp_video, audio_path, output_path)
        os.remove(tmp_video)
        # ttff_s: seconds from the call's start to the first synthesized
        # frame (the pipelined path starts synthesis after the first 20 s
        # feature chunk instead of after the whole clip)
        return {"frames": n, "output": output_path,
                "audio_side_car": side_car,
                "ttff_s": None if ttff is None else round(ttff, 3)}

    # ---------------- sequential (reference flow) ----------------

    def _run_sequential(self, audio_path: str,
                        is_generate_sync_frame: bool):
        t0 = time.perf_counter()
        ttff = None
        features = self.hubert.extract_from_file(audio_path)
        writer = _FrameWriter(self.fps)
        try:
            for item in self.synthesizer.iterate_synthesized_frames(
                    features, 0, is_generate_sync_frame):
                if ttff is None:
                    ttff = time.perf_counter() - t0
                writer.put(item["frame"])
        finally:
            writer.close()
        return writer.n, writer.tmp_video, ttff

    # ---------------- pipelined (featurize || synth || encode) -------

    def _run_pipelined(self, audio_path: str,
                       is_generate_sync_frame: bool):
        blocks: list = []  # (n_i, 2, hidden) feature blocks, in order
        state = {"rows": 0, "done": False, "error": None, "cancel": False}
        cond = threading.Condition()

        def featurize():
            try:
                for block in self.hubert.extract_from_file_stream(
                        audio_path):
                    with cond:
                        if state["cancel"]:
                            return
                        blocks.append(block)
                        state["rows"] += len(block)
                        cond.notify()
            except BaseException as e:  # re-raised by the consumer
                state["error"] = e
            finally:
                with cond:
                    state["done"] = True
                    cond.notify()

        producer = threading.Thread(target=featurize, daemon=True)
        t0 = time.perf_counter()
        producer.start()

        bs = self.synthesizer.batch_size
        # rows synthesized a call: a multiple of batch_size (the sequencer
        # partition stays that of one whole-array call), the JAX package's
        # span (one 256-row bucket with its margins)
        span = self.span_rows or bs * max(1, 240 // bs)
        writer = _FrameWriter(self.fps)
        cursor = 0  # feature rows synthesized so far
        ttff = None
        try:
            while True:
                with cond:
                    cond.wait_for(
                        lambda: state["done"]
                        or state["rows"] >= cursor + span + _MARGIN)
                    rows = state["rows"]
                    snapshot = list(blocks)
                if state["error"] is not None:
                    raise RuntimeError("feature extraction failed") \
                        from state["error"]
                # span-sized steps even when more rows are ready: the
                # call partition stays the same under any thread timing
                hi = min(rows, cursor + span)
                if hi <= cursor:
                    break
                ctx_lo = max(0, cursor - _MARGIN)
                ctx_hi = min(rows, hi + _MARGIN)
                feats = _gather_rows(snapshot, ctx_lo, ctx_hi)
                for item in self.synthesizer.iterate_synthesized_frames(
                        feats, cursor, is_generate_sync_frame,
                        row_range=(cursor - ctx_lo, hi - ctx_lo)):
                    if ttff is None:
                        ttff = time.perf_counter() - t0
                    writer.put(item["frame"])
                cursor = hi
        finally:
            with cond:
                state["cancel"] = True
            producer.join()
            writer.close()
        return writer.n, writer.tmp_video, ttff
