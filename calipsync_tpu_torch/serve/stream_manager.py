"""Real-time streaming manager: priority audio queues -> synthesized A/V
(counterpart of calipsync_tpu/serve/stream_manager.py; the reference's
image_infer_v1/infer_api.py):

  - two priority queues ('danmu' before 'normal') of per-frame AudioBatch
    items (HuBERT feature rows and the audio at both rates);
  - a producer thread gated on the player's buffer level (default 1 s of
    frames) synthesizes ``synthesis_window_seconds`` windows;
  - a silence filler keeps the avatar idling when no audio is queued;
  - 'interrupt' mode switches audio mid-stream on priority,
    'no-interrupt' finishes the current audio file first;
  - ``use_silent_features`` substitutes silence HuBERT rows so the mouth
    stays still while the audio plays (the "co-host" mode).

Audio IO through audio/io.py, features through the port's HuBERT
extractor, frames through infer/synthesizer.py on the card. The warm-up
and every producer session run on one thread of the manager's
(``_SynthesisThread``), which lives until :meth:`close`: PyTorch caches
cuDNN's execution plans per host thread, so a fresh thread's first window
would pay for building them. That thread runs one thing at a time, so
``warmup`` and ``start_playing`` raise while a session's producer runs.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future, wait
from dataclasses import dataclass
from queue import Queue, SimpleQueue
from typing import Callable, Optional

import numpy as np

from calipsync_tpu_torch.audio.io import load_audio, save_wav
from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer


@dataclass
class AudioBatch:
    """One output frame's audio payload (reference infer_api.py:15-22)."""

    hubert_feature: np.ndarray        # one (2, 1024) feature row
    audio_chunk: np.ndarray           # 16 kHz chunk (feature rate)
    original_audio_chunk: np.ndarray  # output-rate chunk (playback)
    audio_path: str
    is_sync_frame: bool = True


class _SynthesisThread:
    """One daemon thread that runs the calls given to it in order and
    returns their futures. A host thread's first synthesis window is slow
    (PyTorch caches cuDNN's execution plans per thread; chip_smoke.py
    times a fresh thread against this one, PERF.md §5), so warming
    up and serving on the same thread pays it once, before the clock
    starts. A daemon, like the JAX package's producer thread, so a session
    left running does not hold the interpreter at exit; :meth:`stop`
    ends it."""

    def __init__(self):
        self._calls: SimpleQueue = SimpleQueue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="calipsync-synthesis")
        self._thread.start()

    def _run(self) -> None:
        while True:
            call = self._calls.get()
            if call is None:
                return
            fn, fut = call
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # handed to the caller's future
                fut.set_exception(e)

    def submit(self, fn: Callable) -> Future:
        fut: Future = Future()
        self._calls.put((fn, fut))
        return fut

    def stop(self, timeout: Optional[float] = None) -> None:
        """End the thread once the calls before this one have run."""
        self._calls.put(None)
        self._thread.join(timeout)


class StreamingVideoManager:
    def __init__(self, synthesizer: FrameSynthesizer, hubert_extractor,
                 player, buffer_threshold: int = 25,
                 synthesis_window_seconds: float = 1.0,
                 output_sample_rate: int = 24_000, fps: int = 25,
                 is_interrupt: bool = False, error_backoff_s: float = 1.0):
        self.synthesizer = synthesizer
        self.hubert = hubert_extractor
        self.player = player
        self.fps = fps
        self.feature_sample_rate = 16_000
        self.output_sample_rate = output_sample_rate
        self.samples_per_frame = self.feature_sample_rate // fps
        self.output_samples_per_frame = output_sample_rate // fps
        self.synthesis_frame_count = int(fps * synthesis_window_seconds)
        # The player's audio-pegged clock divides chunk lengths by ITS
        # sample rate; a mismatch would change playback speed, so fail
        # loudly at construction instead (players.py BasePlayer._run).
        prate = getattr(player, "SAMPLE_RATE", None)
        if prate is not None and prate != output_sample_rate:
            raise ValueError(
                f"player sample_rate {prate} != manager "
                f"output_sample_rate {output_sample_rate}: construct the "
                f"player with sample_rate={output_sample_rate}")
        self.buffer_threshold = buffer_threshold
        self.is_interrupt = is_interrupt
        self.error_backoff_s = error_backoff_s
        self.producer_errors = 0
        self.frames_uploaded = 0  # frames handed to the player

        self.audio_queues: dict[str, Queue] = {"normal": Queue(),
                                               "danmu": Queue()}
        self.queue_priority = ["danmu", "normal"]

        self._tmp = tempfile.mkdtemp(prefix="calipsync_stream_")
        self.silence_audio_path = self._generate_silence_audio(
            buffer_threshold / fps)
        self._silence_batches: Optional[list[AudioBatch]] = None
        self._thread = _SynthesisThread()
        self._producer: Optional[Future] = None
        # Stage timestamps for the FIRST produced window (time-to-first-
        # frame accounting): producer_start -> collected -> synth_first
        # -> uploaded, all time.monotonic(). Read after start_playing.
        self.ttf_marks: dict[str, float] = {}

    # ------------- audio ingestion -------------

    def _generate_silence_audio(self, duration_s: float) -> str:
        samples = int(duration_s * self.output_sample_rate)
        path = os.path.join(self._tmp, f"silence_{duration_s:.1f}s.wav")
        save_wav(path, np.zeros(samples, np.float32),
                 self.output_sample_rate)
        return path

    def _frames_from_audio(self, audio_path: str, is_sync_frame: bool,
                           use_silent_features: bool) -> list[AudioBatch]:
        original = load_audio(audio_path, self.output_sample_rate)
        feature_audio = load_audio(audio_path, self.feature_sample_rate)

        if use_silent_features:
            num_frames = len(feature_audio) // self.samples_per_frame
            silent = self.hubert.extract_from_file(self.silence_audio_path)
            if len(silent) == 0:
                rows = [np.zeros((2, 1024), np.float32)] * num_frames
            else:
                rows = [silent[0]] * num_frames
        else:
            rows = list(self.hubert.extract_from_file(audio_path))

        def chunk(arr, i, size):
            start = i * size
            piece = arr[start:start + size]
            if len(piece) < size:
                piece = np.pad(piece, (0, size - len(piece)))
            return piece

        return [AudioBatch(
                    hubert_feature=np.asarray(rows[i], np.float32),
                    audio_chunk=chunk(feature_audio, i,
                                      self.samples_per_frame),
                    original_audio_chunk=chunk(original, i,
                                               self.output_samples_per_frame),
                    audio_path=audio_path,
                    is_sync_frame=is_sync_frame)
                for i in range(len(rows))]

    def add_audio_to_queue(self, audio_path: str, queue_name: str = "normal",
                           is_sync_frame: bool = True,
                           use_silent_features: bool = False) -> int:
        """Decode + featurize an audio file into per-frame batches on the
        named priority queue. Returns the number of frames queued."""
        if queue_name not in self.audio_queues:
            raise ValueError(f"unknown queue: {queue_name}")
        frames = self._frames_from_audio(audio_path, is_sync_frame,
                                         use_silent_features)
        for b in frames:
            self.audio_queues[queue_name].put(b)
        return len(frames)

    def get_queue_lengths(self) -> dict[str, int]:
        return {k: q.qsize() for k, q in self.audio_queues.items()}

    # ------------- producer loop -------------

    def _silence_window(self) -> list[AudioBatch]:
        if self._silence_batches is None:
            self._silence_batches = self._frames_from_audio(
                self.silence_audio_path, True, False)
        return [AudioBatch(b.hubert_feature, b.audio_chunk,
                           b.original_audio_chunk, b.audio_path, True)
                for b in self._silence_batches[:self.synthesis_frame_count]]

    def _collect_interrupt(self) -> tuple[list[AudioBatch], bool]:
        """Priority pick each window; switches audio mid-file
        (reference :229-256)."""
        for name in self.queue_priority:
            q = self.audio_queues[name]
            if q.empty():
                continue
            out, sync = [], True
            for _ in range(min(self.synthesis_frame_count, q.qsize())):
                if q.empty():
                    break
                b = q.get()
                out.append(b)
                sync = b.is_sync_frame
            if out:
                return out, sync
        return [], True

    def _collect_no_interrupt(self, current_path: Optional[str]
                              ) -> tuple[list[AudioBatch], bool,
                                         Optional[str]]:
        """Pin the in-flight audio file until drained (reference :337-392)."""
        selected = None
        sync = True
        if current_path is not None:
            for name, q in self.audio_queues.items():
                # snapshot under the queue's own mutex: user threads
                # enqueue concurrently via add_audio_to_queue
                with q.mutex:
                    items = list(q.queue)
                for item in items:
                    if item.audio_path == current_path:
                        selected = name
                        sync = item.is_sync_frame
                        break
                if selected:
                    break
            if not selected:
                current_path = None
        if current_path is None:
            for name in self.queue_priority:
                if not self.audio_queues[name].empty():
                    selected = name
                    break
        out: list[AudioBatch] = []
        if selected is not None:
            q = self.audio_queues[selected]
            limit = min(self.synthesis_frame_count, q.qsize())
            if limit > 0:
                first = q.queue[0]
                path, sync = first.audio_path, first.is_sync_frame
                current_path = path
                while len(out) < limit and not q.empty():
                    if q.queue[0].audio_path != path:
                        break
                    out.append(q.get())
        return out, sync, current_path

    def warmup(self) -> None:
        """Pay every cold start before the clock starts: the silence
        featurization (HuBERT at its length bucket), the silence batch
        cache, and one synthesis window (the kernels' first launches, the
        allocator, cuDNN's execution plans), on the thread that will run
        the producer. Call before :meth:`start_playing`; raises while a
        session plays (it would wait for the session's end)."""
        self._check_idle("warmup")
        self._thread.submit(self._warm).result()

    def _warm(self) -> None:
        batches = self._silence_window()
        feats = np.stack([b.hubert_feature for b in batches])
        synth = self.synthesizer
        # an adaptive synthesizer may flip format mid-serving: warm both
        # device steps now (transfer_format pinned during each pass, so
        # the bandit cannot switch away within it)
        if getattr(synth, "transfer_format", None) == "adaptive":
            saved = synth._active_format
            try:
                for fmt in ("bgr", "yuv420"):
                    synth.transfer_format = fmt
                    synth._active_format = fmt
                    for _ in synth.iterate_synthesized_frames(feats, 0,
                                                              True):
                        pass
            finally:
                synth.transfer_format = "adaptive"
                synth._active_format = saved
        else:
            for _ in synth.iterate_synthesized_frames(feats, 0, True):
                pass

    def _producer_loop(self) -> None:
        last_frame_index = 0
        current_path: Optional[str] = None
        first = True
        self.ttf_marks["producer_start"] = time.monotonic()
        while self.player and self.player.running:
            try:
                if self.player.get_queue_length() >= self.buffer_threshold:
                    time.sleep(0.001)
                    continue
                last = self.player.get_last_queue_item()
                if self.player.get_queue_length() > 0 and last is not None:
                    last_frame_index = last["index"] + 1

                if self.is_interrupt:
                    batch, sync = self._collect_interrupt()
                else:
                    batch, sync, current_path = self._collect_no_interrupt(
                        current_path)
                if not batch:
                    batch, sync = self._silence_window(), True
                    if not self.is_interrupt:
                        current_path = self.silence_audio_path
                if first:
                    self.ttf_marks["collected"] = time.monotonic()

                feats = np.stack([b.hubert_feature for b in batch])
                for i, info in enumerate(
                        self.synthesizer.iterate_synthesized_frames(
                            feats, last_frame_index, sync)):
                    if not (self.player and self.player.running):
                        break  # stop_playing mid-window: exit promptly
                    if first:
                        self.ttf_marks["synth_first"] = time.monotonic()
                    if i < len(batch):
                        info["audio"] = batch[i].original_audio_chunk
                        self.player.upload_frame(info)
                        self.frames_uploaded += 1
                        if first:
                            self.ttf_marks["uploaded"] = time.monotonic()
                            first = False
            except Exception as e:
                # Catch-and-backoff keeps the stream alive through transient
                # synthesis/IO failures (reference infer_api.py:309-315);
                # producer_errors counts them.
                self.producer_errors += 1
                print(f"stream producer error: {e}")
                traceback.print_exc()
                time.sleep(self.error_backoff_s)

    # ------------- lifecycle -------------

    def _check_idle(self, what: str) -> None:
        if self._producer is not None and not self._producer.done():
            raise RuntimeError(
                f"{what}: a session's producer still runs on the "
                "synthesis thread; stop_playing() first (after a timed-out "
                "stop, once its dispatch ends)")

    def start_playing(self) -> None:
        self._check_idle("start_playing")
        self.player.start_playing()
        self._producer = self._thread.submit(self._producer_loop)

    def stop_playing(self) -> None:
        if self.player:
            self.player.stop_playing()
        if self._producer is not None:
            if wait([self._producer], timeout=5.0).done:
                self._producer.result()  # what the loop did not catch
                self._producer = None
            # else kept: warmup and start_playing refuse to queue
            # behind the stuck producer
        for q in self.audio_queues.values():
            # under the mutex: if the wait timed out (producer stuck in
            # a long dispatch) a bare clear() races its q.get()
            with q.mutex:
                q.queue.clear()

    def close(self) -> None:
        """Stop playing, end the synthesis thread and remove the temporary
        directory (the silence wav)."""
        self.stop_playing()
        self._thread.stop(timeout=5.0)
        shutil.rmtree(self._tmp, ignore_errors=True)
