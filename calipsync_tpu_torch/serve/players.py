"""Stream players: consume {'frame', 'audio', 'index'} dicts in real time
(own copy of BasePlayer, NullPlayer and FilePlayer of
calipsync_tpu/serve/players.py; the reference's frame_player).

In the reference the audio callback is the A/V clock: the audio device
pulls one frame's samples a callback and the frame is shown at that
instant. Without an audio device the same invariant holds in software:
frame k is shown at ``epoch + sum(len(audio_0..k-1)) / sample_rate``,
with the wall clock only as the re-anchor after starvation or a slow
render. The stream manager uses this interface:

    start_playing() / stop_playing() / running
    upload_frame(dict) / get_queue_length() / get_last_queue_item()

Backends here:
  - NullPlayer: pacing and callbacks only (tests, benchmarks).
  - FilePlayer: collects frames and audio; finalize() writes one A/V mp4
    (ffmpeg when present, else the box-level PCM remux of media/mp4.py).
The window, RTMP and virtual-camera players are not ported yet.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np

from calipsync_tpu_torch.audio.io import mux_audio
from calipsync_tpu_torch.media.video import open_video_writer


class BasePlayer:
    """Queue + clock core shared by all backends."""

    def __init__(self, width: int = 0, height: int = 0, fps: int = 25,
                 sample_rate: int = 24_000,
                 on_frame: Optional[Callable[[dict], None]] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.width = width
        self.height = height
        self.fps = fps
        self.SAMPLE_RATE = sample_rate
        self.samples_per_frame = sample_rate // fps
        self.running = False
        self.samples_played = 0      # cumulative audio clock (samples)
        self._epoch: Optional[float] = None
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._last_item: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = True  # no pacing thread yet
        self._on_frame = on_frame
        self._time = time_fn
        self._sleep = sleep_fn

    # -- manager interface --

    def upload_frame(self, frame_info: dict) -> None:
        with self._lock:
            self._last_item = frame_info
        self._queue.put(frame_info)

    def get_queue_length(self) -> int:
        return self._queue.qsize()

    def get_last_queue_item(self) -> Optional[dict]:
        with self._lock:
            return self._last_item

    def start_playing(self) -> None:
        if self.running:
            return
        self.running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop_playing(self) -> None:
        self.running = False
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            if not thread.is_alive():
                self._thread = None
        # True when the pacing thread is fully stopped; False if the
        # join timed out (thread stuck in a blocking render) — resource
        # owners must NOT close fds/handles the thread may still use.
        # A timed-out thread stays in self._thread so a later
        # stop_playing re-checks the live thread instead of assuming
        # it exited.
        self._stopped = thread is None or not thread.is_alive()

    # -- pacing loop --

    def av_drift(self) -> float:
        """Seconds the video clock leads (+) / lags (-) the audio clock.

        Zero while the pegged loop keeps up; only starvation or a
        slower-than-realtime render re-anchors the epoch.
        """
        if self._epoch is None:
            return 0.0
        return ((self._time() - self._epoch)
                - self.samples_played / self.SAMPLE_RATE)

    def _run(self) -> None:
        """Audio-pegged pacing loop (reference player_main.py:156-174).

        Frame k is emitted at ``epoch + samples_played/sample_rate`` where
        ``samples_played`` is the running total of audio samples attached
        to frames 0..k-1 (frames with no audio count one silent frame's
        worth, as the reference callback emits zeros when starved). On
        starvation or falling more than one frame behind, the epoch is
        re-anchored to the wall clock instead of bursting to catch up —
        exactly what a hardware audio clock would do.
        """
        period = 1.0 / self.fps
        self.samples_played = 0
        self._epoch = self._time()
        while self.running:
            try:
                item = self._queue.get(timeout=period)
            except queue.Empty:
                # starvation: the audio device would play silence; state is
                # untouched — the next frame's own target decides pacing
                continue
            # frame k's render target: when its audio would start playing
            target = self._epoch + self.samples_played / self.SAMPLE_RATE
            delay = target - self._time()
            if delay > 0:
                self._sleep(delay)
            elif delay < -period:
                # starved or slower-than-realtime render: wall-clock
                # fallback — play this frame NOW and pace the rest from it
                # instead of bursting to catch up (a hardware audio clock
                # would do exactly this)
                self._epoch = (self._time()
                               - self.samples_played / self.SAMPLE_RATE)
            try:
                self._render(item)
                if self._on_frame is not None:
                    self._on_frame(item)
            except Exception as e:  # keep the clock alive (ref resilience)
                print(f"player render error: {e}")
            audio = item.get("audio")
            self.samples_played += (len(audio) if audio is not None
                                    else self.samples_per_frame)

    def _render(self, item: dict) -> None:  # backend hook
        pass


class NullPlayer(BasePlayer):
    """Pacing and callbacks only — for tests and headless benchmarks."""


class FilePlayer(BasePlayer):
    """Collects frames + audio; finalize() writes an A/V-muxed mp4."""

    def __init__(self, output_path: str, realtime: bool = False, **kw):
        super().__init__(**kw)
        self.output_path = output_path
        self.realtime = realtime
        self.frames: list[np.ndarray] = []
        self.audio: list[np.ndarray] = []

    def _run(self) -> None:
        if self.realtime:
            super()._run()
            return
        while self.running:  # drain as fast as frames arrive
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._render(item)
            if self._on_frame is not None:
                self._on_frame(item)
        # stop_playing leaves up to buffer_threshold frames queued;
        # dropping them would cut the muxed file's tail short
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._render(item)
            if self._on_frame is not None:
                self._on_frame(item)

    def _render(self, item: dict) -> None:
        self.frames.append(item["frame"])
        if item.get("audio") is not None:
            self.audio.append(np.asarray(item["audio"], np.float32))

    def finalize(self) -> str:
        if not self.frames:
            raise RuntimeError("no frames played")
        h, w = self.frames[0].shape[:2]
        fd, tmp_v = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        vw = open_video_writer(tmp_v, self.fps, w, h)
        for f in self.frames:
            vw.write(f)
        vw.release()
        if self.audio:
            from scipy.io import wavfile

            fd, tmp_a = tempfile.mkstemp(suffix=".wav")
            os.close(fd)
            wavfile.write(tmp_a, self.SAMPLE_RATE,
                          np.concatenate(self.audio))
            mux_audio(tmp_v, tmp_a, self.output_path)
            os.remove(tmp_a)
            if os.path.exists(tmp_v):
                os.remove(tmp_v)
        else:
            os.replace(tmp_v, self.output_path)
        return self.output_path
