"""Stream players: consume {'frame', 'audio', 'index'} dicts in real time
(own copy of calipsync_tpu/serve/players.py; the reference's
frame_player).

In the reference the audio callback is the A/V clock: the audio device
pulls one frame's samples a callback and the frame is shown at that
instant. Without an audio device the same invariant holds in software:
frame k is shown at ``epoch + sum(len(audio_0..k-1)) / sample_rate``,
with the wall clock only as the re-anchor after starvation or a slow
render. The stream manager uses this interface:

    start_playing() / stop_playing() / running
    upload_frame(dict) / get_queue_length() / get_last_queue_item()

Backends:
  - NullPlayer: pacing and callbacks only (tests, benchmarks).
  - FilePlayer: collects frames and audio; finalize() writes one A/V mp4
    (ffmpeg when present, else the box-level PCM remux of media/mp4.py).
  - WindowPlayer: cv2.imshow GUI (needs a display).
  - RTMPPlayer: FLV over RTMP, natively (FSV1 + PCM, media/flv.py and
    media/rtmp.py) or through an ffmpeg x264/aac push — the Linux
    equivalent of the reference's win32 pipe + NVENC pusher
    (player_rtmp_windows.py:10-184).
  - VirtualCamPlayer: a v4l2loopback virtual webcam, BGR24 written to
    the device node after one VIDIOC_S_FMT ioctl (the reference's
    pyvirtualcam drives the same module on Linux, player_cam.py).

The pacing thread does host work only (resize, encode, socket and pipe
writes); synthesis stays on the stream manager's thread.
"""

from __future__ import annotations

import os
import queue
import subprocess
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np

from calipsync_tpu_torch.audio.io import mux_audio, resample
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


class WindowPlayer(BasePlayer):
    """GUI window playback (reference player_main.py CVPlayer)."""

    def __init__(self, window_name: str = "calipsync", **kw):
        super().__init__(**kw)
        self.window_name = window_name

    def start_playing(self) -> None:
        """Fail fast when headless instead of printing one render error
        per frame (a GUI backend needs a display on this platform)."""
        import sys

        if (sys.platform.startswith("linux")
                and not os.environ.get("DISPLAY")
                and not os.environ.get("WAYLAND_DISPLAY")):
            raise RuntimeError(
                "WindowPlayer needs a display (DISPLAY/WAYLAND_DISPLAY "
                "unset); use FilePlayer, RTMPPlayer or NullPlayer")
        super().start_playing()

    def _render(self, item: dict) -> None:
        import cv2

        frame = item["frame"]
        if self.width and self.height:
            frame = cv2.resize(frame, (self.width, self.height))
        cv2.imshow(self.window_name, frame)
        cv2.waitKey(1)

    def stop_playing(self) -> None:
        super().stop_playing()
        try:
            import cv2

            cv2.destroyWindow(self.window_name)
        except Exception:
            pass


class RTMPPlayer(BasePlayer):
    """RTMP/FLV push (reference player_rtmp_windows.py:65-93).

    Two backends behind one interface:
      - ``ffmpeg``: raw video on stdin + audio via a named pipe into an
        ffmpeg flv push (x264 instead of the reference's NVENC).
      - ``native`` (no external binaries): Screen-Video (FSV1) frames +
        44.1 kHz PCM audio muxed by media/flv.py and pushed over a
        from-scratch RTMP session (media/rtmp.py) — the same move the
        box-level mp4 remuxer made for offline mux. Audio is
        polyphase-resampled per frame chunk to 44.1 kHz because FLV's
        audio tag header can only signal 44.1/22.05/11.025/5.5 kHz.
    ``backend='auto'`` prefers ffmpeg when the binary exists (better
    compression) and falls back to native so the push always works.
    """

    NATIVE_AUDIO_RATE = 44_100

    def __init__(self, push_url: str, width: int, height: int,
                 backend: str = "auto", **kw):
        super().__init__(width=width, height=height, **kw)
        if backend not in ("auto", "ffmpeg", "native"):
            raise ValueError(f"unknown RTMP backend: {backend}")
        self.push_url = push_url
        self.backend = backend
        self._proc: Optional[subprocess.Popen] = None
        self._audio_fifo: Optional[str] = None
        self._audio_fh = None
        self._audio_pending: list[bytes] = []
        self._pub = None
        self._enc = None
        self._vframes = 0
        self._asamples = 0

    def _start_native(self) -> None:
        from calipsync_tpu_torch.media.flv import ScreenVideoEncoder
        from calipsync_tpu_torch.media.rtmp import RTMPPublisher

        self._pub = RTMPPublisher(self.push_url)
        self._enc = ScreenVideoEncoder()
        self._vframes = 0
        self._asamples = 0
        self._pub.send_metadata(self.width, self.height, self.fps,
                                self.NATIVE_AUDIO_RATE)
        super().start_playing()

    def start_playing(self) -> None:
        import shutil as _sh

        use_native = (self.backend == "native"
                      or (self.backend == "auto"
                          and _sh.which("ffmpeg") is None))
        if use_native:
            self._start_native()
            return
        if _sh.which("ffmpeg") is None:
            raise RuntimeError("RTMP push requires an ffmpeg binary")
        self._audio_fifo = tempfile.mktemp(suffix=".fifo")
        os.mkfifo(self._audio_fifo)
        cmd = [
            "ffmpeg", "-v", "error",
            "-f", "rawvideo", "-pix_fmt", "bgr24",
            "-s", f"{self.width}x{self.height}", "-r", str(self.fps),
            "-i", "pipe:0",
            "-f", "f32le", "-ar", str(self.SAMPLE_RATE), "-ac", "1",
            "-i", self._audio_fifo,
            "-c:v", "libx264", "-preset", "veryfast", "-tune",
            "zerolatency", "-pix_fmt", "yuv420p",
            "-c:a", "aac", "-ar", "44100",
            "-f", "flv", self.push_url,
        ]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        # Start the pacing thread BEFORE waiting on the fifo: ffmpeg may
        # probe input 0 (rawvideo on stdin) before it opens the fifo, so
        # video bytes must be flowing or neither side progresses. Audio
        # rendered before the fifo opens is buffered and flushed then.
        self._audio_pending: list[bytes] = []
        super().start_playing()
        # a blocking open would hang forever if ffmpeg dies before (or
        # without) opening the fifo's read end; poll non-blocking with
        # a liveness check instead
        deadline = time.monotonic() + 15.0
        fd = None
        while fd is None:
            try:
                fd = os.open(self._audio_fifo,
                             os.O_WRONLY | os.O_NONBLOCK)
            except OSError:  # ENXIO: no reader yet
                if self._proc.poll() is not None:
                    self.running = False
                    raise RuntimeError(
                        f"ffmpeg exited (code {self._proc.returncode}) "
                        "before opening the audio fifo")
                if time.monotonic() > deadline:
                    self.running = False
                    self._proc.kill()
                    raise RuntimeError(
                        "ffmpeg never opened the audio fifo (15 s)")
                time.sleep(0.05)
        os.set_blocking(fd, True)
        self._audio_fh = os.fdopen(fd, "wb")

    def _render_native(self, item: dict) -> None:
        import cv2

        from calipsync_tpu_torch.media.flv import pcm_audio_payload

        frame = item["frame"]
        if frame.shape[0] != self.height or frame.shape[1] != self.width:
            frame = cv2.resize(frame, (self.width, self.height))
        ts_ms = self._vframes * 1000 // self.fps
        self._pub.send_video(ts_ms, self._enc.encode(frame))
        self._vframes += 1
        audio = item.get("audio")
        if audio is not None:
            rate = self.NATIVE_AUDIO_RATE
            pcm = resample(np.asarray(audio, np.float32),
                           self.SAMPLE_RATE, rate)
            s16 = np.clip(pcm * 32767.0, -32768, 32767).astype("<i2")
            a_ts = self._asamples * 1000 // rate
            self._pub.send_audio(a_ts, pcm_audio_payload(s16, rate))
            self._asamples += len(s16)

    def _render(self, item: dict) -> None:
        import cv2

        if self._pub is not None:
            self._render_native(item)
            return
        if self._proc is None or self._proc.stdin is None:
            return
        frame = item["frame"]
        if frame.shape[0] != self.height or frame.shape[1] != self.width:
            frame = cv2.resize(frame, (self.width, self.height))
        try:
            self._proc.stdin.write(frame.tobytes())
            audio = item.get("audio")
            if audio is not None:
                buf = np.asarray(audio, np.float32).tobytes()
                if self._audio_fh is None:  # fifo not yet open
                    self._audio_pending.append(buf)
                else:
                    while self._audio_pending:
                        self._audio_fh.write(self._audio_pending.pop(0))
                    self._audio_fh.write(buf)
        except BrokenPipeError:
            self.running = False

    def stop_playing(self) -> None:
        super().stop_playing()
        if not self._stopped:  # writer may still be in _render
            return
        if self._pub is not None:
            self._pub.close()
            self._pub = None
            return
        for fh in (self._audio_fh,
                   self._proc.stdin if self._proc else None):
            try:
                if fh:
                    fh.close()
            except Exception:
                pass
        if self._proc is not None:
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                # e.g. ffmpeg stuck flushing to an unreachable RTMP
                # server: reap it rather than leaking a zombie and
                # skipping the fifo cleanup below
                self._proc.kill()
                self._proc.wait(timeout=5)
            self._proc = None
        if self._audio_fifo and os.path.exists(self._audio_fifo):
            os.remove(self._audio_fifo)


V4L2_BUF_TYPE_VIDEO_OUTPUT = 2
V4L2_FIELD_NONE = 1
V4L2_PIX_FMT_BGR24 = (ord("B") | ord("G") << 8 | ord("R") << 16
                      | ord("3") << 24)
# _IOWR('V', 5, struct v4l2_format): sizeof == 208 on 64-bit Linux
VIDIOC_S_FMT = (3 << 30) | (208 << 16) | (ord("V") << 8) | 5


def v4l2_output_format(width: int, height: int) -> bytearray:
    """Build a ``struct v4l2_format`` for a BGR24 VIDEO_OUTPUT device
    (linux/videodev2.h). 64-bit layout: u32 ``type`` at offset 0, the
    fmt union (8-byte aligned — v4l2_window holds pointers) at offset 8,
    with v4l2_pix_format's 12 u32 fields packed inside."""
    import struct

    buf = bytearray(208)
    struct.pack_into("I", buf, 0, V4L2_BUF_TYPE_VIDEO_OUTPUT)
    struct.pack_into(
        "12I", buf, 8,
        width, height, V4L2_PIX_FMT_BGR24, V4L2_FIELD_NONE,
        width * 3,              # bytesperline
        width * height * 3,     # sizeimage
        0, 0, 0, 0, 0, 0)       # colorspace..xfer_func: device defaults
    return buf


class VirtualCamPlayer(BasePlayer):
    """Virtual webcam via a v4l2loopback output device — the Linux-native
    equivalent of the reference's pyvirtualcam backend (player_cam.py:
    16-126; on Linux pyvirtualcam itself drives v4l2loopback). Raw BGR24
    frames are written straight to ``/dev/videoN`` after one
    VIDIOC_S_FMT ioctl; consumers (browsers, OBS, cv2.VideoCapture) see a
    webcam. Requires the v4l2loopback kernel module to provide the
    device; fails fast with guidance when absent."""

    def __init__(self, device: str = "/dev/video0", width: int = 480,
                 height: int = 480, **kw):
        super().__init__(width=width, height=height, **kw)
        self.device = device
        self._fd: Optional[int] = None

    def start_playing(self) -> None:
        import fcntl

        if not os.path.exists(self.device):
            raise RuntimeError(
                f"virtual camera device {self.device} not found — load "
                "v4l2loopback (modprobe v4l2loopback) or use "
                "WindowPlayer/RTMPPlayer/FilePlayer")
        self._fd = os.open(self.device, os.O_RDWR)
        try:
            fcntl.ioctl(self._fd, VIDIOC_S_FMT,
                        v4l2_output_format(self.width, self.height))
        except OSError:
            os.close(self._fd)
            self._fd = None
            raise
        super().start_playing()

    def _render(self, item: dict) -> None:
        import cv2

        if self._fd is None:
            return
        frame = item["frame"]
        if frame.shape[:2] != (self.height, self.width):
            frame = cv2.resize(frame, (self.width, self.height))
        os.write(self._fd, np.ascontiguousarray(frame).tobytes())

    def stop_playing(self) -> None:
        super().stop_playing()
        if self._fd is not None and self._stopped:
            # only close once the pacing thread is provably out of
            # _render: closing under a live os.write risks writing to a
            # reused fd; leaking the fd on a stuck writer is the lesser
            # evil (the device node is reopened by the next start)
            os.close(self._fd)
            self._fd = None
