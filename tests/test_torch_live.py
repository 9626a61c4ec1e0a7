"""The port's live output (calipsync_tpu_torch media/flv.py, media/rtmp.py,
the window, RTMP and virtual-camera players, and the serve command's
player flags) against the JAX package on the CPU.

FLV and RTMP are host byte work: every encoded byte must equal the JAX
package's, and each package's reader, server and publisher must work with
the other's. The players run over loopback (RTMP), a regular file
standing in for the v4l2 node, or a patched ``subprocess.Popen``
standing in for ffmpeg.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from calipsync_tpu import cli as jax_cli
from calipsync_tpu.media import flv as jflv
from calipsync_tpu.media import rtmp as jrtmp
from calipsync_tpu.serve import players as jplayers
from calipsync_tpu_torch import cli
from calipsync_tpu_torch.media import flv, rtmp
from calipsync_tpu_torch.serve import players


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n=6, h=120, w=176, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w, 3), np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        f[h // 4:h // 2, 10 + i * 8:40 + i * 8] = (i * 37 % 256, 200, 90)
        out.append(f)
    return out


def _tone(n, rate, hz=220.0):
    t = np.arange(n, dtype=np.float32) / rate
    return (0.3 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _read_all(path):
    import cv2

    cap = cv2.VideoCapture(path)
    got = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        got.append(img)
    cap.release()
    return got


# ------------------------------------------------------------------- FLV

def test_amf0_and_metadata_match_jax():
    vals = [1.5, True, False, "hello", None,
            {"a": 1.0, "b": "x", "nested": {"c": False}}]
    for v in vals:
        enc = flv.amf0_value(v)
        assert enc == jflv.amf0_value(v)
        assert flv.amf0_decode(enc) == jflv.amf0_decode(enc) == (v, len(enc))
    arr = {"width": 3.0, "ok": True, "name": "x"}
    enc = flv.amf0_ecma_array(arr)
    assert enc == jflv.amf0_ecma_array(arr)
    assert flv.amf0_decode(enc) == (arr, len(enc))
    for rate in (44_100, None):
        assert flv.metadata_tag(1080, 1920, 25.0, rate) == \
            jflv.metadata_tag(1080, 1920, 25.0, rate)
    assert flv.flv_header(True) == jflv.flv_header(True)
    assert flv.flv_tag(9, 2 ** 24 + 40, b"abc") == \
        jflv.flv_tag(9, 2 ** 24 + 40, b"abc")


@pytest.mark.parametrize("block,keyframe_interval", [(64, 3), (32, 100)])
def test_screen_video_matches_jax(block, keyframe_interval):
    """FSV1 key and inter frames byte-equal to the JAX encoder's, and each
    package's decoder reads the other's stream back exactly."""
    ours = flv.ScreenVideoEncoder(block, keyframe_interval)
    ref = jflv.ScreenVideoEncoder(block, keyframe_interval)
    frames = _frames(8)
    frames.append(_frames(1, h=96, w=128)[0])  # a size change: keyframe
    kinds = []
    prev_o = prev_r = None
    for f in frames:
        p = ours.encode(f)
        assert p == ref.encode(f)
        kinds.append(p[0] >> 4)
        if prev_o is not None and prev_o.shape != f.shape:
            prev_o = prev_r = None
        prev_o = flv.decode_screen_video(p, prev_o)
        prev_r = jflv.decode_screen_video(p, prev_r)
        np.testing.assert_array_equal(prev_o, f)
        np.testing.assert_array_equal(prev_r, f)
    assert 1 in kinds and 2 in kinds and kinds[-1] == 1


def test_pcm_payload_and_flv_file_match_jax(tmp_path):
    s16 = (_tone(1764, 44_100) * 32767).astype("<i2")
    for rate in (44_100, 22_050, 11_025, 5512):
        assert flv.pcm_audio_payload(s16, rate) == \
            jflv.pcm_audio_payload(s16, rate)
    with pytest.raises(ValueError, match="FLV cannot signal"):
        flv.pcm_audio_payload(s16, 48_000)

    paths = {}
    for name, mod in (("port", flv), ("jax", jflv)):
        paths[name] = str(tmp_path / f"{name}.flv")
        enc = mod.ScreenVideoEncoder()
        w = mod.FLVWriter(paths[name], 176, 120, 25.0, audio_rate=44_100)
        for i, f in enumerate(_frames()):
            w.write_tag(mod.TAG_VIDEO, i * 40, enc.encode(f))
            w.write_tag(mod.TAG_AUDIO, i * 40,
                        mod.pcm_audio_payload(s16, 44_100))
        w.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    # each package's reader on the other's file
    assert list(flv.read_flv_tags(paths["jax"])) == \
        list(jflv.read_flv_tags(paths["port"]))
    got = _read_all(paths["port"])
    assert len(got) == 6
    for a, b in zip(got, _frames()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ RTMP

def test_parse_rtmp_url_matches_jax():
    for url in ("rtmp://h:19/live/k", "rtmp://h/app/sub/key"):
        assert rtmp.parse_rtmp_url(url) == jrtmp.parse_rtmp_url(url)
    for bad in ("http://h/live/k", "rtmp://h/noapp"):
        with pytest.raises(ValueError):
            rtmp.parse_rtmp_url(bad)


def _publish(pub_mod, server_mod, flv_mod, capture, chunk_size=4096):
    """Publish metadata and six A/V frame pairs from ``pub_mod``'s client
    into ``server_mod``'s loopback ingest; returns (tags, capture bytes)."""
    server = server_mod.MiniRTMPServer(capture)
    pub = pub_mod.RTMPPublisher(server.url, chunk_size=chunk_size)
    assert server.published.wait(5.0)
    pub.send_metadata(176, 120, 25.0, 44_100)
    enc = flv_mod.ScreenVideoEncoder()
    s16 = (_tone(1764, 44_100, 440.0) * 32767).astype("<i2")
    for i, f in enumerate(_frames()):
        pub.send_video(i * 40, enc.encode(f))
        pub.send_audio(i * 40, flv_mod.pcm_audio_payload(s16, 44_100))
    pub.send_video(240, b"\x13" + bytes(range(256)) * 300)  # > chunks
    pub.close()
    server.stop()
    assert server.error is None, server.error
    with open(capture, "rb") as f:
        return server.tags, f.read()


@pytest.mark.parametrize("publisher,server", [("port", "jax"),
                                              ("jax", "port"),
                                              ("port", "port")])
def test_rtmp_loopback_matches_jax(tmp_path, publisher, server):
    """The port's publisher into JAX's ingest, JAX's into the port's, and
    the port's into its own capture the same tags and the same .flv bytes
    as JAX's publisher into JAX's ingest."""
    mods = {"port": (rtmp, flv), "jax": (jrtmp, jflv)}
    ref_tags, ref_bytes = _publish(jrtmp, jrtmp, jflv,
                                   str(tmp_path / "ref.flv"))
    tags, data = _publish(mods[publisher][0], mods[server][0],
                          mods[publisher][1], str(tmp_path / "cap.flv"),
                          chunk_size=256 if publisher == "port" else 4096)
    assert tags == ref_tags
    assert data == ref_bytes
    assert [t for t, _, _ in tags].count(flv.TAG_VIDEO) == 7
    got = _read_all(str(tmp_path / "cap.flv"))
    for a, b in zip(got, _frames()):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- players

def _play(player_cls, url, frames, audio):
    player = player_cls(url, width=176, height=120, backend="native", fps=25,
                        sample_rate=16_000)
    player.start_playing()
    for i, f in enumerate(frames):
        player.upload_frame({"frame": f, "audio": audio, "index": i})
    deadline = time.time() + 10.0
    while player.get_queue_length() > 0 and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.1)  # let the last render finish
    player.stop_playing()
    return player


def test_native_rtmp_player_end_to_end_matches_jax(tmp_path):
    """RTMPPlayer(backend='native') into the loopback ingest, 10 frames of
    176x120 (one 352x240, resized by the player) with 16 kHz audio: 40 ms
    video timestamps, one audio tag a frame resampled to 44.1 kHz, a
    capture cv2 decodes to the uploaded frames; every tag equal to the
    JAX player's."""
    import cv2

    frames = _frames(n=10)
    big = cv2.resize(frames[3], (352, 240))
    frames_in = frames[:3] + [big] + frames[4:]
    audio = _tone(16_000 // 25, 16_000)
    caps = {}
    for name, pmod, rmod in (("port", players, rtmp),
                             ("jax", jplayers, jrtmp)):
        server = rmod.MiniRTMPServer(str(tmp_path / f"{name}.flv"))
        _play(pmod.RTMPPlayer, server.url, frames_in, audio)
        server.stop()
        assert server.error is None, server.error
        caps[name] = server.tags
    assert caps["port"] == caps["jax"]
    tags = caps["port"]
    vts = [ts for t, ts, _ in tags if t == flv.TAG_VIDEO]
    ats = [ts for t, ts, _ in tags if t == flv.TAG_AUDIO]
    assert vts == [i * 40 for i in range(10)]
    assert ats == [i * 40 for i in range(10)]
    # 640 samples at 16 kHz resample to 1764 at 44.1 kHz a frame
    apay = [p for t, _, p in tags if t == flv.TAG_AUDIO]
    assert {len(p) for p in apay} == {1 + 2 * 1764}
    expect = frames[:3] + [cv2.resize(big, (176, 120))] + frames[4:]
    got = _read_all(str(tmp_path / "port.flv"))
    assert len(got) == 10
    for a, b in zip(got, expect):
        np.testing.assert_array_equal(a, b)


class _FakeStdin:
    def __init__(self):
        self.data = bytearray()
        self.closed = False

    def write(self, b):
        self.data += b

    def close(self):
        self.closed = True


class _FakeFFmpeg:
    """subprocess.Popen stand-in: records the command line and opens the
    audio fifo's read end, as ffmpeg would."""

    made: list = []

    def __init__(self, cmd, stdin=None):
        self.cmd = cmd
        self.stdin = _FakeStdin()
        self.returncode = None
        fifo = cmd[cmd.index("f32le") + 6]
        self._rfd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
        _FakeFFmpeg.made.append(self)

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        audio = b""
        while True:
            try:
                chunk = os.read(self._rfd, 1 << 16)
            except BlockingIOError:
                break
            if not chunk:
                break
            audio += chunk
        os.close(self._rfd)
        self.audio = audio
        self.returncode = 0
        return 0


def test_ffmpeg_backend_builds_the_jax_command_line(monkeypatch):
    """With ``shutil.which`` finding ffmpeg and ``subprocess.Popen``
    patched, the port's ffmpeg backend starts the same command line as
    JAX's (bgr24 on stdin, f32le audio through a named pipe, x264 + aac
    to flv), writes the same video and audio bytes, and removes its fifo
    on stop."""
    import shutil
    import subprocess

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/ffmpeg")
    monkeypatch.setattr(subprocess, "Popen", _FakeFFmpeg)
    frames = _frames(n=3)
    audio = _tone(24_000 // 25, 24_000)
    runs = {}
    for name, pmod in (("port", players), ("jax", jplayers)):
        _FakeFFmpeg.made = []
        p = pmod.RTMPPlayer("rtmp://127.0.0.1:1/live/k", 88, 60, fps=25)
        p.start_playing()
        for i, f in enumerate(frames):
            p.upload_frame({"frame": f, "audio": audio, "index": i})
        deadline = time.time() + 10.0
        while p.get_queue_length() > 0 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.1)
        fifo = p._audio_fifo
        p.stop_playing()
        (proc,) = _FakeFFmpeg.made
        assert proc.stdin.closed and not os.path.exists(fifo)
        cmd = [("<fifo>" if c == fifo else c) for c in proc.cmd]
        runs[name] = (cmd, bytes(proc.stdin.data), proc.audio)
    assert runs["port"] == runs["jax"]
    cmd, video, pcm = runs["port"]
    assert cmd[cmd.index("-s") + 1] == "88x60" and cmd[-1].startswith("rtmp")
    assert len(video) == 3 * 88 * 60 * 3
    assert pcm == np.tile(audio, 3).tobytes()


@pytest.mark.parametrize("backend", ["auto", "native", "ffmpeg"])
@pytest.mark.parametrize("have_ffmpeg", [True, False])
def test_rtmp_backend_choice_matches_jax(monkeypatch, backend, have_ffmpeg):
    """backend='auto' takes ffmpeg when the binary exists and the native
    push otherwise; 'ffmpeg' without the binary raises JAX's error."""
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: (
        "/usr/bin/ffmpeg" if have_ffmpeg else None))
    picked = {}
    for name, pmod in (("port", players), ("jax", jplayers)):
        calls = []

        def mkfifo(path):  # the ffmpeg backend's first step
            calls.append("ffmpeg")
            raise RuntimeError("stop")

        monkeypatch.setattr(pmod.RTMPPlayer, "_start_native",
                            lambda self: calls.append("native"))
        monkeypatch.setattr(os, "mkfifo", mkfifo)
        p = pmod.RTMPPlayer("rtmp://127.0.0.1:1/live/k", 8, 8,
                            backend=backend)
        try:
            p.start_playing()
        except RuntimeError as e:
            calls.append(str(e))
        picked[name] = calls
    assert picked["port"] == picked["jax"]
    with pytest.raises(ValueError, match="unknown RTMP backend"):
        players.RTMPPlayer("rtmp://h/live/k", 8, 8, backend="x")


def test_window_player_headless_raises_the_jax_error(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    errors = []
    for pmod in (players, jplayers):
        p = pmod.WindowPlayer()
        with pytest.raises(RuntimeError) as e:
            p.start_playing()
        assert not p.running
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "display" in errors[0]


def test_v4l2_output_format_matches_jax():
    for w, h in ((640, 480), (1080, 1920)):
        assert players.v4l2_output_format(w, h) == \
            jplayers.v4l2_output_format(w, h)
    assert players.VIDIOC_S_FMT == jplayers.VIDIOC_S_FMT == 0xC0D05605
    assert players.V4L2_PIX_FMT_BGR24 == jplayers.V4L2_PIX_FMT_BGR24


def test_virtual_camera_writes_frames_like_jax(tmp_path, monkeypatch):
    """VirtualCamPlayer into a regular file with ``fcntl.ioctl`` patched:
    one VIDIOC_S_FMT with the same struct, then each frame resized to the
    camera's size as raw BGR24, byte-equal to JAX's player; the fd closes
    on stop. A missing device raises JAX's message."""
    import fcntl

    ioctls = []
    monkeypatch.setattr(fcntl, "ioctl",
                        lambda fd, req, buf: ioctls.append((req, bytes(buf))))
    frames = _frames(n=3) + [_frames(1, h=60, w=88)[0]]
    written = {}
    for name, pmod in (("port", players), ("jax", jplayers)):
        dev = tmp_path / f"{name}_video0"
        dev.write_bytes(b"")
        p = pmod.VirtualCamPlayer(device=str(dev), width=176, height=120,
                                  fps=50)
        p.start_playing()
        for i, f in enumerate(frames):
            p.upload_frame({"frame": f, "audio": None, "index": i})
        deadline = time.time() + 10.0
        while p.get_queue_length() > 0 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.1)
        p.stop_playing()
        assert p._fd is None
        written[name] = dev.read_bytes()
    assert ioctls[0] == ioctls[1] == (
        players.VIDIOC_S_FMT, bytes(players.v4l2_output_format(176, 120)))
    assert written["port"] == written["jax"]
    assert len(written["port"]) == 4 * 176 * 120 * 3
    assert written["port"][:176 * 120 * 3] == frames[0].tobytes()

    errors = []
    for pmod in (players, jplayers):
        p = pmod.VirtualCamPlayer(device=str(tmp_path / "video99"))
        with pytest.raises(RuntimeError) as e:
            p.start_playing()
        assert not p.running
        errors.append(str(e.value).replace(str(tmp_path), "<tmp>"))
    assert errors[0] == errors[1] and "v4l2loopback" in errors[0]


def test_close_waits_for_a_stuck_render(tmp_path, monkeypatch):
    """A render stuck past stop_playing's join keeps the camera's fd open
    (closing it under a live write risks a reused fd), as in JAX."""
    import fcntl

    monkeypatch.setattr(fcntl, "ioctl", lambda fd, req, buf: None)
    gate, entered = threading.Event(), threading.Event()
    dev = tmp_path / "video0"
    dev.write_bytes(b"")
    p = players.VirtualCamPlayer(device=str(dev), width=8, height=8, fps=100)
    real = p._render

    def stuck(item):
        entered.set()
        gate.wait(timeout=30)
        real(item)

    p._render = stuck
    p.start_playing()
    p.upload_frame({"frame": np.zeros((8, 8, 3), np.uint8), "audio": None,
                    "index": 0})
    assert entered.wait(5)
    p.stop_playing()
    assert p._fd is not None
    gate.set()
    p._thread.join(timeout=5)
    p.stop_playing()
    assert p._fd is None and dev.read_bytes() == bytes(8 * 8 * 3)


# ----------------------------------------------------------------- serve

def _serve_args(module, monkeypatch, argv):
    seen = []
    monkeypatch.setattr(module, "cmd_serve", seen.append)
    module.main(["serve", "--assets", "a", "--ckpt", "c", "--hubert", "h"]
                + argv)
    return vars(seen[0])


@pytest.mark.parametrize("argv", [
    [],
    ["--player", "rtmp", "--rtmp-url", "rtmp://127.0.0.1:1935/live/x"],
    ["--player", "virtualcam", "--cam-device", "/dev/video7", "--width",
     "480", "--height", "640"],
    ["--player", "file", "--out", "o.mp4", "--interrupt"]])
def test_serve_parses_the_jax_player_flags(monkeypatch, argv):
    ours = _serve_args(cli, monkeypatch, argv)
    ref = _serve_args(jax_cli, monkeypatch, argv)
    assert ours.pop("device") is None
    for a in (ours, ref):
        a.pop("fn")
        a.pop("config", None)
    assert ours == ref
    if not argv:
        assert ours["player"] == "window"


def test_serve_players_are_the_jax_players(monkeypatch, tmp_path):
    """The player serve builds for each flag, and a virtual camera
    without its device raising JAX's message."""
    ns = _serve_args(cli, monkeypatch, [
        "--player", "virtualcam", "--cam-device", str(tmp_path / "none")])
    p = cli.build_player(type("A", (), ns), fps=25)
    assert isinstance(p, players.VirtualCamPlayer)
    assert (p.width, p.height, p.SAMPLE_RATE) == (1080, 1920, 24_000)
    with pytest.raises(RuntimeError) as ours:
        p.start_playing()
    with pytest.raises(RuntimeError) as ref:
        jplayers.VirtualCamPlayer(
            device=str(tmp_path / "none")).start_playing()
    assert str(ours.value) == str(ref.value)
    for flag, cls in (("window", players.WindowPlayer),
                      ("null", players.NullPlayer),
                      ("file", players.FilePlayer)):
        ns["player"] = flag
        assert type(cli.build_player(type("A", (), ns), fps=25)) is cls
    ns.update(player="rtmp", rtmp_url="rtmp://h/live/k")
    rp = cli.build_player(type("A", (), ns), fps=25)
    assert isinstance(rp, players.RTMPPlayer)
    assert (rp.push_url, rp.width, rp.height) == ("rtmp://h/live/k", 1080,
                                                  1920)
    ns["rtmp_url"] = None
    with pytest.raises(SystemExit, match="rtmp-url"):
        cli.build_player(type("A", (), ns), fps=25)
