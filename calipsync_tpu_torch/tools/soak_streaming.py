"""Real-time streaming soak (counterpart of tools/soak_streaming.py): the
whole ``StreamingVideoManager`` loop (HuBERT featurization, the priority
queues, synthesis windows, the audio-pegged player) for ``--soak-seconds``
of wall clock, with 4 s wavs dropped in every 7 s (every third on the
'danmu' queue). Reports the frames played against 25 fps, the player's
A/V drift, the first frame's stage times, producer errors, peak RSS and
the queue's health.

  - ``--soak-faults``: a synthesis error every 13th window and a render
    error every 97th frame; the producer's catch-and-backoff and the
    player's clock must hold the drift within one frame.
  - ``--soak-interrupt``: the manager in interrupt mode ('danmu'
    preempts a file mid-way).
  - ``--soak-player rtmp``: the native RTMP pusher
    (``serve/players.py``, FSV1 + PCM) into ``media/rtmp.py``'s loopback
    ingest, run in a child process as a real ingest runs outside the
    pusher's; the capture is then read back (tags, 40 ms timestamps, every
    frame decoded by cv2).
  - ``--soak-hubert real``: HuBERT-large in bf16, random weights (the
    default); ``toy``: a 2-layer one.

The generator is bf16 with seeded random weights on a synthetic speaker.

    python -m calipsync_tpu_torch.tools.soak_streaming [--device cpu]
        [--soak-seconds 60] [--soak-batch 32] [--soak-res 480]
        [--soak-first-batch 4] [--soak-faults] [--soak-interrupt]
        [--soak-player null|rtmp] [--soak-hubert real|toy]
        [--out chiprun_out/soak_streaming.json]
"""

from __future__ import annotations

import os
import resource
import tempfile
import time

import numpy as np

SAMPLE_RATE = 24_000


def _ingest(capture: str, conn) -> None:
    """The ingest's child process: serve one publisher, write the
    capture, report the server's error."""
    from calipsync_tpu_torch.media.rtmp import MiniRTMPServer

    server = MiniRTMPServer(capture)
    conn.send(server.url)
    server.finished.wait()
    conn.send(repr(server.error) if server.error else None)


def rtmp_report(capture: str) -> dict:
    """The capture read back: its tags, whether the video timestamps are
    40 ms apart, and the frames cv2 decodes."""
    import cv2

    from calipsync_tpu_torch.media.flv import (TAG_AUDIO, TAG_VIDEO,
                                               read_flv_tags)

    tags = list(read_flv_tags(capture))
    vts = [ts for t, ts, _ in tags if t == TAG_VIDEO]
    cap = cv2.VideoCapture(capture)
    decoded = 0
    while cap.read()[0]:
        decoded += 1
    cap.release()
    deltas = np.diff(vts)
    return {"captured_video_tags": len(vts),
            "captured_audio_tags": sum(t == TAG_AUDIO for t, _, _ in tags),
            "decoded_frames": decoded,
            "ts_paced_40ms": bool(len(deltas)
                                  and np.all(np.abs(deltas - 40) <= 1)),
            "capture_bytes": os.path.getsize(capture)}


def main(argv=None) -> dict:
    import multiprocessing as mp

    import torch

    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker
    from calipsync_tpu_torch.config import ModelConfig
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.serve.players import NullPlayer, RTMPPlayer
    from calipsync_tpu_torch.serve.stream_manager import \
        StreamingVideoManager
    from calipsync_tpu_torch.tools import (device_report, make_hubert,
                                           parser, write_report)
    from calipsync_tpu_torch.train.trainer import build_model

    ap = parser("soak_streaming", __doc__)
    ap.add_argument("--soak-seconds", type=float, default=60.0)
    ap.add_argument("--soak-batch", type=int, default=32)
    ap.add_argument("--soak-res", type=int, default=480)
    ap.add_argument("--soak-first-batch", type=int, default=4)
    ap.add_argument("--soak-faults", action="store_true")
    ap.add_argument("--soak-interrupt", action="store_true")
    ap.add_argument("--soak-player", "--player", choices=("null", "rtmp"),
                    default="null")
    ap.add_argument("--soak-hubert", "--hubert", choices=("real", "toy"),
                    default="real")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res, faults = args.soak_res, args.soak_faults

    hubert = make_hubert(args.soak_hubert, torch.bfloat16, device, seed=0)
    model = build_model(ModelConfig(dtype="bfloat16"), seed=0)
    render_faults = {"n": 0}

    class _FaultyNullPlayer(NullPlayer):
        """A render error every 97th frame with ``--soak-faults``: the
        player drops the frame and its audio clock goes on."""

        def _render(self, item):
            render_faults["n"] += 1
            if faults and render_faults["n"] % 97 == 0:
                raise RuntimeError("injected render fault")

    played: list = []
    ingest = conn = None
    with tempfile.TemporaryDirectory() as tmp:
        assets = make_synthetic_speaker(tmp, res=res)
        synth = FrameSynthesizer(None, assets, model=model,
                                 batch_size=args.soak_batch, seed=0,
                                 transfer_format="yuv420",
                                 first_batch_size=args.soak_first_batch,
                                 device=device)
        on_frame = lambda item: played.append(time.monotonic())  # noqa
        if args.soak_player == "rtmp":
            capture = os.path.join(tmp, "capture.flv")
            ctx = mp.get_context("spawn")
            conn, child = ctx.Pipe()
            ingest = ctx.Process(target=_ingest, args=(capture, child),
                                 daemon=True)
            ingest.start()
            if not conn.poll(120):
                raise RuntimeError("the RTMP ingest did not start")
            player = RTMPPlayer(conn.recv(), width=res, height=res,
                                backend="native", fps=25,
                                sample_rate=SAMPLE_RATE, on_frame=on_frame)
        else:
            player = _FaultyNullPlayer(fps=25, sample_rate=SAMPLE_RATE,
                                       on_frame=on_frame)
        mgr = StreamingVideoManager(synth, hubert, player,
                                    buffer_threshold=25,
                                    synthesis_window_seconds=1.0,
                                    is_interrupt=args.soak_interrupt)
        try:
            def tone(name, dur, freq):
                p = os.path.join(tmp, name)
                t = np.linspace(0, dur, int(16_000 * dur), endpoint=False)
                save_wav(p, (0.3 * np.sin(2 * np.pi * freq * t)).astype(
                    np.float32), 16_000)
                return p

            clips = [tone(f"clip{i}.wav", 4.0, 150 + 40 * i)
                     for i in range(4)]
            t_warm = time.monotonic()
            mgr.warmup()
            warmup_s = time.monotonic() - t_warm
            if faults:
                real_iter = synth.iterate_synthesized_frames
                windows = {"n": 0}

                def flaky_iter(*a, **kw):
                    windows["n"] += 1
                    if windows["n"] % 13 == 0:
                        raise RuntimeError("injected synthesis fault")
                    return real_iter(*a, **kw)

                synth.iterate_synthesized_frames = flaky_iter
            mgr.start_playing()
            t0 = time.monotonic()
            i = 0
            while time.monotonic() - t0 < args.soak_seconds:
                if time.monotonic() - t0 > i * 7.0:
                    mgr.add_audio_to_queue(
                        clips[i % len(clips)],
                        queue_name="danmu" if i % 3 == 2 else "normal")
                    i += 1
                time.sleep(0.25)
            drift = player.av_drift()
            samples = player.samples_played
            mgr.stop_playing()
            elapsed = time.monotonic() - t0
            rtmp = None
            if ingest is not None:
                if not conn.poll(120):
                    raise RuntimeError("the RTMP ingest wrote no capture")
                error = conn.recv()
                ingest.join(30)
                rtmp = {**rtmp_report(capture), "server_error": error}
        finally:
            mgr.close()
            if ingest is not None and ingest.is_alive():
                ingest.kill()
                ingest.join()

    if not played:
        raise RuntimeError("no frame was played")
    marks = dict(mgr.ttf_marks)
    base = marks.pop("producer_start", t0)
    n = len(played)
    out = {
        "wall_s": elapsed, "warmup_s": warmup_s, "frames_played": n,
        "hubert": args.soak_hubert,
        "first_frame_after_s": played[0] - t0,
        "ttf_stages_s": {k: v - base for k, v in marks.items()},
        "mean_frame_period_s": (played[-1] - played[0]) / max(n - 1, 1),
        "expected_period_s": 0.04,
        "audio_seconds_played": samples / SAMPLE_RATE,
        "av_drift_s": drift,
        "producer_errors": mgr.producer_errors,
        "faults_injected": faults,
        "interrupt_mode": args.soak_interrupt,
        "render_fault_count": render_faults["n"] // 97 if faults else 0,
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        **device_report(device)}
    if rtmp is not None:
        out["player"] = "rtmp_native"
        out["rtmp"] = rtmp
    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
