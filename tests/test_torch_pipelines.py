"""The port's file-to-file and streaming managers, the adaptive transfer
format, the config loader, the media copies and the CLI against the JAX
package, on the CPU. Batch 4, at most ~15 frames, over the synthetic
step3 clip; a stub extractor returns seeded feature rows wherever HuBERT
itself is not under test (tests/test_torch_hubert.py holds HuBERT)."""

import dataclasses
import json
import os
import time

import cv2
import numpy as np
import pytest
import torch

from calipsync_tpu import config as jax_config
from calipsync_tpu.infer import synthesizer as jax_synth
from calipsync_tpu.media import mp4 as jax_mp4
from calipsync_tpu.nn.unet import Generator as JaxGenerator
from calipsync_tpu.pipelines.inference import \
    VideoStreamManager as JaxVideoStreamManager
from calipsync_tpu_torch import cli, config
from calipsync_tpu_torch.audio.hubert_pipeline import HubertFeatureExtractor
from calipsync_tpu_torch.audio.io import load_audio, save_wav
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              random_jax_generator)
from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
from calipsync_tpu_torch.media import mp4
from calipsync_tpu_torch.media.video import open_video_writer
from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel
from calipsync_tpu_torch.pipelines.inference import VideoStreamManager
from calipsync_tpu_torch.serve.players import NullPlayer
from calipsync_tpu_torch.serve.stream_manager import StreamingVideoManager

N_FRAMES = 10  # feature rows of the 0.4 s test wav


class _StubHubert:
    """Seeded (n, 2, 1024) rows, one a 640 samples at 16 kHz (one 25 fps
    frame); the stream yields them in blocks of 3."""

    def extract_from_file(self, path):
        n = max(1, len(load_audio(path, 16_000)) // 640)
        return np.random.default_rng(n).standard_normal(
            (n, 2, 1024)).astype(np.float32)

    def extract_from_file_stream(self, path):
        rows = self.extract_from_file(path)
        for i in range(0, len(rows), 3):
            yield rows[i:i + 3]


def _wav(path, seconds, hz, seed=0):
    t = np.arange(int(16_000 * seconds)) / 16_000
    noise = np.random.default_rng(seed).standard_normal(t.shape) * 0.02
    save_wav(str(path), (0.3 * np.sin(2 * np.pi * hz * t) + noise).astype(
        np.float32), 16_000)
    return str(path)


def _recorded(synth):
    """Wrap synth.iterate_synthesized_frames to keep every frame."""
    frames = []
    inner = synth.iterate_synthesized_frames

    def iterate(*args, **kwargs):
        for item in inner(*args, **kwargs):
            frames.append(item["frame"])
            yield item

    synth.iterate_synthesized_frames = iterate
    return frames


@pytest.fixture(scope="module")
def offline_runs(synthetic_step3_dir, tmp_path_factory):
    """One wav through the JAX manager (sequential) and the port's
    (sequential, and pipelined at spans of one batch), bgr, batch 4, on
    one set of random generator weights (every leaf random, scaled so the
    audio reaches the output)."""
    variables = random_jax_generator(seed=2)
    d = tmp_path_factory.mktemp("offline")
    wav = _wav(d / "clip.wav", N_FRAMES * 0.04, 180)
    data = str(synthetic_step3_dir)
    runs = {}
    synth = jax_synth.FrameSynthesizer(variables, data, model=JaxGenerator(),
                                       batch_size=4, seed=0,
                                       transfer_format="bgr")
    frames = _recorded(synth)
    out = JaxVideoStreamManager(synth, _StubHubert(), pipelined=False
                                ).process_single_file(wav, str(d / "j.mp4"))
    runs["jax"] = (out, frames)
    sd = from_jax_generator(variables)
    for name, pipelined in (("seq", False), ("pipe", True)):
        synth = FrameSynthesizer(sd, data, batch_size=4, seed=0,
                                 transfer_format="bgr", device="cpu")
        frames = _recorded(synth)
        mgr = VideoStreamManager(synth, _StubHubert(), pipelined=pipelined,
                                 span_rows=4 if pipelined else None)
        out = mgr.process_single_file(wav, str(d / f"{name}.mp4"))
        synth.close()
        runs[name] = (out, frames)
    runs["wav"] = wav
    return runs


def test_video_stream_manager_matches_jax(offline_runs):
    """The port's frames against the JAX manager's, at the bounds of
    test_frame_synthesizer_matches_jax (bgr: 1 LSB on <= 0.1%)."""
    (jout, jframes), (out, frames) = offline_runs["jax"], offline_runs["seq"]
    assert jout["frames"] == out["frames"] == len(frames) == N_FRAMES
    assert out["audio_side_car"] is None and out["ttff_s"] is not None
    changed = 0
    for x, y in zip(jframes, frames):
        assert x.shape == y.shape == (480, 480, 3)
        d = np.abs(x.astype(np.int16) - y.astype(np.int16))
        assert d.max() <= 1
        changed += int((d > 0).sum())
    assert changed <= 1e-3 * N_FRAMES * 480 * 480 * 3


def test_pipelined_equals_sequential(offline_runs):
    (seq, a), (pipe, b) = offline_runs["seq"], offline_runs["pipe"]
    assert seq["frames"] == pipe["frames"] == len(a) == len(b) == N_FRAMES
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_muxed_mp4_and_audio_match_jax(offline_runs):
    """Each mp4 holds the frames (read back by cv2) and a PCM track of the
    wav's length; the port's track reads back equal to the JAX one's."""
    rate, audio = mp4.read_pcm_audio(offline_runs["seq"][0]["output"])
    jrate, jaudio = jax_mp4.read_pcm_audio(offline_runs["jax"][0]["output"])
    assert rate == jrate == 24_000
    np.testing.assert_array_equal(audio, jaudio)
    assert len(audio) == N_FRAMES * 24_000 // 25
    for name in ("seq", "pipe"):
        path = offline_runs[name][0]["output"]
        assert mp4.has_pcm_audio(path)
        cap = cv2.VideoCapture(path)
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            assert frame.shape == (480, 480, 3)
            n += 1
        cap.release()
        assert n == N_FRAMES


def test_video_writer_that_cannot_open_raises(tmp_path):
    with pytest.raises(RuntimeError, match="could not open"):
        open_video_writer(str(tmp_path / "missing" / "x.mp4"), 25, 64, 64)


# (now, rows, wall) for each call: bootstrap on yuv420, measure bgr, take
# the winner, explore the loser after 30 s, small windows in their own class
_CALLS = [(0.0, 128, 0.5), (1.0, 128, 0.3), (2.0, 128, 0.4),
          (3.0, 25, 0.2), (4.0, 25, 0.05), (10.0, 128, 0.6),
          (40.0, 128, 0.2), (41.0, 128, 0.25), (42.0, 25, 0.3),
          (80.0, 25, 0.01), (81.0, 0, 0.1), (82.0, 128, 0.0)]


def _bandit(cls):
    """A synthesizer holding only the bandit's state, as constructed with
    transfer_format='adaptive' (its steps are not needed here)."""
    s = object.__new__(cls)
    s.transfer_format = "adaptive"
    s._active_format = "yuv420"
    s._fmt_fps = {}
    s._last_explore = 0.0
    return s


def test_adaptive_bandit_matches_jax(monkeypatch):
    ours, ref = _bandit(FrameSynthesizer), _bandit(jax_synth.FrameSynthesizer)
    clock = {"now": 0.0}
    monkeypatch.setattr(time, "time", lambda: clock["now"])
    choices = []
    for now, rows, wall in _CALLS:
        clock["now"] = now
        a, b = ours._choose_call_format(rows), ref._choose_call_format(rows)
        assert a == b
        choices.append(a)
        ours._note_call_fps(a, rows, wall)
        ref._note_call_fps(b, rows, wall)
        assert ours._fmt_fps == ref._fmt_fps
        assert ours._last_explore == ref._last_explore
    assert set(choices) == {"bgr", "yuv420"}


def test_streaming_manager_null_player(synthetic_step3_dir, tmp_path):
    """Adaptive synthesizer, warm-up of both formats, two wavs queued (one
    'danmu'): the danmu file plays first, then the normal one, one frame a
    feature row, with no producer error; warm-up and a second start raise
    while a session plays; close ends the synthesis thread and removes the
    temporary directory."""
    synth = FrameSynthesizer(None, str(synthetic_step3_dir), batch_size=4,
                             seed=0, transfer_format="adaptive",
                             first_batch_size=2, device="cpu")
    assert synth._active_format == "yuv420"
    assert set(synth._generate_resident_fns) == {"bgr", "yuv420"}
    played = []
    player = NullPlayer(fps=25, sample_rate=24_000,
                        on_frame=lambda item: played.append(item["audio"]))
    mgr = StreamingVideoManager(synth, _StubHubert(), player,
                                buffer_threshold=5,
                                synthesis_window_seconds=0.2)
    mgr.warmup()
    assert synth.transfer_format == "adaptive"
    normal = mgr.add_audio_to_queue(_wav(tmp_path / "a.wav", 0.28, 220))
    danmu = mgr.add_audio_to_queue(_wav(tmp_path / "b.wav", 0.12, 440, 1),
                                   queue_name="danmu")
    assert (normal, danmu) == (7, 3)
    expected = [b.original_audio_chunk for name in ("danmu", "normal")
                for b in list(mgr.audio_queues[name].queue)]
    mgr.start_playing()
    for busy in (mgr.warmup, mgr.start_playing):
        with pytest.raises(RuntimeError, match="still runs"):
            busy()
    deadline = time.monotonic() + 60
    while len(played) < len(expected) and time.monotonic() < deadline:
        time.sleep(0.05)
    mgr.close()
    synth.close()
    assert not mgr._thread._thread.is_alive()
    assert not os.path.exists(mgr._tmp)
    assert mgr.producer_errors == 0
    assert len(played) >= len(expected) == normal + danmu
    for got, want in zip(played, expected):
        np.testing.assert_array_equal(got, want)
    assert mgr.get_queue_lengths() == {"normal": 0, "danmu": 0}


def test_load_config_matches_jax(tmp_path):
    path = tmp_path / "cfg.json"
    sections = {"infer": {"batch_size": 16, "transfer_format": "bgr",
                          "first_window_batch": 2, "buffer_threshold_s": 0.5},
                "model": {"dtype": "bfloat16"},
                "crop": {"size": 160}, "train": {"epochs": 3}}
    path.write_text(json.dumps(sections))
    ours = config.load_config(path)
    # the JAX loader leaves a nested section a plain dict (ROADMAP.md C):
    # build its dataclasses from the same sections
    ref = jax_config.load_config(path)
    assert dataclasses.asdict(ours.infer) == dataclasses.asdict(
        jax_config.InferConfig(**ref.infer))
    # the port keeps the model keys its entry points read
    jax_model = jax_config.ModelConfig(**ref.model)
    assert dataclasses.asdict(ours.model) == {
        f.name: getattr(jax_model, f.name)
        for f in dataclasses.fields(ours.model)}
    assert dataclasses.asdict(config.load_config().infer) == \
        dataclasses.asdict(jax_config.load_config().infer)
    assert config.load_config().infer.transfer_format == "adaptive"
    for bad in ({"mesh": {"model": 2}}, {"mesh": {"dcn": 2}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            config.load_config(overrides=bad)


def test_cli_featurize_on_cpu(tmp_path, capsys, monkeypatch):
    """`featurize` from an HF-layout checkpoint directory the test writes
    (a tiny config), on the CPU; without --device and without CUDA it
    raises."""
    cfg = HubertConfig(hidden_size=24, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=48,
                       conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2),
                       conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                       num_conv_pos_embedding_groups=4)
    torch.manual_seed(0)
    model = HubertModel(cfg)
    ckpt = tmp_path / "hubert"
    ckpt.mkdir()
    torch.save(model.state_dict(), ckpt / "pytorch_model.bin")
    (ckpt / "config.json").write_text(json.dumps(
        {**dataclasses.asdict(cfg), "model_type": "hubert"}))
    wav = _wav(tmp_path / "a.wav", 1.0, 300)
    out = tmp_path / "feats.npy"
    cli.main(["featurize", "--hubert", str(ckpt), "--audio", wav,
              "--out", str(out), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    feats = np.load(out)
    assert printed["shape"] == list(feats.shape) == [(16_000 - 80) // 640,
                                                     2, 24]
    ref = HubertFeatureExtractor(model.state_dict(), cfg, device="cpu"
                                 ).extract_from_file(wav)
    np.testing.assert_array_equal(feats, ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["featurize", "--hubert", str(ckpt), "--audio", wav,
                  "--out", str(out)])
