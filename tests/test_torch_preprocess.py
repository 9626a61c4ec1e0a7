"""Steps 1 and 3 and ``clone`` of the port against the JAX pipelines on the
CPU, file by file, on a synthetic 10-frame 320x320 video with a wav
side-car (the recipe of tests/test_pipelines_e2e.py). Both packages run a
stubbed face detector (fixed boxes: random weights find no face) in front
of a real PFLD on one set of seeded weights, and a tiny HuBERT on one set
of random weights; the CLI commands run in-process with ``--device cpu``
on seeded weights in the reference's layout."""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.audio.hubert_pipeline import \
    HubertFeatureExtractor as JaxExtractor
from calipsync_tpu.nn import hubert as jax_hubert
from calipsync_tpu.nn import pfld as jpfld
from calipsync_tpu.pipelines.step1_preprocess import \
    TrainPreprocessor as JaxTrain
from calipsync_tpu.pipelines.step3_prepare import \
    InferPreprocessor as JaxInfer
from calipsync_tpu.vision.lip_detector import LipDetector as JaxLipDetector
from calipsync_tpu.vision.xseg import XSegMaskGenerator as JaxXSeg
from calipsync_tpu_torch import cli
from calipsync_tpu_torch.audio.hubert_pipeline import HubertFeatureExtractor
from calipsync_tpu_torch.audio.io import load_audio, save_wav
from calipsync_tpu_torch.bench_assets import (mean_face, random_pfld_state,
                                              write_face_weights)
from calipsync_tpu_torch.config import ModelConfig, PipelineConfig, \
    TrainConfig
from calipsync_tpu_torch.core.weights import from_jax_hubert, \
    random_jax_hubert
from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel
from calipsync_tpu_torch.nn.pfld import fold_mobileone
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.pipelines.all_pipeline import clone_video_local
from calipsync_tpu_torch.pipelines.step1_preprocess import (
    TrainPreprocessor, frame_rms_db)
from calipsync_tpu_torch.pipelines.step3_prepare import InferPreprocessor
from calipsync_tpu_torch.vision.lip_detector import LipDetector
from calipsync_tpu_torch.vision.xseg import XSegMaskGenerator


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


HUBERT_RTOL, HUBERT_ATOL = 1e-4, 1e-5  # tests/test_torch_hubert.py
TINY = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), conv_bias=True,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


class _StubFaces:
    """Fixed boxes on every frame, one inside and one past the edge."""

    def detect(self, images):
        boxes = np.array([[60.0, 70.5, 170.0, 180.0],
                          [250.0, -20.0, 100.0, 90.0]], np.float32)
        return [(boxes, [0, 1]) for _ in images]


class _StubHubert:
    """Seeded (n, 2, 1024) rows, one a 640 samples: the generator's width,
    for the clone's training."""

    def extract(self, speech):
        n = max(4, len(speech) // 640)
        return np.random.default_rng(0).standard_normal(
            (n, 2, 1024)).astype(np.float32)


def _xseg_session(img):
    """A stand-in segmentation net: (1, 256, 256, 3) -> (1, 256, 256, 1)."""
    return img[..., 1:2] * 0.8 + 0.1


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("video")
    path = str(d / "speaker.mp4")
    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (320, 320))
    for _ in range(10):
        vw.write(rng.integers(0, 256, (320, 320, 3)).astype(np.uint8))
    vw.release()
    t = np.linspace(0, 1.0, 16_000, endpoint=False)
    save_wav(str(d / "speaker.wav"),
             (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 16_000)
    return path


@pytest.fixture(scope="module")
def detectors():
    """(JAX LipDetector, port LipDetector) on one set of PFLD weights."""
    sd = random_pfld_state(seed=3)
    folded = jpfld.fold_mobileone_params(jpfld.import_pfld(
        {k: v.numpy() for k, v in sd.items()}))
    face = mean_face(0)
    ours = LipDetector(fold_mobileone(sd), face, _StubFaces(), device="cpu")
    yield JaxLipDetector(folded, face, _StubFaces()), ours
    ours.close()


@pytest.fixture(scope="module")
def hubert_pair():
    jcfg = jax_hubert.HubertConfig(**TINY)
    cfg = HubertConfig(**TINY)
    variables = random_jax_hubert(cfg, seed=4)
    model = HubertModel(cfg).eval()
    model.load_state_dict(from_jax_hubert(variables, cfg), strict=True)
    return (JaxExtractor(jax.tree_util.tree_map(jnp.asarray, variables),
                         jcfg),
            HubertFeatureExtractor(None, model=model, device="cpu"))


def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def _assert_same_files(a, b, skip=()):
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        if name not in skip:
            assert fa[name].read_bytes() == fb[name].read_bytes(), name
    return fa


@pytest.fixture(scope="module")
def step_dirs(video, detectors, hubert_pair, tmp_path_factory):
    root = tmp_path_factory.mktemp("steps")
    jax_lip, lip = detectors
    jax_hu, hu = hubert_pair
    out = {}
    for name, train in (("jax1", JaxTrain(jax_lip, jax_hu, batch_size=4)),
                        ("port1", TrainPreprocessor(lip, hu, batch_size=4))):
        out[name] = (str(root / name),
                     train.process_video(video, str(root / name)))
    for name, infer in (
            ("jax3", JaxInfer(jax_lip, batch_size=4, mask_generator=JaxXSeg(
                session=_xseg_session))),
            ("port3", InferPreprocessor(lip, batch_size=4,
                                        mask_generator=XSegMaskGenerator(
                                            session=_xseg_session)))):
        out[name] = (str(root / name),
                     infer.process_video(video, str(root / name)))
    return out


def test_step1_matches_jax_file_by_file(step_dirs):
    (ref_dir, ref), (our_dir, ours) = step_dirs["jax1"], step_dirs["port1"]
    assert ours["total_frames"] == ref["total_frames"] == 10
    files = _assert_same_files(ref_dir, our_dir, skip=("aud_hu.npy",))
    for sub, ext in (("full_body_img", "jpg"), ("landmarks", "lms"),
                     ("faces", "jpg")):
        assert all(f"{sub}/{i}.{ext}" in files for i in range(10))
    feats = np.load(os.path.join(our_dir, "aud_hu.npy"))
    assert feats.shape[1:] == (2, 24)
    np.testing.assert_allclose(
        feats, np.load(os.path.join(ref_dir, "aud_hu.npy")),
        rtol=HUBERT_RTOL, atol=HUBERT_ATOL)


def test_step3_matches_jax_file_by_file(step_dirs):
    (ref_dir, ref), (our_dir, ours) = step_dirs["jax3"], step_dirs["port3"]
    assert ours["processed_frames"] == ref["processed_frames"] == 10
    files = _assert_same_files(ref_dir, our_dir)
    for sub, ext in (("frames", "jpg"), ("positions", "txt"),
                     ("lips_jpg", "jpg"), ("masks", "jpg")):
        assert all(f"infer_data/{sub}/{i:06d}.{ext}" in files
                   for i in range(10))
    assert "sample.jpg" in files


def test_silence_gate_and_long_audio_modes(video, detectors, tmp_path):
    from calipsync_tpu.pipelines.step1_preprocess import \
        frame_rms_db as jax_rms_db

    wav = load_audio(video.replace(".mp4", ".wav"), 16_000)
    assert frame_rms_db(wav) == jax_rms_db(wav)
    assert frame_rms_db(np.zeros(4000, np.float32)) == -100.0
    with pytest.raises(ValueError, match="long_audio"):
        TrainPreprocessor(detectors[1], _StubHubert(), long_audio="all")
    silent = tmp_path / "silent.wav"
    save_wav(str(silent), np.zeros(16_000, np.float32), 16_000)
    with pytest.raises(RuntimeError, match="too low"):
        TrainPreprocessor(detectors[1], _StubHubert(), min_db=-50.0
                          ).process_video(video, str(tmp_path / "s1"),
                                          audio_path=str(silent))


def test_clone_runs_the_three_stages(video, detectors, step_dirs,
                                     tmp_path):
    """step 1 -> train (one attention block, one epoch) -> step 3 ->
    cleanup on the CPU; the inference assets equal the JAX step 3's."""
    cfg = PipelineConfig(model=ModelConfig(n_blocks=1),
                         train=TrainConfig(batch_size=2, epochs=1,
                                           num_workers=2,
                                           perceptual_weight=0.0))
    timings = {}
    generator, model_id = clone_video_local(
        video, str(tmp_path), detectors[1], _StubHubert(), cfg=cfg,
        timings=timings, device="cpu")
    model_dir = tmp_path / model_id
    assert set(timings) == {"step1_s", "step2_s", "step3_s", "total_s"}
    for gone in ("full_body_img", "landmarks", "faces", "aud_hu.npy",
                 "aud.wav"):
        assert not (model_dir / gone).exists()
    sd = torch.load(generator, weights_only=True)
    Generator(n_blocks=1).load_state_dict(sd, strict=True)
    jax_infer = pathlib.Path(step_dirs["jax3"][0]) / "infer_data"
    for sub in ("frames", "positions", "lips_jpg"):
        _assert_same_files(jax_infer / sub, model_dir / "infer_data" / sub)


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory):
    """Seeded face weights in the reference's layout and a tiny HuBERT in
    the HF layout."""
    root = tmp_path_factory.mktemp("cli")
    weights = write_face_weights(str(root / "weights"), seed=0)
    cfg = HubertConfig(**TINY)
    torch.manual_seed(0)
    hub = root / "hubert"
    hub.mkdir()
    torch.save(HubertModel(cfg).state_dict(), hub / "pytorch_model.bin")
    (hub / "config.json").write_text(json.dumps(
        {**dataclasses.asdict(cfg), "model_type": "hubert"}))
    return weights, str(hub)


def test_cli_step1_and_step3_on_cpu(video, cli_assets, tmp_path, capsys,
                                    monkeypatch):
    """The S3FD arranged by write_face_weights fires on every frame, so
    every frame gets landmarks; without --device and without CUDA the
    commands raise."""
    weights, hub = cli_assets
    cli.main(["step1", "--video", video, "--out", str(tmp_path / "s1"),
              "--weights", weights, "--hubert", hub, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_frames"] == 10
    s1 = _files(tmp_path / "s1")
    for i in range(10):
        assert f"landmarks/{i}.lms" in s1 and f"full_body_img/{i}.jpg" in s1
    assert np.load(tmp_path / "s1" / "aud_hu.npy").shape[1:] == (2, 24)

    cli.main(["step3", "--video", video, "--out", str(tmp_path / "s3"),
              "--weights", weights, "--detect-stride", "2",
              "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["processed_frames"] == 10
    s3 = _files(tmp_path / "s3" / "infer_data")
    assert all(f"positions/{i:06d}.txt" in s3 for i in range(10))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["step3", "--video", video, "--out", str(tmp_path / "x"),
                  "--weights", weights])


@pytest.mark.parametrize("yolo", [False, True])
def test_build_lip_detector_follows_the_reference_priority(video, tmp_path,
                                                           yolo):
    """YOLOv8n-face when its state_dict is in the directory, S3FD
    otherwise (the JAX cli.build_lip_detector's priority); either detector,
    arranged by write_face_weights to fire, gives every frame landmarks."""
    import cv2

    from calipsync_tpu_torch.nn.s3fd import S3FDDetector
    from calipsync_tpu_torch.nn.yolo import YoloV8FaceDetector

    weights = write_face_weights(str(tmp_path / "weights"), seed=0,
                                 yolo=yolo)
    lip = cli.build_lip_detector(weights, device="cpu")
    try:
        assert isinstance(lip.detector,
                          YoloV8FaceDetector if yolo else S3FDDetector)
        cap = cv2.VideoCapture(video)
        frames = [cap.read()[1] for _ in range(2)]
        cap.release()
        for lms in lip.submit(frames).result():
            assert lms is not None and lms[0].shape == (110, 2)
            assert lms[0].dtype == np.int32
    finally:
        lip.close()
