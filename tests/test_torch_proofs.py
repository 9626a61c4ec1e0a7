"""The port's proof tools (calipsync_tpu_torch/tools/) and the pieces they
need, against the JAX package and the JAX tools on the CPU: ``save_config``,
the clone tools' data builders, the held-out evaluator,
``clone_video_local``'s ``cleanup`` and ``xseg_model_path``, and one run of
``clone_proof.main`` at the tiniest sizes.

The JAX tool tools/clone_proof.py is loaded by its path (it is a script,
not a package module). The evaluator's JAX side is the JAX tools' eval
function, written out here as they write it inside their ``main``."""

import importlib.util
import json
import math
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu import config as jax_config
from calipsync_tpu.audio.windows import batched_windows as jax_windows
from calipsync_tpu.train import trainer as jax_trainer
from calipsync_tpu_torch import config
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              random_jax_generator)
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.pipelines import step2_train
from calipsync_tpu_torch.pipelines.all_pipeline import clone_video_local
from calipsync_tpu_torch.tools import HoldoutEvaluator, clone_proof
from calipsync_tpu_torch.vision import xseg
from calipsync_tpu_torch.vision.xseg import XSegMaskGenerator

REPO = pathlib.Path(__file__).resolve().parents[1]
# PSNR of the port's evaluator against the JAX tools' on the same weights
# and samples, fp32
PSNR_ATOL_DB = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as the port's other test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_save_config_matches_jax(tmp_path):
    """A non-default config saved by the port: it loads back equal in the
    port; its JSON is JAX's save_config JSON of the same settings without
    the sections the port drops (``audio``, ``model.attn_impl``); and JAX's
    load_config reads it as it reads JAX's own file, section by section
    (JAX's loader leaves nested sections as dicts), JAX's default
    ``audio`` standing in for the missing one."""
    settings = dict(
        crop=dict(mask_w=140, mask_h=130),
        model=dict(n_blocks=2, dtype="bfloat16"),
        train=dict(batch_size=8, epochs=3, steps_per_dispatch=4,
                   zero1=True, grad_accum=2),
        mesh=dict(data=2, model=2, hubert_parallel="pp"),
        infer=dict(batch_size=16, transfer_format="yuv420",
                   first_window_batch=0))
    ours = config.PipelineConfig(**{
        k: getattr(config, f"{k.title()}Config")(**v)
        for k, v in settings.items()})
    theirs = jax_config.PipelineConfig(**{
        k: getattr(jax_config, f"{k.title()}Config")(**v)
        for k, v in settings.items()})
    port_file, jax_file = tmp_path / "port.json", tmp_path / "jax.json"
    config.save_config(ours, port_file)
    jax_config.save_config(theirs, jax_file)

    assert config.load_config(port_file) == ours
    written, ref = (json.loads(p.read_text()) for p in (port_file, jax_file))
    del ref["audio"], ref["model"]["attn_impl"]
    assert written == ref

    from_port, from_jax = (jax_config.load_config(p)
                           for p in (port_file, jax_file))
    for section in settings:
        expected = getattr(from_jax, section)
        if section == "model":
            expected = {k: v for k, v in expected.items()
                        if k != "attn_impl"}
        assert getattr(from_port, section) == expected, section
    assert from_port.audio == jax_config.AudioConfig()
    assert from_port.model["dtype"] == "bfloat16"


def test_data_builders_bit_equal_to_jax_tool(tmp_path):
    """tools/clone_proof.py's builders against the port's copies: the
    landmarks and the fixed detector, the audio and mouth envelope, a 1 s
    clip at 160x160 (the wav's bytes, every decoded frame) and its mouth
    crops."""
    import cv2

    ref = _jax_tool("clone_proof")
    res, seconds = 160, 1.0
    np.testing.assert_array_equal(clone_proof.make_landmarks(res),
                                  ref.make_landmarks(res))
    img = np.zeros((res, res, 3), np.uint8)
    np.testing.assert_array_equal(
        clone_proof.FixedLipDetector(res).detect_landmarks([img])[0][0],
        ref.FixedLipDetector(res).detect_landmarks([img])[0][0])
    audio = clone_proof.speech_like_audio(seconds, 5)
    np.testing.assert_array_equal(audio, ref.speech_like_audio(seconds, 5))
    np.testing.assert_array_equal(
        clone_proof.mouth_open_per_frame(audio, 25),
        ref.mouth_open_per_frame(audio, 25))

    frames = {}
    for name, module in (("port", clone_proof), ("jax", ref)):
        path = str(tmp_path / f"{name}.mp4")
        wav = module.make_talking_video(path, res, seconds, seed=3)
        cap = cv2.VideoCapture(path)
        read = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            read.append(frame)
        cap.release()
        frames[name] = (np.stack(read), pathlib.Path(wav).read_bytes())
    (ours, our_wav), (theirs, their_wav) = frames["port"], frames["jax"]
    assert ours.shape == (25, res, res, 3)
    np.testing.assert_array_equal(ours, theirs)
    assert our_wav == their_wav
    lms = clone_proof.make_landmarks(res)
    for frame in ours:
        np.testing.assert_array_equal(clone_proof.crop_mouth(frame, lms),
                                      ref.crop_mouth(frame, lms))


def _jax_eval(variables, store, feats, e_idx, e_fidx, e_ex):
    """The JAX tools' eval function (tools/train_proof.py ``eval_fn``)."""
    crop = jax_config.CropConfig()
    model = jax_trainer.build_model(jax_config.ModelConfig(n_blocks=1),
                                    axis_name=None)
    y0, y1 = crop.mask_y, crop.mask_y + crop.mask_h
    x0, x1 = crop.mask_x, crop.mask_x + crop.mask_w
    size = crop.size

    @jax.jit
    def eval_fn(variables, store, idx, fidx, ex, audio_feats):
        real_u8 = jnp.take(store, fidx, axis=0).reshape(-1, size, size, 3)
        ref_u8 = jnp.take(store, ex, axis=0).reshape(-1, size, size, 3)
        real = real_u8.astype(jnp.float32) / 255.0
        masked = real.at[:, y0:y1, x0:x1, :].set(0.0)
        imgs = jnp.concatenate([ref_u8.astype(jnp.float32) / 255.0, masked],
                               axis=-1)
        audio = jax_windows(audio_feats, idx, mode=model.mode)
        pred = model.apply(variables, imgs, audio, train=False)
        return pred.astype(jnp.float32), real

    pred, real = eval_fn(jax.tree_util.tree_map(jnp.asarray, variables),
                         jnp.asarray(store), jnp.asarray(e_idx),
                         jnp.asarray(e_fidx), jnp.asarray(e_ex),
                         jnp.asarray(feats))
    p = np.clip(np.asarray(pred), 0.0, 1.0)
    r = np.asarray(real)
    m = np.zeros((size, size), bool)
    m[y0:y1, x0:x1] = True

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64))
                            ** 2))
        return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))

    return {"psnr_full": psnr(p, r), "psnr_mouth_rect": psnr(p[:, m], r[:, m]),
            "psnr_outside_rect": psnr(p[:, ~m], r[:, ~m])}


def test_evaluator_matches_jax():
    """HoldoutEvaluator against the JAX tools' evaluator: the same
    one-block generator (JAX variables carried across by key), a 2-sample
    held-out set over a 3-frame store with train_proof's index rules
    (reference 7 frames on), in fp32: the three PSNRs within
    PSNR_ATOL_DB."""
    rng = np.random.default_rng(11)
    store = rng.integers(0, 256, (3, 160 * 160 * 3), dtype=np.uint8)
    feats = rng.standard_normal((5, 2, 1024)).astype(np.float32)
    n_samples, n_frames, n_eval, offset = len(feats) - 1, 3, 2, 7
    e_idx = np.arange(n_eval, dtype=np.int32) % (n_samples - 1)
    e_fidx = np.minimum(e_idx, n_frames - 1).astype(np.int32)
    e_ex = ((e_fidx + offset) % n_frames).astype(np.int32)
    variables = random_jax_generator(n_blocks=1, seed=3)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(_jax_eval, variables, store, feats, e_idx,
                              e_fidx, e_ex)
        model = Generator(n_blocks=1)
        model.load_state_dict(from_jax_generator(variables, n_blocks=1),
                              strict=True)
        ours = HoldoutEvaluator(torch.from_numpy(store),
                                torch.from_numpy(feats), n_samples, n_frames,
                                n_eval, offset)(model)
        ref = pending.result()
    assert set(ours) == set(ref)
    for key in ref:
        assert abs(ours[key] - ref[key]) <= PSNR_ATOL_DB, (key, ours, ref)
    assert not model.training


class _StubHubert:
    """(T/2, 2, 1024) zero rows at HuBERT's rate, without a model."""

    def extract(self, audio):
        return np.zeros(((len(audio) - 80) // 640, 2, 1024), np.float32)

    extract_auto = extract


def _xseg_session(img):
    """A stand-in segmentation net, as tests/test_torch_preprocess.py's."""
    return img[..., 1:2] * 0.8 + 0.1


def test_clone_keeps_intermediates_and_builds_xseg(tmp_path, monkeypatch):
    """clone_video_local(cleanup=False) keeps step 1's training data, and
    xseg_model_path builds the XSeg mask generator from that path for step
    3, which then writes a mask a frame. Step 2 and the XSeg net are
    stand-ins (no xseg.onnx is in the repository; step 2 has its own
    tests)."""
    made = []

    def xseg_from(model_path=None):
        made.append(model_path)
        return XSegMaskGenerator(session=_xseg_session)

    def train(dataset_dir, save_dir, **kw):
        pathlib.Path(save_dir).mkdir(parents=True)
        return str(pathlib.Path(save_dir) / "step_1.pt")

    monkeypatch.setattr(xseg, "XSegMaskGenerator", xseg_from)
    monkeypatch.setattr(step2_train, "train_digital_model", train)
    video = str(tmp_path / "talk.mp4")
    clone_proof.make_talking_video(video, 160, 0.4, seed=1)
    onnx = str(tmp_path / "xseg.onnx")
    timings: dict = {}
    generator, model_id = clone_video_local(
        video, str(tmp_path), clone_proof.FixedLipDetector(160),
        _StubHubert(), cleanup=False, xseg_model_path=onnx,
        timings=timings, device="cpu")
    model_dir = tmp_path / model_id
    assert made == [onnx]
    assert generator == str(model_dir / "weights" / "generator.pth")
    assert set(timings) == {"step1_s", "step2_s", "step3_s", "total_s"}
    for kept in ("full_body_img", "landmarks", "faces", "aud.wav",
                 "aud_hu.npy"):
        assert (model_dir / kept).exists(), kept
    n = len(list((model_dir / "full_body_img").glob("*.jpg")))
    assert n == 10
    masks = sorted((model_dir / "infer_data" / "masks").glob("*.jpg"))
    assert len(masks) == n


def _keys(d: dict, prefix: str = "") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def _numbers(d):
    if isinstance(d, dict):
        for v in d.values():
            yield from _numbers(v)
    elif isinstance(d, (int, float)) and not isinstance(d, bool):
        yield d


def test_clone_proof_main_on_cpu(tmp_path):
    """clone_proof.main at the tiniest sizes on the CPU (a 1 s clip at
    160x160, a 0.32 s held-out clip, one epoch at B=2, one SyncNet epoch,
    the 2-layer HuBERT): its report has every key of the JAX tool's
    CLONE_r04.json, finite numbers, and says what ran it."""
    out = str(tmp_path / "clone.json")
    report = clone_proof.main([
        "--device", "cpu", "--clone-seconds", "1",
        "--clone-hold-seconds", "0.32", "--clone-res", "160",
        "--clone-epochs", "1", "--clone-batch", "2",
        "--clone-sync-epochs", "1", "--hubert", "toy", "--out", out])
    assert json.loads(pathlib.Path(out).read_text()) == report
    schema = json.loads((REPO / "CLONE_r04.json").read_text())
    assert _keys(schema) <= _keys(report), _keys(schema) - _keys(report)
    assert all(math.isfinite(x) for x in _numbers(report))
    assert report["platform"] == "cpu" and report["init"] == "torch seeded"
    assert report["infer"]["frames"] == 7
    assert report["sync_produced"]["n_frames"] == 7
    assert report["clone_timings"]["step2_s"] > 0
