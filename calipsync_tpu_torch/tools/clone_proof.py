"""Clone proof (counterpart of tools/clone_proof.py): the whole clone of a
synthetic one-minute talking head through the product's entry point,
``pipelines.all_pipeline.clone_video_local`` (step 1, step 2, step 3),
then offline inference on a held-out clip of the same speaker. Records:

  - each stage's wall seconds and the cold-start-to-avatar total,
  - held-out mouth-rect PSNR before and after training (frames and audio
    the model never trained on; tools/__init__.py's evaluator),
  - LSE-C/D (``eval.sync_metrics``) of the produced video, scored by a
    SyncNet trained on this speaker's step-1 data
    (``train/syncnet_trainer.py``), and of the original held-out clip by
    the same SyncNet (the ceiling).

The clip is a fixed face whose mouth opening follows the audio's envelope
(a learnable audio-to-mouth mapping); the lip detector returns the face's
fixed landmarks. The data builders here are bit-equal to the JAX tool's.
HuBERT is HuBERT-large in bf16 with random weights (``--hubert toy``: a
2-layer one, for a CPU run).

    python -m calipsync_tpu_torch.tools.clone_proof [--device cpu]
        [--clone-seconds 60] [--clone-hold-seconds 8] [--clone-res 480]
        [--clone-epochs 20] [--clone-batch 16] [--clone-sync-epochs 5]
        [--hubert real|toy] [--out chiprun_out/clone_proof.json]
"""

from __future__ import annotations

import os
import tempfile
import time
from concurrent.futures import Future

import numpy as np

FPS = 25
SR = 16_000


def make_landmarks(res: int) -> np.ndarray:
    """Constant 110-point landmark set for the fixed synthetic face
    (the geometry of bench_assets.make_synthetic_speaker)."""
    h = w = res
    xmin = w // 4
    width = w // 3
    ymin = h // 2
    cx, cy = xmin + width // 2, ymin + width // 2
    lms = np.zeros((110, 2), np.int64)
    theta = np.linspace(0, 2 * np.pi, 33, endpoint=False)
    lms[:33, 0] = (cx + 0.45 * width * np.cos(theta)).astype(np.int64)
    lms[:33, 1] = (cy + 0.45 * width * np.sin(theta)).astype(np.int64)
    rng = np.random.default_rng(7)
    lms[33:] = rng.integers(xmin, xmin + width, (77, 2))
    lms[1] = (xmin, cy)
    lms[31] = (xmin + width, cy)
    lms[52] = (cx, ymin)
    return lms


class FixedLipDetector:
    """Deterministic landmarks for the fixed synthetic face, behind the
    lip detector's interface that steps 1 and 3 call."""

    def __init__(self, res: int):
        self.lms = make_landmarks(res).astype(np.int32)

    def detect_landmarks(self, images):
        return [[self.lms.copy()] for _ in images]

    def submit(self, images) -> Future:
        done: Future = Future()
        done.set_result(self.detect_landmarks(images))
        return done

    def reset_stride(self) -> None:
        pass


def speech_like_audio(seconds: float, seed: int) -> np.ndarray:
    """Amplitude-modulated harmonic tone with random syllable envelope:
    enough spectral/temporal structure that HuBERT features track it."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    carrier = (np.sin(2 * np.pi * f0 * t)
               + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
               + 0.25 * np.sin(2 * np.pi * 3 * f0 * t))
    # syllable envelope: smoothed random gate at ~3 Hz
    n_seg = max(2, int(seconds * 3))
    gates = rng.uniform(0.05, 1.0, n_seg)
    env = np.interp(np.linspace(0, n_seg - 1, n), np.arange(n_seg), gates)
    return (0.25 * env * carrier).astype(np.float32)


def mouth_open_per_frame(audio: np.ndarray, n_frames: int) -> np.ndarray:
    """Per-frame mouth openness in [0,1] from the audio RMS envelope."""
    spf = SR // FPS
    opens = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        seg = audio[i * spf:(i + 1) * spf]
        opens[i] = np.sqrt(np.mean(seg ** 2)) if len(seg) else 0.0
    m = opens.max()
    return opens / m if m > 0 else opens


def make_talking_video(path: str, res: int, seconds: float,
                       seed: int) -> str:
    """Fixed-face clip whose mouth ellipse height tracks the audio
    envelope; returns the side-car wav path."""
    import cv2

    from calipsync_tpu_torch.audio.io import save_wav

    audio = speech_like_audio(seconds, seed)
    wav_path = os.path.splitext(path)[0] + ".wav"
    save_wav(wav_path, audio, SR)

    n_frames = int(seconds * FPS)
    opens = mouth_open_per_frame(audio, n_frames)
    h = w = res
    xmin, width, ymin = w // 4, w // 3, h // 2
    cx, cy = xmin + width // 2, ymin + width // 2

    yy = np.linspace(40, 200, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 55, w, dtype=np.float32)[None, :]
    ch = yy + xx
    base = np.stack([ch, np.broadcast_to(yy * 0.8 + 30, ch.shape),
                     np.broadcast_to(230 - xx, ch.shape)], -1)
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                         (w, h))
    try:
        for i in range(n_frames):
            img = np.clip(base + rng.normal(0, 4, (h, w, 3)), 0,
                          255).astype(np.uint8)
            cv2.ellipse(img, (cx, cy), (width // 2, int(width * 0.6)),
                        0, 0, 360, (150, 170, 210), -1)
            # eyes (static) — visual anchors inside the crop
            for ex in (cx - width // 5, cx + width // 5):
                cv2.circle(img, (ex, cy - width // 5), width // 14,
                           (60, 50, 40), -1)
            # mouth: height follows the audio envelope
            mh = max(2, int(width * (0.02 + 0.12 * opens[i])))
            cv2.ellipse(img, (cx, cy + width // 4), (width // 5, mh),
                        0, 0, 360, (60, 60, 150), -1)
            cv2.ellipse(img, (cx, cy + width // 4),
                        (width // 5, max(1, mh // 3)),
                        0, 0, 360, (30, 25, 70), -1)
            vw.write(img)
    finally:
        vw.release()
    return wav_path


def crop_mouth(img: np.ndarray, lms: np.ndarray) -> np.ndarray:
    """The training crop's geometry (vision/geometry.py) ->
    (160,160,3) uint8."""
    import cv2

    from calipsync_tpu_torch.vision.geometry import mouth_bbox_train

    x0, y0, x1, y1 = mouth_bbox_train(lms)
    crop = cv2.resize(img[y0:y1, x0:x1], (168, 168),
                      interpolation=cv2.INTER_LINEAR)
    return np.ascontiguousarray(crop[4:164, 4:164])


def video_crops(path: str, lms: np.ndarray) -> np.ndarray:
    """Every frame of the video at ``path``, mouth-cropped."""
    import cv2

    cap = cv2.VideoCapture(path)
    crops = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        crops.append(crop_mouth(frame, lms))
    cap.release()
    return np.stack(crops)


def best_syncnet(sync_dir: str, device):
    """The ``best/`` checkpoint that ``train_sync_net`` wrote under
    ``sync_dir``, as a SyncNet in eval mode."""
    import torch

    from calipsync_tpu_torch.core import checkpoint as ckpt
    from calipsync_tpu_torch.nn.syncnet import load_syncnet

    best = os.path.join(sync_dir, "best")
    saved = torch.load(ckpt.checkpoint_path(best, ckpt.latest_step(best)),
                       map_location="cpu", weights_only=True)
    return load_syncnet(saved["model"], mode="hubert", device=device)


def holdout_evaluator(hold_dir: str, device, crop):
    """The clone tools' held-out evaluator over a step-1 directory: up to
    128 samples, the reference 31 frames on."""
    import torch

    from calipsync_tpu_torch.data.dataset import ResidentLipSyncDataset
    from calipsync_tpu_torch.tools import HoldoutEvaluator

    ds = ResidentLipSyncDataset(hold_dir, crop=crop, device=device)
    feats = torch.from_numpy(ds.audio_feats).to(device)
    return HoldoutEvaluator(ds.store, feats, len(ds), ds.n_frames,
                            min(len(ds) - 1, 128), 31, crop)


def timed_infer(mgr, wav: str, out_mp4: str) -> dict:
    t0 = time.perf_counter()
    r = mgr.process_single_file(wav, out_mp4)
    wall = time.perf_counter() - t0
    return {"frames": r["frames"], "wall_s": wall,
            "fps": r["frames"] / wall, "ttff_s": r["ttff_s"]}


def main(argv=None) -> dict:
    import torch

    from calipsync_tpu_torch.cli import load_generator
    from calipsync_tpu_torch.config import (CropConfig, PipelineConfig,
                                            TrainConfig)
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.eval import sync_metrics
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.pipelines.all_pipeline import (
        clean_intermediate_data, clone_video_local)
    from calipsync_tpu_torch.pipelines.inference import VideoStreamManager
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor
    from calipsync_tpu_torch.tools import (device_report, make_hubert,
                                           parser, write_report)
    from calipsync_tpu_torch.train.syncnet_trainer import train_sync_net
    from calipsync_tpu_torch.train.trainer import build_model

    ap = parser("clone_proof", __doc__)
    ap.add_argument("--clone-seconds", type=float, default=60.0)
    ap.add_argument("--clone-hold-seconds", type=float, default=8.0)
    ap.add_argument("--clone-res", type=int, default=480)
    ap.add_argument("--clone-epochs", type=int, default=20)
    ap.add_argument("--clone-batch", type=int, default=16)
    ap.add_argument("--clone-sync-epochs", type=int, default=5)
    ap.add_argument("--hubert", choices=("real", "toy"), default="real")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res, batch = args.clone_res, args.clone_batch

    cfg = PipelineConfig(train=TrainConfig(batch_size=batch,
                                           epochs=args.clone_epochs))
    crop = CropConfig()
    out = {"seconds": args.clone_seconds,
           "hold_seconds": args.clone_hold_seconds, "res": res,
           "epochs": args.clone_epochs, "batch": batch, "hubert": args.hubert,
           **device_report(device)}
    extractor = make_hubert(args.hubert, torch.bfloat16, device, seed=1)
    lip = FixedLipDetector(res)

    with tempfile.TemporaryDirectory() as tmp:
        train_video = os.path.join(tmp, "train.mp4")
        make_talking_video(train_video, res, args.clone_seconds, seed=0)
        hold_video = os.path.join(tmp, "hold.mp4")
        hold_wav = make_talking_video(hold_video, res,
                                      args.clone_hold_seconds, seed=99)

        # the product flow: clone (step 1 -> train -> step 3)
        timings: dict = {}
        weights_path, model_id = clone_video_local(
            train_video, tmp, lip, extractor, cfg=cfg, cleanup=False,
            timings=timings, device=device)
        out["clone_timings"] = timings
        model_dir = os.path.join(tmp, model_id)

        # held-out PSNR (frames and audio never trained on)
        hold_dir = os.path.join(tmp, "holdout_data")
        TrainPreprocessor(lip, extractor, crop=crop).process_video(
            hold_video, hold_dir)
        evaluate = holdout_evaluator(hold_dir, device, crop)
        trained = load_generator(weights_path, cfg).to(device)
        # the pre-training baseline: the init step 2 started from
        out["holdout_before"] = evaluate(
            build_model(cfg.model, seed=cfg.train.seed).to(device))
        out["holdout_after"] = evaluate(trained)
        out["holdout_mouth_rect_gain_db"] = (
            out["holdout_after"]["psnr_mouth_rect"]
            - out["holdout_before"]["psnr_mouth_rect"])

        # offline inference on the held-out audio, cold then warm
        synth = FrameSynthesizer(None, os.path.join(model_dir, "infer_data"),
                                 model=trained,
                                 batch_size=cfg.infer.batch_size, crop=crop,
                                 seed=0,
                                 transfer_format=cfg.infer.transfer_format,
                                 device=device)
        mgr = VideoStreamManager(synth, extractor, fps=FPS)
        out_mp4 = os.path.join(tmp, "avatar.mp4")
        out["infer"] = timed_infer(mgr, hold_wav, out_mp4)
        out["cold_start_to_avatar_s"] = (timings["total_s"]
                                         + out["infer"]["wall_s"])
        out["infer_warm"] = timed_infer(mgr, hold_wav, out_mp4)

        # a SyncNet trained on the speaker scores the produced video
        sync_dir = os.path.join(tmp, "syncnet")
        last = None
        for last in train_sync_net(sync_dir, model_dir, mode="hubert",
                                   batch_size=batch,
                                   epochs=args.clone_sync_epochs,
                                   device=device):
            pass
        out["syncnet"] = {"epochs": args.clone_sync_epochs,
                          "final_epoch_loss": float(last[4])}
        snet = best_syncnet(sync_dir, device)
        hold_feats = extractor.extract_from_file(hold_wav)
        produced = video_crops(out_mp4, lip.lms)
        n = min(len(produced), len(hold_feats))
        out["sync_produced"] = sync_metrics(snet, produced[:n],
                                            hold_feats[:n])
        original = video_crops(hold_video, lip.lms)
        n0 = min(len(original), len(hold_feats))
        out["sync_original_ceiling"] = sync_metrics(
            snet, original[:n0], hold_feats[:n0])

        clean_intermediate_data(model_dir)  # the product's cleanup too

    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
