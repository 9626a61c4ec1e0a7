"""How far chunked HuBERT features drift from one-pass features
(counterpart of tools/hubert_longaudio_delta.py).

Step 1 featurizes a clip longer than one 20 s chunk through the chunked
path (``HubertFeatureExtractor.extract_features``); the reference runs
the whole clip in one forward (``extract``). Two measures:

1. Features: per-row cosine similarity and max-abs delta between the two
   on 60-300 s clips of HuBERT-large.
2. Downstream: two step-1 directories that differ only in which path made
   ``aud_hu.npy``, each trained the same epochs from the same init in the
   same batch order; the loss trajectories compared.

HuBERT-large has random weights (none are in the repository): this bounds
the chunking's numerical divergence through a real 24-layer transformer,
not the phonetic drift of a trained model.

    python -m calipsync_tpu_torch.tools.hubert_longaudio_delta
        [--device cpu] [--delta-lengths 60,120,300]
        [--delta-train-seconds 60] [--delta-train-epochs 3]
        [--delta-dtype float32] [--hubert real|toy]
        [--out chiprun_out/hubert_longaudio_delta.json]
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np


def row_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """Per-(T/2,2,1024)-row agreement between two feature arrays."""
    n = min(len(a), len(b))
    a = a[:n].reshape(n, -1).astype(np.float64)
    b = b[:n].reshape(n, -1).astype(np.float64)
    dots = np.einsum("ij,ij->i", a, b)
    cos = dots / np.maximum(np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1), 1e-12)
    absdiff = np.abs(a - b)
    denom = np.maximum(np.abs(a), np.abs(b)).max()
    return {
        "rows": int(n),
        "cos_sim_min": float(cos.min()),
        "cos_sim_mean": float(cos.mean()),
        "rows_below_cos_999": int((cos < 0.999).sum()),
        "max_abs_delta": float(absdiff.max()),
        "max_rel_delta": float(absdiff.max() / max(denom, 1e-12)),
        "mean_abs_delta": float(absdiff.mean()),
    }


def main(argv=None) -> dict:
    import torch

    from calipsync_tpu_torch.audio.io import load_audio
    from calipsync_tpu_torch.config import (ModelConfig, PipelineConfig,
                                            TrainConfig)
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor
    from calipsync_tpu_torch.pipelines.step2_train import \
        train_digital_model
    from calipsync_tpu_torch.tools import (device_report, make_hubert,
                                           parser, write_report)
    from calipsync_tpu_torch.tools.clone_proof import (FixedLipDetector,
                                                       make_talking_video,
                                                       speech_like_audio)
    from calipsync_tpu_torch.train.trainer import DTYPES

    ap = parser("hubert_longaudio_delta", __doc__)
    ap.add_argument("--delta-lengths", default="60,120,300",
                    help="clip seconds, comma-separated")
    ap.add_argument("--delta-train-seconds", type=float, default=60.0)
    ap.add_argument("--delta-train-epochs", type=int, default=3)
    ap.add_argument("--delta-dtype", choices=tuple(DTYPES),
                    default="float32",
                    help="HuBERT's compute dtype (float32 isolates the "
                         "chunking from bf16 rounding)")
    ap.add_argument("--hubert", choices=("real", "toy"), default="real")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    extractor = make_hubert(args.hubert, DTYPES[args.delta_dtype], device,
                            seed=1)
    out = {"hubert": args.hubert, "hubert_dtype": args.delta_dtype,
           "weights": "random (no pretrained HuBERT in the repository)",
           "feature_delta": [], **device_report(device)}

    # 1. features: one pass against chunked
    for secs in (int(s) for s in args.delta_lengths.split(",")):
        audio = speech_like_audio(secs, seed=123 + secs)
        t0 = time.perf_counter()
        try:
            one = extractor.extract(audio)
        except torch.cuda.OutOfMemoryError as e:  # the quadratic attention
            out["feature_delta"].append({
                "seconds": secs,
                "one_pass_error": f"{type(e).__name__}: {e}"[:300]})
            print(f"one-pass failed at {secs}s: {e}", flush=True)
            torch.cuda.empty_cache()
            continue
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        chunked = extractor.extract_features(audio)
        t_chunk = time.perf_counter() - t0
        m = row_metrics(one, chunked)
        m.update({"seconds": secs, "one_pass_wall_s": t_one,
                  "chunked_wall_s": t_chunk,
                  "tokens_one_pass": int(secs * 50)})
        out["feature_delta"].append(m)
        print(json.dumps(m), flush=True)

    # 2. downstream: the same training on either path's features
    res = 480
    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "train.mp4")
        make_talking_video(video, res, args.delta_train_seconds, seed=0)
        data_one = os.path.join(tmp, "speaker_onepass")
        TrainPreprocessor(FixedLipDetector(res), extractor,
                          long_audio="one_pass").process_video(
            video, data_one)
        # the frames and landmarks are the same: copy them and redo only
        # the features, through the chunked path
        data_chunk = os.path.join(tmp, "speaker_chunked")
        shutil.copytree(data_one, data_chunk)
        wav = load_audio(os.path.join(data_chunk, "aud.wav"), 16_000)
        np.save(os.path.join(data_chunk, "aud_hu.npy"),
                extractor.extract_features(wav))

        losses = {}
        for tag, ddir in (("one_pass", data_one), ("chunked", data_chunk)):
            cfg = PipelineConfig(
                model=ModelConfig(dtype="float32"),
                train=TrainConfig(batch_size=16,
                                  epochs=args.delta_train_epochs))
            hist: list = []
            train_digital_model(ddir, os.path.join(tmp, f"ckpt_{tag}"),
                                cfg=cfg, log_every=0, loss_history=hist,
                                device=device)
            losses[tag] = hist

    n = min(len(losses["one_pass"]), len(losses["chunked"]))
    a = np.asarray(losses["one_pass"][:n], np.float64)
    b = np.asarray(losses["chunked"][:n], np.float64)
    out["downstream"] = {
        "steps": int(n), "epochs": args.delta_train_epochs,
        "final_loss_one_pass": float(a[-1]),
        "final_loss_chunked": float(b[-1]),
        "final_abs_delta": float(abs(a[-1] - b[-1])),
        "max_abs_delta": float(np.abs(a - b).max()),
        "mean_abs_delta": float(np.abs(a - b).mean()),
        "loss_scale_mean": float(a.mean())}
    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
