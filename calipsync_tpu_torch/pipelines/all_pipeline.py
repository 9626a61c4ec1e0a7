"""Clone a speaker: video -> fine-tuned generator and inference assets
(counterpart of calipsync_tpu/pipelines/all_pipeline.py; the reference's
all_pipeline.py:11-120): step 1 (training data), step 2 (fine-tune),
step 3 (inference assets), then the training intermediates removed, all
under a uuid model directory.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from typing import Optional

from calipsync_tpu_torch.config import PipelineConfig


def clean_intermediate_data(model_dir: str) -> None:
    """Remove what only training reads; keep the weights and the
    inference assets (reference :11-32)."""
    for d in ("full_body_img", "landmarks", "faces"):
        p = os.path.join(model_dir, d)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
    for f in ("aud.wav", "aud_hu.npy"):
        p = os.path.join(model_dir, f)
        if os.path.isfile(p):
            os.remove(p)


def clone_video_local(video_path: str, output_base_dir: str,
                      lip_detector, hubert_extractor,
                      vgg_path: Optional[str] = None,
                      unet_checkpoint: Optional[str] = None,
                      cfg: PipelineConfig = PipelineConfig(),
                      timings: Optional[dict] = None,
                      device=None) -> tuple[str, str]:
    """The whole clone. Returns (path of the fine-tuned ``generator.pth``,
    model id); the inference assets are ``{output_base_dir}/{model id}/
    infer_data``. The video's audio is a wav side-car next to it, or its
    own track (PCM natively, other codecs with ffmpeg).

    timings: an optional dict that receives each stage's wall seconds
    ('step1_s', 'step2_s', 'step3_s', 'total_s'). device: the training
    device ('cuda' by default).
    """
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor
    from calipsync_tpu_torch.pipelines.step2_train import (
        GENERATOR_FILE, train_digital_model)
    from calipsync_tpu_torch.pipelines.step3_prepare import \
        InferPreprocessor

    model_id = str(uuid.uuid4())
    model_dir = os.path.join(output_base_dir, model_id)
    os.makedirs(model_dir, exist_ok=True)
    t_start = t0 = time.perf_counter()

    def mark(key):
        nonlocal t0
        now = time.perf_counter()
        if timings is not None:
            timings[key] = now - t0
        t0 = now

    TrainPreprocessor(lip_detector, hubert_extractor,
                      crop=cfg.crop).process_video(video_path, model_dir)
    mark("step1_s")

    weights_dir = os.path.join(model_dir, "weights")
    train_digital_model(model_dir, weights_dir, vgg_path=vgg_path,
                        unet_checkpoint=unet_checkpoint, cfg=cfg,
                        device=device)
    mark("step2_s")

    InferPreprocessor(lip_detector).process_video(video_path, model_dir)
    mark("step3_s")

    clean_intermediate_data(model_dir)
    if timings is not None:
        timings["total_s"] = time.perf_counter() - t_start
    return os.path.join(weights_dir, GENERATOR_FILE), model_id
