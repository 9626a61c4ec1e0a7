"""The port's proof tools (counterparts of the repository's
tools/train_proof.py, clone_proof.py, clone_curve.py,
hubert_longaudio_delta.py and soak_streaming.py). Each drives the port
end to end and writes one JSON report:

    python -m calipsync_tpu_torch.tools.<name> [--device cpu] [flags]

A run uses the GPU unless it asks for ``--device cpu``, and raises
without CUDA (core/device.py). Each flag is named after the JAX tool's
environment variable and has its default. The report goes to ``--out``
(by default under ``chiprun_out/``) and to the last line of stdout.

The port cannot reproduce the JAX tools' random initializations without
JAX, so the weights come from the port's own seeds (``"init": "torch
seeded"`` in every report): a run is compared with the JAX tools'
artifacts by its outcomes, not bit for bit.

This module holds what the tools share: the common flags, the device's
name and power limit, the seeded HuBERT, and the held-out evaluator.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.eval import psnr

OUT_DIR = "chiprun_out"
INIT = "torch seeded"

# A 2-layer HuBERT of HuBERT-large's hidden width (the generator reads
# 1024-wide rows) and frame rate (its conv strides), narrow elsewhere:
# ``--hubert toy`` runs a tool on the CPU in seconds.
TOY_HUBERT = dict(num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=256, conv_dim=(32,) * 7,
                  num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=16)


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    """The tool's parser with the flags every tool takes: ``--device``
    and ``--out`` (default ``chiprun_out/<name>.json``)."""
    ap = argparse.ArgumentParser(
        prog=f"python -m calipsync_tpu_torch.tools.{name}",
        description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, f"{name}.json"),
                    help="where the JSON report is written")
    return ap


def device_report(device: torch.device) -> dict:
    """What ran the tool: on the card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` reads them."""
    if device.type != "cuda":
        return {"platform": "cpu", "init": INIT}
    index = device.index if device.index is not None else 0
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        smi = lines[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not measured"
    return {"platform": "gpu", "init": INIT,
            "kind": torch.cuda.get_device_name(device),
            "name_power_limit": smi}


def write_report(report: dict, path: str) -> None:
    """The report as indented JSON at ``path`` and on stdout's last
    line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps(report), flush=True)


def make_hubert(kind: str, dtype: torch.dtype, device: torch.device,
                seed: int):
    """A HuBERT feature extractor of random weights from ``seed``:
    HuBERT-large (``kind='real'``) or :data:`TOY_HUBERT` ('toy')."""
    from calipsync_tpu_torch.audio.hubert_pipeline import \
        HubertFeatureExtractor
    from calipsync_tpu_torch.core.weights import (from_jax_hubert,
                                                  random_jax_hubert)
    from calipsync_tpu_torch.nn.hubert import HubertConfig

    if kind not in ("real", "toy"):
        raise ValueError(f"unknown HuBERT kind {kind!r}")
    cfg = HubertConfig.large() if kind == "real" else HubertConfig(
        **TOY_HUBERT)
    sd = from_jax_hubert(random_jax_hubert(cfg, seed=seed), cfg)
    return HubertFeatureExtractor(sd, cfg, dtype=dtype, device=device)


class HoldoutEvaluator:
    """PSNR of a generator's predictions on a fixed set of one speaker's
    samples: over the whole crop, inside the mouth rectangle (what the
    generator synthesizes from the audio and the reference frame; the
    rest of the crop is its input) and outside it.

    Sample i of a dataset of ``n_samples`` reads audio row ``i %
    (n_samples - 1)``, frame ``min(that, n_frames - 1)`` and reference
    frame ``(frame + ref_offset) % n_frames``, the JAX tools' rules
    (train_proof's offset 7, the clone tools' 31). The prediction's
    input is built as the resident train step builds its own
    (``train/trainer.py::_resident_batch``) and run by the generator in
    eval mode; both sides are [0, 1], the prediction clipped."""

    def __init__(self, store: torch.Tensor, audio_feats: torch.Tensor,
                 n_samples: int, n_frames: int, n_eval: int, ref_offset: int,
                 crop: CropConfig = CropConfig(), batch: int = 64):
        idx = np.arange(n_eval, dtype=np.int32) % (n_samples - 1)
        fidx = np.minimum(idx, n_frames - 1).astype(np.int32)
        ex = ((fidx + ref_offset) % n_frames).astype(np.int32)
        self.samples = (idx, fidx, ex)
        self.store, self.audio_feats = store, audio_feats
        self.crop, self.batch = crop, batch
        self.rect = np.zeros((crop.size, crop.size), bool)
        self.rect[crop.mask_y:crop.mask_y + crop.mask_h,
                  crop.mask_x:crop.mask_x + crop.mask_w] = True

    @torch.no_grad()
    def __call__(self, model) -> dict:
        from calipsync_tpu_torch.train.trainer import _resident_batch

        model.eval()
        preds, reals = [], []
        for s in range(0, len(self.samples[0]), self.batch):
            imgs, labels, audio = _resident_batch(
                self.store, *(v[s:s + self.batch] for v in self.samples),
                self.audio_feats, model.mode, model.dtype, self.crop)
            preds.append(model(imgs, audio).float().cpu().numpy())
            reals.append(labels.cpu().numpy())
        p = np.clip(np.concatenate(preds), 0.0, 1.0)
        r = np.concatenate(reals)
        m = self.rect
        return {"psnr_full": psnr(p, r, 1.0),
                "psnr_mouth_rect": psnr(p[:, m], r[:, m], 1.0),
                "psnr_outside_rect": psnr(p[:, ~m], r[:, ~m], 1.0)}

