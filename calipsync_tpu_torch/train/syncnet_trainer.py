"""SyncNet trainer: cosine-BCE contrastive training over step-1 data
(counterpart of calipsync_tpu/train/syncnet_trainer.py; the reference's
module/syncnet.py:364-414).

Per-epoch checkpoints with the reference's best-loss bookkeeping: save
``best`` when the epoch loss improves; after 3 epochs without improvement
("3 strikes") the current weights become the new best (:396-413). Yields
per-batch progress tuples as the reference's generator-style trainer
does.

On the card the clip's audio features stay resident and each batch's
windows are gathered there; the face crops are read on the host a batch
at a time, as in the JAX package. Adam with torch's defaults (b1 0.9, b2
0.999, eps 1e-8), as ``optax.adam``. The convs run under PyTorch's
default flags, which let cuDNN compute fp32 convolutions in TF32 on the
card; training keeps that.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from calipsync_tpu_torch.audio.windows import batched_windows
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.syncnet import SyncNet, cosine_bce_loss
from calipsync_tpu_torch.train.trainer import TrainState
from calipsync_tpu_torch.vision.geometry import (load_landmarks,
                                                 mouth_bbox_train)


class SyncNetDataset:
    """Positive (face, audio-window) pairs over a step-1 directory
    (reference syncnet.py:15-108; the labels are all ones, as there)."""

    def __init__(self, dataset_dir: str, mode: str = "hubert"):
        img_dir = os.path.join(dataset_dir, "full_body_img")
        n = len([f for f in os.listdir(img_dir) if f.endswith(".jpg")])
        self.img_paths = [os.path.join(img_dir, f"{i}.jpg")
                          for i in range(n)]
        self.lms_paths = [os.path.join(dataset_dir, "landmarks", f"{i}.lms")
                          for i in range(n)]
        feat = "aud_hu.npy" if mode == "hubert" else "aud_wenet.npy"
        self.audio_feats = np.load(
            os.path.join(dataset_dir, feat)).astype(np.float32)
        self.mode = mode

    def __len__(self) -> int:
        return self.audio_feats.shape[0] - 1

    def face(self, idx: int) -> np.ndarray:
        """The 160x160 centre of frame ``idx``'s mouth box resized to 168
        (uint8 BGR)."""
        import cv2

        fidx = min(idx, len(self.img_paths) - 1)
        img = cv2.imread(self.img_paths[fidx])
        x0, y0, x1, y1 = mouth_bbox_train(load_landmarks(
            self.lms_paths[fidx]))
        crop = cv2.resize(img[y0:y1, x0:x1], (168, 168),
                          interpolation=cv2.INTER_LINEAR)
        return np.ascontiguousarray(crop[4:164, 4:164])

    def batch(self, idxs: np.ndarray) -> dict:
        faces = np.stack([self.face(int(i)) for i in idxs])
        return {"face": faces, "index": idxs.astype(np.int32)}


def load_base(model: SyncNet, path: str) -> None:
    """Warm-start ``model`` from a port checkpoint directory (its latest
    ``step_N.pt``) or a reference-layout ``.pth``, strictly."""
    from calipsync_tpu_torch.core.weights import load_torch_state_dict

    if os.path.isdir(path):
        step = ckpt.latest_step(path)
        if step is None:
            raise ValueError(
                f"{path} holds no step_N.pt of the port (an Orbax "
                "checkpoint of the JAX package?): pass a port checkpoint "
                "directory or a SyncNet .pth in the reference layout")
        sd = torch.load(ckpt.checkpoint_path(path, step), map_location="cpu",
                        weights_only=True)["model"]
    else:
        sd = load_torch_state_dict(path)
    model.load_state_dict(sd, strict=True)


def make_step(model: SyncNet, optimizer: torch.optim.Optimizer,
              feats: torch.Tensor, mode: str):
    """One Adam update on a batch: (uint8 faces (B,160,160,3), frame
    indices (B,)) -> the loss (a 0-d tensor on the device)."""

    def step(face_u8: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        audio = batched_windows(feats, idx, mode=mode)
        face = face_u8.float() / 255.0
        y = torch.ones(face.shape[0], device=face.device)
        a, f = model(face, audio)
        loss = cosine_bce_loss(a, f, y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_sync_net(save_dir: str, dataset_dir: str, mode: str = "hubert",
                   batch_size: int = 16, lr: float = 1e-3,
                   epochs: int = 40, base_last_model: Optional[str] = None,
                   seed: int = 0, device=None) -> Iterator[tuple]:
    """Generator yielding (batch_idx, total, epoch, epochs, loss, best,
    elapsed_s) per batch, as the reference's train_sync_net does
    (module/syncnet.py:364-414). Writes ``best/`` and ``last/`` port
    checkpoints (core/checkpoint.py) under ``save_dir`` at each epoch's
    end. The model starts from torch's default init under ``seed``, or
    from ``base_last_model``. Runs on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    ds = SyncNetDataset(dataset_dir, mode)
    feats = torch.from_numpy(ds.audio_feats).to(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SyncNet(mode=mode)
    if base_last_model:
        load_base(model, base_last_model)
    model = model.to(dev).train()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=lr))
    step = make_step(model, state.optimizer, feats, mode)

    rng = np.random.default_rng(seed)
    best_loss = float("inf")
    strikes = 0
    n_batches = -(-len(ds) // batch_size)

    for e in range(epochs):
        start = time.time()
        order = rng.permutation(len(ds))
        epoch_loss = 0.0
        for bi in range(n_batches):
            idxs = order[bi * batch_size:(bi + 1) * batch_size]
            batch = ds.batch(idxs)
            loss = step(torch.from_numpy(batch["face"]).to(dev),
                        torch.from_numpy(batch["index"]).to(dev))
            state.step += 1
            epoch_loss += float(loss)
            if bi == n_batches - 1:
                if epoch_loss <= best_loss:
                    strikes = 0
                    best_loss = epoch_loss
                    ckpt.save_checkpoint(os.path.join(save_dir, "best"),
                                         e + 1, state)
                else:
                    strikes += 1
                if strikes >= 3:  # the reference's 3-strikes swap (:405-411)
                    ckpt.save_checkpoint(os.path.join(save_dir, "best"),
                                         e + 1, state)
                    best_loss = epoch_loss
                    strikes = 0
                ckpt.save_checkpoint(os.path.join(save_dir, "last"), e + 1,
                                     state)
            yield (bi, n_batches, e, epochs, epoch_loss, best_loss,
                   time.time() - start)
