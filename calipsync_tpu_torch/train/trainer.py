"""Training step of the lip-sync generator on one card (counterpart of
calipsync_tpu/train/trainer.py; the reference's step2_train_unet.py:94-123).

  - The model's ``dtype`` is the mixed-precision recipe, as in the JAX
    package: parameters, BatchNorm statistics and Adam state stay fp32, the
    generator computes in bf16 (or fp32), the losses in fp32. No autocast,
    which would cast another set of ops.
  - In train mode the generator runs its plain modules; the cross-attention
    forward is the CUDA kernel on the card, differentiable
    (``kernels/cross_attention.py``). BatchNorm updates its running
    statistics as flax does (``nn/blocks.py``).
  - Adam with torch's defaults (b1 0.9, b2 0.999, eps 1e-8), as
    ``optax.adam``.
  - uint8 crops become [0, 1] on the card and audio windows are gathered
    there from the clip's whole feature array.

Options (TrainConfig), each equal to the plain step in the tests:
``grad_accum`` (M microbatches, BN statistics per microbatch, the
gradients averaged, one Adam update) and ``remat`` (the generator's
activations recomputed in the backward pass).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from calipsync_tpu_torch.audio.windows import batched_windows
from calipsync_tpu_torch.config import CropConfig, ModelConfig, TrainConfig
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.nn.vgg import VGG19Features
from calipsync_tpu_torch.train.loss import generator_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    """The generator (parameters and BatchNorm statistics), its Adam
    optimizer and the count of updates taken."""

    model: Generator
    optimizer: torch.optim.Adam
    step: int = 0


def build_model(model_cfg: ModelConfig, seed: int = 0) -> Generator:
    """The generator of ``model_cfg`` on the CPU, initialized from ``seed``
    (PyTorch's default init; the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Generator(model_cfg.n_channels, model_cfg.mode,
                         model_cfg.n_blocks, dtype=DTYPES[model_cfg.dtype])


def create_train_state(model: Generator,
                       train_cfg: TrainConfig) -> TrainState:
    return TrainState(model, torch.optim.Adam(model.parameters(),
                                              lr=train_cfg.lr))


def _bn_buffers(model: nn.Module) -> list[torch.Tensor]:
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers(recurse=False)]


def _grads(state: TrainState, train_cfg: TrainConfig,
           vgg: Optional[VGG19Features], imgs: torch.Tensor,
           labels: torch.Tensor, audio: torch.Tensor) -> dict:
    """Gradients of the mean loss into the parameters' ``.grad`` and the
    metrics, averaged over ``grad_accum`` microbatches.

    With ``remat`` the backward pass re-runs the generator's forward, which
    in train mode would move every BatchNorm's running statistics a second
    time (``jax.checkpoint`` is functional and does not): the statistics
    after the forward are kept and put back after the backward."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    accum = train_cfg.grad_accum
    if imgs.shape[0] % accum:
        raise ValueError(f"batch {imgs.shape[0]} is not divisible by "
                         f"grad_accum={accum}")
    buffers = _bn_buffers(model) if train_cfg.remat else []
    sums: dict = {}
    for im, lb, au in zip(imgs.chunk(accum), labels.chunk(accum),
                          audio.chunk(accum)):
        if train_cfg.remat:
            pred = checkpoint(model, im, au, use_reentrant=False)
        else:
            pred = model(im, au)
        total, metrics = generator_loss(pred, lb, vgg,
                                        train_cfg.perceptual_weight)
        kept = [b.clone() for b in buffers]
        (total / accum).backward()
        for b, k in zip(buffers, kept):
            b.copy_(k)
        for name, value in metrics.items():
            sums[name] = sums.get(name, 0) + value.detach()
    return {name: value / accum for name, value in sums.items()}


def _train_on(state: TrainState, train_cfg: TrainConfig,
              vgg: Optional[VGG19Features], imgs: torch.Tensor,
              labels: torch.Tensor, audio: torch.Tensor) -> dict:
    metrics = _grads(state, train_cfg, vgg, imgs, labels, audio)
    state.optimizer.step()
    state.step += 1
    return metrics


def _to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor (pinned for an asynchronous copy) -> device."""
    return torch.as_tensor(a).to(device, dtype, non_blocking=True)


def make_train_step(train_cfg: TrainConfig):
    """The host-batch step: fn(state, batch, audio_feats, vgg=None) ->
    metrics (0-d tensors on the card), updating ``state`` in place.

    batch: {'ref', 'masked', 'target': (B,160,160,3) uint8, 'index': (B,)
    int}, numpy arrays or (pinned) host tensors, copied to the card here,
    on the caller's thread; audio_feats: (T, 2, 1024) fp32 on the card;
    vgg: the perceptual trunk, or None to drop that term."""
    def step(state: TrainState, batch: dict, audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features] = None) -> dict:
        dev, dt = audio_feats.device, state.model.dtype
        ref, masked, target = (_to_device(batch[k], dev)
                               for k in ("ref", "masked", "target"))
        imgs = torch.cat([ref, masked], dim=-1).to(dt) / 255.0
        labels = target.float() / 255.0
        audio = batched_windows(audio_feats, _to_device(batch["index"], dev),
                                mode=state.model.mode).to(dt)
        return _train_on(state, train_cfg, vgg, imgs, labels, audio)

    return step


def _resident_batch(store: torch.Tensor, idx, fidx, ex,
                    audio_feats: torch.Tensor, mode: str, dtype,
                    crop: CropConfig):
    """Crops gathered from the resident store, the mouth rectangle zeroed,
    /255 and the audio windows, all on the card."""
    dev, size = store.device, crop.size
    real_u8 = store[_to_device(fidx, dev, torch.long)].view(-1, size, size, 3)
    ref_u8 = store[_to_device(ex, dev, torch.long)].view(-1, size, size, 3)
    real = real_u8.to(dtype) / 255.0
    masked = real.clone()
    masked[:, crop.mask_y:crop.mask_y + crop.mask_h,
           crop.mask_x:crop.mask_x + crop.mask_w, :] = 0
    imgs = torch.cat([ref_u8.to(dtype) / 255.0, masked], dim=-1)
    labels = real_u8.float() / 255.0
    audio = batched_windows(audio_feats, _to_device(idx, dev),
                            mode=mode).to(dtype)
    return imgs, labels, audio


def make_resident_train_step(train_cfg: TrainConfig,
                             crop: CropConfig = CropConfig()):
    """The resident step: fn(state, store (N, S*S*3) uint8 on the card,
    idx (B,), fidx (B,), ex (B,), audio_feats, vgg=None) -> metrics; the
    same numbers as the host-batch step for the same indices
    (data.dataset.ResidentLipSyncDataset)."""
    def step(state: TrainState, store: torch.Tensor, idx, fidx, ex,
             audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features] = None) -> dict:
        batch = _resident_batch(store, idx, fidx, ex, audio_feats,
                                state.model.mode, state.model.dtype, crop)
        return _train_on(state, train_cfg, vgg, *batch)

    return step


def make_eval_step():
    """fn(model, imgs6 (B,160,160,6) in [0,1], audio (B,32,32,32)) ->
    (B,160,160,3) fp32: the eval-mode forward (the kernels on the card).
    ``model.eval()`` each call also drops the BatchNorm folds cached before
    the last update."""
    def step(model: Generator, imgs: torch.Tensor,
             audio: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(imgs, audio)

    return step
