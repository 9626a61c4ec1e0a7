"""Step 2: fine-tune the generator on one speaker (counterpart of
calipsync_tpu/pipelines/step2_train.py; the reference's
step2_train_unet.py:38-138), on one card or data-parallel over the ranks
of ``cfg.mesh`` (``core.mesh.build_mesh``: one process a card, each
running this function with the same arguments; ``train.zero1`` shards the
Adam moments, ``train.sync_batchnorm`` shares the BatchNorm statistics).

The speaker's crops live on the card (``ResidentLipSyncDataset``) unless
they would take more than ``train.resident_max_bytes``; then the host
decodes each batch on a background thread into pinned memory
(``LipSyncDataset`` + ``Prefetcher``) and the training thread copies it.
With ``train.steps_per_dispatch`` K > 1 the resident path groups an
epoch's batches into (K, B) blocks as the JAX package does
(:func:`dispatch_blocks`) and runs each block as one dispatch
(``make_resident_multi_step``: on the card one CUDA graph replay); the
preemption signal is read once a block. The streaming path ignores K.
Checkpoints are keyed by epoch and resume; every save also writes
``generator.pth``, the bare reference-layout state_dict that the port's
``cli.py`` and the JAX package's ``import_generator`` read. Over a mesh
the first rank writes them; a checkpoint holds the replicated Adam layout
whatever the ranks or ``zero1``, so a run resumes on any topology.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from calipsync_tpu_torch.config import PipelineConfig
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.data.dataset import (LipSyncDataset, Prefetcher,
                                              ResidentLipSyncDataset,
                                              batch_iterator, count_frames,
                                              pin_memory)
from calipsync_tpu_torch.nn.vgg import load_vgg19
from calipsync_tpu_torch.train.trainer import (DTYPES, build_model,
                                               create_train_state,
                                               create_zero1_state,
                                               make_resident_multi_step,
                                               make_resident_train_step,
                                               make_train_step)

GENERATOR_FILE = "generator.pth"


def train_digital_model(dataset_dir: str, save_dir: str,
                        vgg_path: Optional[str] = None,
                        unet_checkpoint: Optional[str] = None,
                        cfg: PipelineConfig = PipelineConfig(),
                        resume: bool = False, log_every: int = 10,
                        loss_history: Optional[list] = None,
                        device=None) -> str:
    """Fine-tune the generator on one speaker's step-1 data.

    ``vgg_path``: a torchvision ``vgg19`` .pth for the perceptual term
    (None drops it); ``unet_checkpoint``: a reference-layout generator .pth
    to start from (strict load; a path that is not a file raises, where
    the JAX package ignores it). ``loss_history`` receives every step's
    loss, an epoch at a time. ``device`` defaults to the GPU
    (``resolve_device``). Returns the last checkpoint's path;
    ``{save_dir}/generator.pth`` holds its generator.

    With ``cfg.train.preemption_safe`` (the default), SIGTERM/SIGINT make
    the loop checkpoint at the next batch boundary and return; run again
    with ``resume=True`` to redo that epoch and go on.
    """
    if cfg.train.preemption_safe:
        with ckpt.PreemptionGuard() as guard:
            return _train_impl(dataset_dir, save_dir, vgg_path,
                               unet_checkpoint, cfg, resume, log_every,
                               guard, loss_history, device)
    return _train_impl(dataset_dir, save_dir, vgg_path, unet_checkpoint,
                       cfg, resume, log_every, None, loss_history, device)


def dispatch_blocks(batches, k: int) -> list:
    """An epoch's index batches ``(idx, fidx, ex)``, each (B,), as (3, K,
    B) blocks, grouped as the JAX package groups them
    (calipsync_tpu/pipelines/step2_train.py:189-203): the last
    ``len(batches) % k`` batches are dropped, and an epoch shorter than
    one block is wrap-padded to ``k`` batches."""
    batches = list(batches)
    stop = len(batches) // k * k
    if stop == 0 and batches:
        batches = [batches[i % len(batches)] for i in range(k)]
        stop = k
    return [np.asarray(batches[i:i + k]).transpose(1, 0, 2)
            for i in range(0, stop, k)]


def _stop(guard, mesh, device) -> bool:
    """Whether to stop at this batch boundary; over a mesh, whether any
    rank was signalled, so that every rank stops at the same batch."""
    if mesh is None:
        return guard.triggered
    flag = torch.tensor([float(guard.triggered)], device=device)
    return bool(meshlib.all_reduce(flag, mesh,
                                   meshlib.batch_axes(mesh)).item())


def _train_impl(dataset_dir, save_dir, vgg_path, unet_checkpoint, cfg,
                resume, log_every, guard, loss_history, device) -> str:
    device = resolve_device(device)
    tc = cfg.train
    mesh = meshlib.build_mesh(cfg.mesh)
    if mesh is not None and not mesh.is_member():
        return ""  # a rank outside mesh.data has nothing to train
    if tc.zero1 and mesh is None:
        raise ValueError("train.zero1 shards the Adam moments over "
                         "data-parallel ranks: launch one process a card "
                         "(torchrun, or the CALIPSYNC_* variables)")
    main = meshlib.process_index() == 0  # the rank that writes
    os.makedirs(save_dir, exist_ok=True)
    model = build_model(cfg.model, seed=tc.seed)
    if unet_checkpoint:
        if not os.path.isfile(unet_checkpoint):
            raise FileNotFoundError(f"{unet_checkpoint}: the warm start is "
                                    "a reference-layout generator .pth")
        sd = torch.load(unet_checkpoint, map_location="cpu",
                        weights_only=True)
        model.load_state_dict(sd.get("state_dict", sd), strict=True)
    model.to(device)
    if mesh is not None:
        meshlib.replicate(model, mesh)
        state = (create_zero1_state(model, tc, mesh) if tc.zero1
                 else create_train_state(model, tc))
    else:
        state = create_train_state(model, tc)

    # the data order: a fresh start draws the JAX package's stream from
    # tc.seed; a resumed run goes on from the checkpoint's state
    rng = np.random.default_rng(tc.seed)

    def save(key: int, data_rng_state: dict) -> str:
        opt_state = state.optimizer.state_dict()  # every rank: collective
        if not main:
            return str(ckpt.checkpoint_path(save_dir, key))
        path = ckpt.save_checkpoint(save_dir, key, state, data_rng_state,
                                    opt_state)
        tmp = os.path.join(save_dir, GENERATOR_FILE + ".tmp")
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   tmp)
        os.replace(tmp, os.path.join(save_dir, GENERATOR_FILE))
        return str(path)

    start_epoch = 0
    if resume and ckpt.latest_step(save_dir) is not None:
        start_epoch = ckpt.latest_step(save_dir)  # keyed by epoch
        ckpt.restore_checkpoint(save_dir, state, start_epoch, rng)

    vgg = (load_vgg19(vgg_path, DTYPES[cfg.model.dtype], device)
           if vgg_path else None)

    resident = tc.resident_data
    store_bytes = count_frames(dataset_dir) * cfg.crop.size ** 2 * 3
    if resident and store_bytes > tc.resident_max_bytes:
        print(f"training crop store {store_bytes >> 20} MiB exceeds "
              f"resident_max_bytes; using the streaming dataset")
        resident = False
    k = max(1, tc.steps_per_dispatch) if resident else 1
    if resident:
        step_fn = (make_resident_multi_step if k > 1
                   else make_resident_train_step)(tc, cfg.crop, mesh)
        ds = ResidentLipSyncDataset(dataset_dir, cfg.model.mode, cfg.crop,
                                    device=device,
                                    num_workers=tc.num_workers)
    else:
        step_fn = make_train_step(tc, mesh)
        ds = LipSyncDataset(dataset_dir, cfg.model.mode, cfg.crop)
    feats = torch.from_numpy(ds.audio_feats).to(device)
    put_fn = pin_memory if device.type == "cuda" else None

    last_path = ""
    for epoch in range(start_epoch, tc.epochs):
        t0 = time.time()
        epoch_rng_state = rng.bit_generator.state
        if resident:
            batches = ds.epoch_indices(tc.batch_size, rng, shuffle=True,
                                       drop_last=True)
            if k > 1:
                batches = dispatch_blocks(batches, k)
        else:
            batches = Prefetcher(
                batch_iterator(ds, tc.batch_size, rng, shuffle=True,
                               drop_last=True, num_workers=tc.num_workers),
                depth=2, put_fn=put_fn)
        # the losses stay on the card; one fetch an epoch (and one a log
        # line), not one a step
        losses, n_batches, preempted = [], 0, False
        try:
            for bi, batch in enumerate(batches):
                if resident:
                    metrics = step_fn(state, ds.store, *batch, feats, vgg)
                else:
                    metrics = step_fn(state, batch, feats, vgg)
                losses.append(metrics["loss"].reshape(-1))
                n_batches += k
                # JAX's cadence: every log_every steps, or with K > 1 the
                # block's last loss every log_every // K blocks
                if main and log_every and (
                        bi % max(1, log_every // k) == 0 if k > 1
                        else n_batches % log_every == 0):
                    print(f"epoch {epoch + 1}/{tc.epochs} batch {n_batches} "
                          f"loss {float(losses[-1][-1]):.6f}")
                if guard is not None and _stop(guard, mesh, device):
                    preempted = True
                    break
        finally:
            if isinstance(batches, Prefetcher):
                batches.close()
        if preempted:
            # keyed by this epoch, not the next, with the order it drew:
            # resume redoes it
            last_path = save(epoch, epoch_rng_state)
            print(f"preempted during epoch {epoch + 1} after {n_batches} "
                  f"batches; checkpoint saved to {last_path}; run again "
                  f"with resume=True to continue")
            return last_path
        epoch_losses = (torch.cat(losses).cpu().numpy() if losses
                        else np.zeros(0, np.float32))
        if loss_history is not None:
            loss_history.extend(float(x) for x in epoch_losses)
        final = epoch == tc.epochs - 1
        periodic = (tc.checkpoint_every
                    and (epoch + 1) % tc.checkpoint_every == 0)
        if final or periodic:
            last_path = save(epoch + 1, rng.bit_generator.state)
        if n_batches:
            print(f"epoch {epoch + 1} done in {time.time() - t0:.2f}s avg "
                  f"loss {float(epoch_losses.mean()):.6f}")
    return last_path
