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

Data parallel (``mesh=``, core/mesh.py): every rank holds the whole
model and takes its contiguous block of the global batch's rows; the
gradients and the metrics are averaged over the mesh's batch axes (the
``(host, data)`` pair on a hybrid mesh), and with
``TrainConfig.sync_batchnorm`` every BatchNorm takes its statistics over
the whole global batch (``nn/blocks.py::sync_batchnorm``). With
``TrainConfig.zero1`` the state comes from :func:`create_zero1_state`:
each rank keeps the Adam moments of one 1/D block of the flattened
parameters (:class:`Zero1Adam`), the gradients arrive by reduce-scatter,
the block updates by ``torch.optim.Adam`` and the updated blocks are
all-gathered back, so the update is the mean path's, elementwise.
Checkpoints hold the replicated Adam layout either way
(:func:`zero1_opt_to_replicated`), so they move between topologies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from calipsync_tpu_torch.audio.windows import batched_windows
from calipsync_tpu_torch.config import CropConfig, ModelConfig, TrainConfig
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.nn.blocks import sync_batchnorm
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.nn.vgg import VGG19Features
from calipsync_tpu_torch.train.loss import generator_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    """The generator (parameters and BatchNorm statistics), its Adam
    optimizer and the count of updates taken."""

    model: Generator
    optimizer: "torch.optim.Adam | Zero1Adam"
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


class Zero1Adam:
    """Adam over a 1/D block of the flattened parameters (ZeRO-1; the
    JAX package's ``create_zero1_state`` / ``_make_update_fn``).

    The parameters, in ``model.parameters()`` order, flatten to one fp32
    vector padded to D equal blocks; rank r keeps block r as one
    parameter of its own ``torch.optim.Adam``, so its moments are 2/D of
    the mean path's. :meth:`step` reduce-scatters the mean gradient,
    takes the Adam step on the block and all-gathers the blocks back into
    the parameters. The padded tail has zero gradients and stays zero.
    ``state_dict``/``load_state_dict`` speak the replicated layout of
    ``torch.optim.Adam(model.parameters())`` (a collective: every rank
    calls ``state_dict``)."""

    def __init__(self, params, lr: float, mesh, axes):
        self.params = list(params)
        self.mesh, self.axes = mesh, axes
        self.d = mesh.axis_size(axes)
        self.index = mesh.axis_index(axes)
        self.numel = sum(p.numel() for p in self.params)
        self.block = -(-self.numel // self.d)
        flat = self._padded([p.detach() for p in self.params])
        lo = self.index * self.block
        self.shard = torch.nn.Parameter(flat[lo:lo + self.block].clone())
        self.inner = torch.optim.Adam([self.shard], lr=lr)

    def _padded(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return _pad(flat, self.d * self.block - self.numel)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        g = meshlib.reduce_scatter(self._padded(grads), self.mesh,
                                   self.axes)
        self.shard.grad = g.div_(self.d)
        self.inner.step()
        self.shard.grad = None
        flat = meshlib.all_gather(self.shard.detach(), self.mesh, self.axes)
        pos = 0
        for p in self.params:
            p.copy_(flat[pos:pos + p.numel()].view_as(p))
            pos += p.numel()

    def moment_bytes(self) -> int:
        st = self.inner.state.get(self.shard, {})
        return sum(st[k].numel() * st[k].element_size()
                   for k in ("exp_avg", "exp_avg_sq") if k in st)

    def state_dict(self) -> dict:
        return zero1_opt_to_replicated(self)

    def load_state_dict(self, sd: dict) -> None:
        replicated_opt_to_zero1(sd, self)


def _pad(flat: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def create_zero1_state(model: Generator, train_cfg: TrainConfig, mesh,
                       axes=None) -> TrainState:
    """A TrainState whose optimizer is :class:`Zero1Adam` over the batch
    axes of ``mesh``; ``model`` on its device, its weights the same on
    every rank (``core.mesh.replicate`` them first if they are not)."""
    axes = axes or meshlib.batch_axes(mesh)
    return TrainState(model, Zero1Adam(model.parameters(), train_cfg.lr,
                                       mesh, axes))


def zero1_opt_to_replicated(opt: Zero1Adam) -> dict:
    """The blocks' moments, all-gathered, in the layout of
    ``torch.optim.Adam(model.parameters()).state_dict()``: the
    checkpoint's form, which carries no trace of D."""
    ref = torch.optim.Adam(opt.params,
                           lr=opt.inner.param_groups[0]["lr"]).state_dict()
    st = opt.inner.state.get(opt.shard)
    if not st:
        return ref
    full = {k: meshlib.all_gather(st[k], opt.mesh, opt.axes)[:opt.numel]
            for k in ("exp_avg", "exp_avg_sq")}
    state, pos = {}, 0
    for i, p in enumerate(opt.params):
        n = p.numel()
        state[i] = {"step": st["step"].clone(),
                    **{k: v[pos:pos + n].view_as(p).to(p.dtype).clone()
                       for k, v in full.items()}}
        pos += n
    ref["state"] = state
    return ref


def replicated_opt_to_zero1(sd: dict, opt: Zero1Adam) -> Zero1Adam:
    """Load a replicated Adam state_dict (a checkpoint of any topology)
    into ``opt``'s block; the padded tail's moments are zeros."""
    inner = opt.inner.state_dict()
    inner["param_groups"][0].update(
        {k: v for k, v in sd["param_groups"][0].items() if k != "params"})
    if sd["state"]:
        lo = opt.index * opt.block
        st = {}
        for k in ("exp_avg", "exp_avg_sq"):
            flat = opt._padded([sd["state"][i][k]
                                for i in range(len(opt.params))])
            st[k] = flat[lo:lo + opt.block].clone()
        st["step"] = torch.as_tensor(sd["state"][0]["step"]).clone()
        inner["state"] = {0: st}
    opt.inner.load_state_dict(inner)
    return opt


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
              labels: torch.Tensor, audio: torch.Tensor,
              mesh=None) -> dict:
    metrics = _grads(state, train_cfg, vgg, imgs, labels, audio)
    if mesh is not None:
        axes = meshlib.batch_axes(mesh)
        if not isinstance(state.optimizer, Zero1Adam):
            _mean_grads(state.model, mesh, axes)
        names = sorted(metrics)
        means = meshlib.all_reduce(
            torch.stack([metrics[k].float() for k in names]), mesh, axes,
            "mean")
        metrics = dict(zip(names, means.unbind()))
    state.optimizer.step()
    state.step += 1
    return metrics


def _mean_grads(model: nn.Module, mesh, axes) -> None:
    """Average the gradients over ``axes``: one all-reduce of the
    flattened gradients."""
    params = [p for p in model.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    meshlib.all_reduce(flat, mesh, axes, "mean")
    pos = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[pos:pos + n].view_as(p.grad))
        pos += n


def _prepare(state: TrainState, train_cfg: TrainConfig, mesh) -> None:
    """Point the BatchNorms at the mesh (or at nothing) and check that
    the optimizer matches ``train_cfg.zero1``."""
    sync_batchnorm(state.model,
                   *((mesh, meshlib.batch_axes(mesh))
                     if mesh is not None and train_cfg.sync_batchnorm
                     else (None, None)))
    if train_cfg.zero1 != isinstance(state.optimizer, Zero1Adam):
        raise ValueError("train.zero1 needs a state from create_zero1_state "
                         "(and a state from create_zero1_state needs "
                         "train.zero1)")
    if train_cfg.zero1 and mesh is None:
        raise ValueError("train.zero1 shards the optimizer over a mesh: "
                         "pass mesh=")


def _to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor (pinned for an asynchronous copy) -> device."""
    return torch.as_tensor(a).to(device, dtype, non_blocking=True)


def make_train_step(train_cfg: TrainConfig, mesh=None):
    """The host-batch step: fn(state, batch, audio_feats, vgg=None) ->
    metrics (0-d tensors on the card), updating ``state`` in place.

    batch: {'ref', 'masked', 'target': (B,160,160,3) uint8, 'index': (B,)
    int}, numpy arrays or (pinned) host tensors, copied to the card here,
    on the caller's thread; audio_feats: (T, 2, 1024) fp32 on the card;
    vgg: the perceptual trunk, or None to drop that term. With ``mesh``
    the batch is the global one, the same on every rank, and each rank
    takes its rows (module docstring)."""
    def step(state: TrainState, batch: dict, audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features] = None) -> dict:
        _prepare(state, train_cfg, mesh)
        if mesh is not None:
            batch = meshlib.shard_batch(batch, mesh)
        dev, dt = audio_feats.device, state.model.dtype
        ref, masked, target = (_to_device(batch[k], dev)
                               for k in ("ref", "masked", "target"))
        imgs = torch.cat([ref, masked], dim=-1).to(dt) / 255.0
        labels = target.float() / 255.0
        audio = batched_windows(audio_feats, _to_device(batch["index"], dev),
                                mode=state.model.mode).to(dt)
        return _train_on(state, train_cfg, vgg, imgs, labels, audio, mesh)

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
                             crop: CropConfig = CropConfig(), mesh=None):
    """The resident step: fn(state, store (N, S*S*3) uint8 on the card,
    idx (B,), fidx (B,), ex (B,), audio_feats, vgg=None) -> metrics; the
    same numbers as the host-batch step for the same indices
    (data.dataset.ResidentLipSyncDataset). With ``mesh`` the index
    vectors are the global batch's and the store is every rank's own
    whole copy."""
    def step(state: TrainState, store: torch.Tensor, idx, fidx, ex,
             audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features] = None) -> dict:
        _prepare(state, train_cfg, mesh)
        if mesh is not None:
            idx, fidx, ex = (meshlib.shard_rows(torch.as_tensor(v), mesh)
                             for v in (idx, fidx, ex))
        batch = _resident_batch(store, idx, fidx, ex, audio_feats,
                                state.model.mode, state.model.dtype, crop)
        return _train_on(state, train_cfg, vgg, *batch, mesh)

    return step


def make_eval_step(mesh=None):
    """fn(model, imgs6 (B,160,160,6) in [0,1], audio (B,32,32,32)) ->
    (B,160,160,3) fp32: the eval-mode forward (the kernels on the card).
    ``model.eval()`` each call also drops the BatchNorm folds cached before
    the last update. With ``mesh`` each rank runs its rows of the global
    batch and every rank returns the whole output (JAX's
    ``make_eval_step(mesh)``)."""
    def step(model: Generator, imgs: torch.Tensor,
             audio: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            if mesh is None:
                return model(imgs, audio)
            axes = meshlib.batch_axes(mesh)
            out = model(meshlib.shard_rows(imgs, mesh, axes),
                        meshlib.shard_rows(audio, mesh, axes))
            return meshlib.all_gather(out, mesh, axes)

    return step
