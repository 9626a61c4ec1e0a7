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

K steps a dispatch (:func:`make_resident_multi_step`,
``TrainConfig.steps_per_dispatch``): on the card the K resident steps of
one (K, B) index block run as one captured ``torch.cuda.CUDAGraph``,
replayed once a block, PyTorch's form of JAX's one XLA program for the K
steps; on the CPU, and over a gloo group, they run one after another.
"""

from __future__ import annotations

import gc
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


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` (torch's defaults, as ``optax.adam``) whose
    state a CUDA graph can hold. :meth:`make_capturable` puts its step
    count on the device, so that a captured update reads and advances it
    there; only an optimizer that :func:`make_resident_multi_step`
    captures takes it, and the eager steps keep PyTorch's default update,
    whose step count stays on the host (chip_smoke.py 7f times both on
    the card; the capturable update also rounds differently, so a
    dispatch equals eager steps to the bit only when they take it).
    :meth:`load_state_dict` keeps this optimizer's own ``capturable`` (a
    checkpoint written by a captured optimizer loads into any other, and
    any checkpoint into a captured one) and copies into the state tensors
    it already holds instead of rebinding them, since a captured graph
    reads those very tensors."""

    def make_capturable(self) -> None:
        """The step count on each parameter's device and the update
        ``capturable``; done before a capture (it rebinds the counts)."""
        for group in self.param_groups:
            group["capturable"] = True
        for p, st in self.state.items():
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device)

    def load_state_dict(self, state_dict: dict) -> None:
        held = {p: dict(st) for p, st in self.state.items()}
        groups = [{**saved, "capturable": ours["capturable"]}
                  for saved, ours in zip(state_dict["param_groups"],
                                         self.param_groups)]
        super().load_state_dict({**state_dict, "param_groups": groups})
        with torch.no_grad():
            for p, st in self.state.items():
                for k, old in held.get(p, {}).items():
                    new = st.get(k)
                    if (torch.is_tensor(old) and torch.is_tensor(new)
                            and old.shape == new.shape):
                        st[k] = old.copy_(new)


def create_train_state(model: Generator,
                       train_cfg: TrainConfig) -> TrainState:
    return TrainState(model, Adam(model.parameters(), lr=train_cfg.lr))


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
        self.inner = Adam([self.shard], lr=lr)

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
            # the train-mode forward draws no random numbers, so the
            # recompute needs no RNG state (and a CUDA graph's capture
            # could not read or set it)
            pred = checkpoint(model, im, au, use_reentrant=False,
                              preserve_rng_state=False)
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
        metrics = _train_on(state, train_cfg, vgg, imgs, labels, audio, mesh)
        state.step += 1
        return metrics

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


def _resident_body(train_cfg: TrainConfig, crop: CropConfig, mesh):
    """One resident step without its count: fn(state, store, idx, fidx,
    ex, audio_feats, vgg) -> metrics."""
    def body(state: TrainState, store: torch.Tensor, idx, fidx, ex,
             audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features]) -> dict:
        _prepare(state, train_cfg, mesh)
        if mesh is not None:
            idx, fidx, ex = (meshlib.shard_rows(torch.as_tensor(v), mesh)
                             for v in (idx, fidx, ex))
        batch = _resident_batch(store, idx, fidx, ex, audio_feats,
                                state.model.mode, state.model.dtype, crop)
        return _train_on(state, train_cfg, vgg, *batch, mesh)

    return body


def make_resident_train_step(train_cfg: TrainConfig,
                             crop: CropConfig = CropConfig(), mesh=None):
    """The resident step: fn(state, store (N, S*S*3) uint8 on the card,
    idx (B,), fidx (B,), ex (B,), audio_feats, vgg=None) -> metrics; the
    same numbers as the host-batch step for the same indices
    (data.dataset.ResidentLipSyncDataset). With ``mesh`` the index
    vectors are the global batch's and the store is every rank's own
    whole copy."""
    body = _resident_body(train_cfg, crop, mesh)

    def step(state: TrainState, store: torch.Tensor, idx, fidx, ex,
             audio_feats: torch.Tensor,
             vgg: Optional[VGG19Features] = None) -> dict:
        metrics = body(state, store, idx, fidx, ex, audio_feats, vgg)
        state.step += 1
        return metrics

    return step


# Eager steps on a side stream before a capture (PyTorch's whole-network
# capture recipe): they build Adam's state, cuDNN's plans and the caching
# allocator's blocks, and set the attention kernel's shared-memory
# attribute (cudaFuncSetAttribute, which the kernel's launch calls only the
# first time it meets a size), so that none of it happens in the capture.
GRAPH_WARMUP_STEPS = 3


def _host_staged_mesh(mesh) -> bool:
    """Whether a collective of ``mesh``'s batch group goes through a gloo
    group: core/mesh.py stages those through host memory (or gloo runs
    them on the host), which a CUDA graph cannot hold."""
    import torch.distributed as dist

    return (mesh is not None and dist.get_backend(
        mesh.group(meshlib.batch_axes(mesh))) == "gloo")


def _optimizers(opt) -> list:
    """The torch optimizers behind a TrainState's optimizer."""
    return [opt.inner] if isinstance(opt, Zero1Adam) else [opt]


def _held_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a captured step reads or writes in place: the
    parameters, the BatchNorm buffers and the optimizers' parameters and
    state (Adam's moments and step count)."""
    held = list(state.model.parameters()) + list(state.model.buffers())
    for opt in _optimizers(state.optimizer):
        for group in opt.param_groups:
            for p in group["params"]:
                held.append(p)
                held.extend(v for v in opt.state.get(p, {}).values()
                            if torch.is_tensor(v))
    return held


class _StepGraph:
    """K resident steps captured in one ``torch.cuda.CUDAGraph`` and
    replayed once a (K, B) block.

    PyTorch's whole-network capture: the optimizers made capturable
    (:meth:`Adam.make_capturable`), :data:`GRAPH_WARMUP_STEPS` eager steps
    on a side stream, then the K steps (the gather from the store, the
    mouth mask, the audio windows, the forward with the attention kernel,
    the L1 and VGG losses, the backward, the collectives over an NCCL
    group and the Adam update) are captured into one graph whose
    activations and gradients live in its private memory pool. The warm-up
    steps' updates are undone before the capture (every tensor the step
    holds is put back as it was, Adam's state created by the warm-up to
    its zeros), so a replay runs the caller's K steps from the caller's
    state. Step k reads row k of one static (3, K, B) index buffer, which
    each dispatch fills with one copy before it replays.

    The graph reads and writes the state's own tensors, the store, the
    features and the VGG weights at the addresses they had at the capture,
    and holds those objects (``inputs``); a replay checks that none of the
    state's tensors was rebound (a checkpoint loads by copying into them,
    :class:`Adam`) and raises if one was."""

    def __init__(self, body, state: TrainState, store, audio_feats, vgg,
                 blocks: torch.Tensor):
        from calipsync_tpu_torch import kernels

        dev = store.device
        k = blocks.shape[1]
        self.k = k
        self.shape = tuple(blocks.shape)
        self.inputs = (state.model, state.optimizer, store, audio_feats,
                       vgg)
        for opt in _optimizers(state.optimizer):
            opt.make_capturable()
        self.index = torch.empty(blocks.shape, dtype=torch.long, device=dev)
        self.index.copy_(blocks)
        # the host's copy of a block, pinned so that its upload is
        # asynchronous; ``copied`` marks when the upload has read it
        self.staging = torch.empty(blocks.shape, dtype=torch.long,
                                   pin_memory=True)
        self.copied = torch.cuda.Event()

        def steps(n):
            return [body(state, store, self.index[0, i % k],
                         self.index[1, i % k], self.index[2, i % k],
                         audio_feats, vgg) for i in range(n)]

        before = {id(t): t.detach().clone() for t in _held_tensors(state)}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            steps(GRAPH_WARMUP_STEPS)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t in _held_tensors(state):
                saved = before.get(id(t))
                t.copy_(saved) if saved is not None else t.zero_()
        del before
        state.optimizer.zero_grad(set_to_none=True)

        self.graph = torch.cuda.CUDAGraph()
        captured = kernels.captured_counts()
        # Another graph that only the garbage collector frees (one held in
        # a reference cycle) would be destroyed by a collection that ran
        # inside this capture, and freeing its memory pool there
        # invalidates the capture: collect now, and hold the collector off
        # until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # "thread_local": the process group's watchdog thread may poll
            # its events while this thread captures
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                ms = steps(k)
                self.metrics = {name: torch.stack([m[name] for m in ms])
                                for name in ms[0]}
        finally:
            if collecting:
                gc.enable()
        # the kernels' launches that one replay runs
        self.launches = {name: n - captured[name] for name, n in
                         kernels.captured_counts().items()}
        self.held = [t.data_ptr() for t in _held_tensors(state)]

    def captured_for(self, state: TrainState, store, audio_feats, vgg,
                     blocks: torch.Tensor) -> bool:
        """Whether this graph runs these inputs: the same block shape and
        the very objects it was captured with."""
        return (tuple(blocks.shape) == self.shape and all(
            a is b for a, b in zip(self.inputs, (
                state.model, state.optimizer, store, audio_feats, vgg))))

    def run(self, state: TrainState, blocks: torch.Tensor) -> dict:
        from calipsync_tpu_torch import kernels

        if [t.data_ptr() for t in _held_tensors(state)] != self.held:
            raise RuntimeError(
                "make_resident_multi_step: a tensor of the train state was "
                "rebound since its CUDA graph was captured (load a state "
                "by copying into it, as Adam.load_state_dict and "
                "Module.load_state_dict do)")
        self.copied.synchronize()  # the last block's upload is done
        self.staging.copy_(blocks)
        # stream order: the upload waits for the last replay's reads
        self.index.copy_(self.staging, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        kernels.note_replay(self.launches)
        state.step += self.k
        return {name: v.clone() for name, v in self.metrics.items()}


class _MultiStep:
    """The function :func:`make_resident_multi_step` returns (a class and
    not a closure, so that no reference cycle keeps its graph alive)."""

    def __init__(self, train_cfg: TrainConfig, crop: CropConfig, mesh):
        self.mesh = mesh
        self.body = _resident_body(train_cfg, crop, mesh)
        self.graph: Optional[_StepGraph] = None
        self.graphed = False

    def __call__(self, state: TrainState, store: torch.Tensor, idx, fidx,
                 ex, audio_feats: torch.Tensor,
                 vgg: Optional[VGG19Features] = None) -> dict:
        blocks = torch.stack([torch.as_tensor(v) for v in (idx, fidx, ex)])
        if blocks.dim() != 3:
            raise ValueError(f"index blocks of shape {tuple(blocks.shape)[1:]}"
                             ": (K, B) expected")
        self.graphed = (store.device.type == "cuda"
                        and not _host_staged_mesh(self.mesh))
        if not self.graphed:
            ms = []
            for i, f, e in zip(*blocks):
                ms.append(self.body(state, store, i, f, e, audio_feats, vgg))
                state.step += 1
            return {name: torch.stack([m[name] for m in ms])
                    for name in ms[0]}
        if self.graph is None or not self.graph.captured_for(
                state, store, audio_feats, vgg, blocks):
            self.graph = None  # the old graph and its pool go first
            self.graph = _StepGraph(self.body, state, store, audio_feats,
                                    vgg, blocks)
        return self.graph.run(state, blocks)


def make_resident_multi_step(train_cfg: TrainConfig,
                             crop: CropConfig = CropConfig(), mesh=None):
    """K steps a dispatch (JAX's ``make_resident_multi_step``): fn(state,
    store, idx (K,B), fidx (K,B), ex (K,B), audio_feats, vgg=None) ->
    metrics, each a (K,) tensor on the store's device that stays there.
    ``state.step`` goes up by K, and step k runs from step k-1's
    parameters, as JAX's scan carries them; the K losses are those of K
    calls of :func:`make_resident_train_step` on the rows of the block.

    - On the CPU the K steps run one after another (JAX's unrolled form
      on the CPU).
    - On the card they run as one captured ``torch.cuda.CUDAGraph``
      (:class:`_StepGraph`), captured at the first call and again when
      the block's shape, the state, the store, the features or the VGG
      differ from the last capture's, and replayed once a block: the host uploads the (K, B) index block into the
      graph's static buffer and replays. Over an NCCL group the gradient,
      metric and BatchNorm all-reduces are captured too.
    - Over a gloo group core/mesh.py stages collectives through host
      memory, which a graph cannot capture: the card then runs the K steps
      eagerly.

    ``fn.graphed`` says whether the last call replayed a graph. A capture
    that fails raises; nothing falls back to eager steps."""
    return _MultiStep(train_cfg, crop, mesh)


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
