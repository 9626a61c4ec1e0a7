"""Pipeline-parallel HuBERT over a ``model`` mesh axis, GPipe
(counterpart of calipsync_tpu/core/pp.py).

Over an axis of S ranks, stage ``s`` runs layers ``[s*L/S, (s+1)*L/S)``
and activations hop stage to stage by send/recv, on a GPipe schedule of
``M + S - 1`` ticks: at tick t stage s runs microbatch ``t - s``. The
conv front end, the projection, the positional conv and the final norm
are replicated (every stage runs them on the whole batch, as the JAX
function does), so stage 0 takes its microbatches from its own front-end
output, where the JAX program ring-shifts them in over ICI to save
memory. Each stage rebuilds its microbatch's key mask from the
microbatch id, and the last stage's output is broadcast, so every stage
returns the whole result (the JAX ``psum``).

Microbatching splits only the batch axis and every microbatch runs the
same layers in order, so the result equals the sequential encoder up to
fp reassociation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from calipsync_tpu_torch.core.mesh import (Mesh, all_gather, broadcast,
                                           exchange)
from calipsync_tpu_torch.nn.hubert import HubertModel


def stack_encoder_layers(state_dict: dict) -> dict:
    """A HubertModel state_dict's ``encoder.layers.{i}.*`` tensors stacked
    into one (L, ...) tensor a name (``attention.q_proj.weight``, ...)."""
    prefix = "encoder.layers."
    per_layer: dict = {}
    for key, value in state_dict.items():
        if key.startswith(prefix):
            i, name = key[len(prefix):].split(".", 1)
            per_layer.setdefault(name, {})[int(i)] = value
    return {name: torch.stack([d[i] for i in range(len(d))])
            for name, d in per_layer.items()}


def stage_layers(model: HubertModel, mesh: Mesh, axis: str = "model"
                 ) -> list:
    """This rank's slice of the encoder's layers."""
    layers = list(model.encoder.layers)
    s, n = mesh.axis_size(axis), len(layers)
    if n % s:
        raise ValueError(f"{n} layers not divisible by {s} stages")
    i = mesh.axis_index(axis)
    return layers[i * n // s:(i + 1) * n // s]


def drop_other_stages(model: HubertModel, mesh: Mesh,
                      axis: str = "model") -> HubertModel:
    """Replace every layer outside this rank's stage by ``nn.Identity``, so
    a rank holds only its L/S layers (and the replicated front end)."""
    keep = {id(m) for m in stage_layers(model, mesh, axis)}
    model.encoder.layers = nn.ModuleList(
        m if id(m) in keep else nn.Identity() for m in model.encoder.layers)
    return model


def hubert_pp_apply(model: HubertModel, wav: torch.Tensor, mesh: Mesh,
                    axis: str = "model",
                    num_microbatches: Optional[int] = None,
                    num_valid_samples: Optional[torch.Tensor] = None,
                    data_axis: Optional[str] = None) -> torch.Tensor:
    """``model(wav, num_valid_samples)`` with the layer stack pipelined
    over ``axis``; every rank calls it with the same arguments and gets
    the whole (B, frames, hidden) output.

    ``num_microbatches`` M (default: one a stage) must divide B and be a
    multiple of S (the JAX function shards the input stream over the
    stages). ``data_axis``: a second mesh axis of data parallelism over
    the pipeline: each of its D ranks runs the whole schedule on its 1/D
    of every microbatch (B/M must divide by D), and the rows are
    all-gathered at the end."""
    S = mesh.axis_size(axis)
    L = len(model.encoder.layers)
    if L % S:
        raise ValueError(f"{L} layers not divisible by {S} stages")
    M = int(num_microbatches or S)
    B = wav.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if M % S:
        raise ValueError(f"{M} microbatches not divisible by {S} stages "
                         "(the input stream shards over stages)")
    D = 1 if data_axis is None else mesh.axis_size(data_axis)
    if (B // M) % D:
        raise ValueError(f"per-microbatch batch {B // M} not divisible by "
                         f"data axis {D}")

    x, key_mask = model.front(wav, num_valid_samples)
    x = model.encoder.embed(x)
    b = B // M // D
    d = 0 if data_axis is None else mesh.axis_index(data_axis)

    def micro(t, m):  # microbatch m, this data rank's rows
        if t is None:
            return None
        return t.reshape(M, B // M, *t.shape[1:])[m, d * b:(d + 1) * b]

    s = mesh.axis_index(axis)
    layers = stage_layers(model, mesh, axis)
    out = x.new_empty((M, b) + tuple(x.shape[1:]))
    buf = x.new_empty((b,) + tuple(x.shape[1:]))
    for t in range(M + S - 1):
        m = t - s
        h = None
        if 0 <= m < M:
            h = micro(x, m) if s == 0 else buf
            km = micro(key_mask, m)
            for layer in layers:
                h = layer(h, km)
            if s == S - 1:
                out[m] = h
        sends = [(h, s + 1)] if h is not None and s < S - 1 else []
        nxt = t + 1 - s  # the microbatch this stage runs next tick
        recvs = [(buf, s - 1)] if s > 0 and 0 <= nxt < M else []
        if sends or recvs:
            exchange(sends, recvs, mesh, axis)
    broadcast(out, mesh, axis, src_index=S - 1)
    if data_axis is not None:
        # (M, b, ...) on each data rank -> (M, D*b, ...), data-rank-major
        # within each microbatch, as the rows were taken
        full = all_gather(out.transpose(0, 1).contiguous(), mesh, data_axis)
        out = full.reshape(D, b, *out.shape[:1], *out.shape[2:])
        out = out.movedim(2, 0)
    return model.encoder.finish(out.reshape(B, *x.shape[1:]))
