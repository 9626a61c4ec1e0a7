"""Tensor-parallel HuBERT over a ``model`` mesh axis, Megatron-style
(counterpart of calipsync_tpu/core/tp.py).

  - q/k/v are column-parallel on the heads: rank r keeps heads
    ``[r*H/T, (r+1)*H/T)`` of each projection and computes their attention;
  - out_proj is row-parallel on the same heads;
  - the MLP is column-parallel (intermediate_dense) then row-parallel
    (output_dense).

So a layer takes two all-reduces, one after out_proj and one after
output_dense (``nn/hubert.py::_row_parallel``), each before the bias,
which is added once. The conv front end, the norms, the positional conv
and the projection stay whole on every rank. The JAX package lets GSPMD
derive this schedule from the weights' shardings; here the shards and
the two all-reduces are explicit (no DTensor), so the forward is the
one-card module's code with fewer heads and a sum.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from calipsync_tpu_torch.core.mesh import Mesh
from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel

_COLUMN = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
_ROW = ("out_proj", "output_dense")


def hubert_tp_specs(state_dict: dict) -> dict:
    """key -> the dim its tensor shards on over the model axis, or None
    (replicated), for a HubertModel state_dict: q/k/v and
    intermediate_dense weights and biases on dim 0 (their output
    features), out_proj and output_dense weights on dim 1 (their input
    features); everything else, and the row-parallel biases, whole."""
    specs = {}
    for key in state_dict:
        parts = key.split(".")
        name, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", key)
        if "layers" not in parts:
            specs[key] = None
        elif name in _COLUMN:
            specs[key] = 0
        elif name in _ROW and leaf == "weight":
            specs[key] = 1
        else:
            specs[key] = None
    return specs


def _check_divisible(config: HubertConfig, tp: int, axis: str) -> None:
    if config.num_attention_heads % tp:
        raise ValueError(f"num_attention_heads={config.num_attention_heads}"
                         f" not divisible by {axis}={tp}")
    if config.intermediate_size % tp:
        raise ValueError(f"intermediate_size={config.intermediate_size} "
                         f"not divisible by {axis}={tp}")


def _keep(lin: nn.Linear, dim: int, r: int, tp: int) -> None:
    """Keep block ``r`` of ``tp`` along ``dim`` of ``lin``'s weight (and
    of its bias for the output dim)."""
    w = lin.weight.data
    n = w.shape[dim] // tp
    lin.weight = nn.Parameter(w.narrow(dim, r * n, n).contiguous(),
                              requires_grad=False)
    if dim == 0:
        lin.bias = nn.Parameter(lin.bias.data[r * n:(r + 1) * n].clone(),
                                requires_grad=False)
        lin.out_features = n
    else:
        lin.in_features = n


def shard_hubert(model: HubertModel, mesh: Mesh, axis: str = "model",
                 config: Optional[HubertConfig] = None) -> HubertModel:
    """Shard ``model`` (weights loaded, the same on every rank) in place
    over ``axis`` of ``mesh``: each rank keeps its heads and its block of
    the MLP (:func:`hubert_tp_specs`). Every rank then calls the model
    with the same input and gets the whole output. Inference only: the
    all-reduces carry no gradient."""
    config = config or model.config
    tp = mesh.axis_size(axis)
    _check_divisible(config, tp, axis)
    r = mesh.axis_index(axis)
    with torch.no_grad():
        for layer in model.encoder.layers:
            att, ff = layer.attention, layer.feed_forward
            for name in ("q_proj", "k_proj", "v_proj"):
                _keep(getattr(att, name), 0, r, tp)
            _keep(att.out_proj, 1, r, tp)
            att.heads //= tp
            _keep(ff.intermediate_dense, 0, r, tp)
            _keep(ff.output_dense, 1, r, tp)
            att.tp = ff.tp = (mesh, axis)
    return model
