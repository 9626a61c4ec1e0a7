"""Expert parallelism: a top-1 mixture-of-experts feed-forward sharded
over an ``expert`` mesh axis (counterpart of calipsync_tpu/core/ep.py).

No model of the system is a mixture of experts; like the JAX module this
is the parallelism axis for growing the audio encoder's FFN capacity
without growing its FLOPs a token, GShard dispatch with Switch routing:

  - routing, dispatch and combine are dense one-hot products over a fixed
    capacity C a group, so no shape depends on the data;
  - :func:`moe_ffn` is the one-device semantics: the tokens split into G
    groups, each routed on its own with capacity
    ``ceil(capacity_factor * tokens_per_group / E)``; a token over
    capacity contributes zero (the caller's residual keeps it);
  - :func:`moe_ffn_ep` runs the same math over S ranks: rank d routes
    token group d and owns experts ``[d*E/S, (d+1)*E/S)``; one
    ``all_to_all`` carries the dispatched rows to their expert's rank and
    a second carries the outputs back.

``moe_ffn_ep`` on S ranks equals ``moe_ffn(groups=S)`` up to fp
reassociation; with one expert the layer is the dense ``nn/hubert.py``
FeedForward (a softmax over one logit is 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.core.mesh import Mesh, all_gather, all_to_all
from calipsync_tpu_torch.nn.hubert import HubertConfig, SelfAttention, gelu

_NAMES = ("router", "w_in", "b_in", "w_out", "b_out")


def init_moe_params(hidden: int, intermediate: int, num_experts: int,
                    seed: int = 0) -> dict:
    """Parameters of a top-1 MoE FFN, experts stacked on a leading
    ``(E, ...)`` axis that a mesh shards: router (H, E) ~ N(0, 0.02),
    w_in (E, H, F) and w_out (E, F, H) uniform in +-1/sqrt(fan-in), zero
    biases (the JAX function's distributions, from a torch seed)."""
    g = torch.Generator().manual_seed(seed)
    s_in, s_out = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(intermediate)

    def uniform(shape, s):
        return (torch.rand(shape, generator=g) * 2 - 1) * s

    return {
        "router": torch.randn((hidden, num_experts), generator=g) * 0.02,
        "w_in": uniform((num_experts, hidden, intermediate), s_in),
        "b_in": torch.zeros((num_experts, intermediate)),
        "w_out": uniform((num_experts, intermediate, hidden), s_out),
        "b_out": torch.zeros((num_experts, hidden)),
    }


def upcycle_ffn_to_moe(ffn_state: dict, num_experts: int,
                       seed: int = 0) -> dict:
    """Sparse upcycling: a dense FeedForward's state_dict
    (``intermediate_dense.*``, ``output_dense.*``, nn/hubert.py) -> E
    identical experts and a fresh near-uniform router."""
    w_in = ffn_state["intermediate_dense.weight"].t()    # (H, F)
    w_out = ffn_state["output_dense.weight"].t()         # (F, H)
    hidden = w_in.shape[0]
    g = torch.Generator().manual_seed(seed)
    return {
        "router": torch.randn((hidden, num_experts), generator=g) * 0.02,
        "w_in": w_in[None].expand(num_experts, -1, -1).clone(),
        "b_in": ffn_state["intermediate_dense.bias"][None].expand(
            num_experts, -1).clone(),
        "w_out": w_out[None].expand(num_experts, -1, -1).clone(),
        "b_out": ffn_state["output_dense.bias"][None].expand(
            num_experts, -1).clone(),
    }


def capacity(tokens_per_group: int, num_experts: int,
             capacity_factor: float) -> int:
    return max(1, math.ceil(capacity_factor * tokens_per_group
                            / num_experts))


def _route(tokens: torch.Tensor, router: torch.Tensor, cap: int):
    """Top-1 routing of one group: dispatch (n, E, C) and gate (n,), both
    in the tokens' dtype; the routing itself in fp32 (a bf16 softmax can
    flip an argmax)."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    e = router.shape[1]
    eidx = probs.argmax(dim=-1)                             # (n,)
    gate = probs.gather(-1, eidx[:, None])[:, 0]
    onehot = F.one_hot(eidx, e)
    pos_tok = ((onehot.cumsum(0) - 1) * onehot).sum(-1)     # 0-based slot
    keep = pos_tok < cap
    dispatch = (onehot.float() * keep[:, None].float())[:, :, None] \
        * F.one_hot(pos_tok.clamp(max=cap - 1), cap).float()[:, None, :]
    return dispatch.to(tokens.dtype), gate.to(tokens.dtype)


def _experts_apply(expert_in: torch.Tensor, params: dict) -> torch.Tensor:
    """(E, C, H) -> (E, C, H): each expert's FFN on its capacity rows, in
    the activations' dtype."""
    dt = expert_in.dtype
    h = gelu(torch.einsum("ech,ehf->ecf", expert_in, params["w_in"].to(dt))
             + params["b_in"].to(dt)[:, None, :])
    return (torch.einsum("ecf,efh->ech", h, params["w_out"].to(dt))
            + params["b_out"].to(dt)[:, None, :])


def _moe_group(tokens: torch.Tensor, params: dict, cap: int
               ) -> torch.Tensor:
    dispatch, gate = _route(tokens, params["router"], cap)
    expert_in = torch.einsum("nec,nh->ech", dispatch, tokens)
    out = _experts_apply(expert_in, params)
    return torch.einsum("nec,ech->nh", dispatch * gate[:, None, None], out)


def moe_ffn(params: dict, x: torch.Tensor, *,
            capacity_factor: float = 1.25, groups: int = 1) -> torch.Tensor:
    """One-device MoE FFN on ``x`` (..., hidden). The tokens split into
    ``groups`` equal groups, each routed with its own capacity (compare an
    EP run of S ranks with ``groups=S``)."""
    lead, hidden = x.shape[:-1], x.shape[-1]
    tokens = x.reshape(-1, hidden)
    n = tokens.shape[0]
    if n % groups:
        raise ValueError(f"{n} tokens not divisible into {groups} groups")
    cap = capacity(n // groups, params["router"].shape[1], capacity_factor)
    y = torch.stack([_moe_group(t, params, cap)
                     for t in tokens.reshape(groups, n // groups, hidden)])
    return y.reshape(*lead, hidden).to(x.dtype)


def moe_ffn_ep(params: dict, x: torch.Tensor, mesh: Mesh,
               axis: str = "expert", *,
               capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel MoE FFN over the S ranks of ``axis``; every rank
    calls it with the same ``x`` and the whole ``params`` and gets the
    whole output. Rank d routes token group d, runs only experts
    ``[d*E/S, (d+1)*E/S)`` (:func:`ep_param_specs`), and the dispatched
    capacity rows ride one ``all_to_all`` out and one back."""
    s = mesh.axis_size(axis)
    e = params["router"].shape[1]
    if e % s:
        raise ValueError(f"{e} experts not divisible over {axis}={s}")
    lead, hidden = x.shape[:-1], x.shape[-1]
    tokens = x.reshape(-1, hidden)
    n = tokens.shape[0]
    if n % s:
        raise ValueError(f"{n} tokens not divisible over {axis}={s}")
    cap = capacity(n // s, e, capacity_factor)
    d, el = mesh.axis_index(axis), e // s
    tg = tokens.reshape(s, n // s, hidden)[d]
    dispatch, gate = _route(tg, params["router"], cap)
    expert_in = torch.einsum("nec,nh->ech", dispatch, tg)
    # block j of dim 0 (experts [j*E/S, (j+1)*E/S)) goes to rank j; block g
    # of what comes back is group g's rows for this rank's experts
    got = all_to_all(expert_in.reshape(s, el, cap, hidden), mesh, axis)
    local = {k: params[k][d * el:(d + 1) * el] for k in _NAMES[1:]}
    out = _experts_apply(got.transpose(0, 1).reshape(el, s * cap, hidden),
                         local)
    # send each group's rows home; rank j's block is experts j*E/S..
    back = all_to_all(out.reshape(el, s, cap, hidden).transpose(0, 1),
                      mesh, axis).reshape(e, cap, hidden)
    y = torch.einsum("nec,ech->nh", dispatch * gate[:, None, None], back)
    return all_gather(y, mesh, axis).reshape(*lead, hidden).to(x.dtype)


def ep_param_specs() -> dict:
    """The dim each parameter of :func:`init_moe_params` shards on over the
    expert axis, or None: the router whole, the expert stacks on their
    leading E axis."""
    return {"router": None, "w_in": 0, "b_in": 0, "w_out": 0, "b_out": 0}


class MoEFeedForward(nn.Module):
    """A drop-in MoE for nn/hubert.py's FeedForward: the stacked expert
    parameters as ``nn.Parameter``s, applied by :func:`moe_ffn`."""

    def __init__(self, config: HubertConfig, num_experts: int = 8,
                 capacity_factor: float = 1.25, groups: int = 1,
                 seed: int = 0):
        super().__init__()
        self.capacity_factor, self.groups = capacity_factor, groups
        init = init_moe_params(config.hidden_size, config.intermediate_size,
                               num_experts, seed)
        for name in _NAMES:
            setattr(self, name, nn.Parameter(init[name]))

    def params(self) -> dict:
        return {name: getattr(self, name) for name in _NAMES}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_ffn(self.params(), x,
                       capacity_factor=self.capacity_factor,
                       groups=self.groups)


class MoEEncoderLayer(nn.Module):
    """nn/hubert.py's EncoderLayer with the FFN swapped for
    :class:`MoEFeedForward` (the same pre/post-LN wiring); with one expert
    it computes the dense layer."""

    def __init__(self, config: HubertConfig, num_experts: int = 8,
                 capacity_factor: float = 1.25, groups: int = 1,
                 seed: int = 0):
        super().__init__()
        self.stable = config.do_stable_layer_norm
        self.attention = SelfAttention(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       eps=config.layer_norm_eps)
        self.moe = MoEFeedForward(config, num_experts, capacity_factor,
                                  groups, seed)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.stable:
            x = x + self.attention(self.layer_norm(x), key_mask)
            return x + self.moe(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, key_mask))
        return self.final_layer_norm(x + self.moe(x))
