"""HuBERT speech encoder in PyTorch (counterpart of
calipsync_tpu/nn/hubert.py; the reference drives HF's ``HubertModel``,
facebook/hubert-large-ls960-ft, for its audio features).

A conv feature extractor and a transformer encoder, in both of HF's
config families:

  - ``feat_extract_norm='layer'`` + ``do_stable_layer_norm=True``  (large)
  - ``feat_extract_norm='group'`` + ``do_stable_layer_norm=False`` (base)

Parameter names are HF ``HubertModel``'s, so an HF state_dict loads with
``strict=True``. The positional conv keeps HF's weight-norm pair
(``weight_g``, ``weight_v``) and folds it at each forward exactly as the
JAX importer folds it at import (norm over dims 0 and 1); the newer
spelling ``parametrizations.weight.original0/1`` is renamed on load.
``masked_spec_embed`` is kept for the key set and unused (HF applies it
only when training). Exact (erf) GELU throughout.

The math follows the JAX module: q is scaled by d^-0.5 before q.k, the
logits and softmax are fp32, masked keys take -1e30 (never -inf, so a
fully masked row stays finite), and the valid frames of
``num_valid_samples`` zero pad frames after the projection and mask pad
keys.

The convolutions run as products over unfolded windows (:func:`conv1d`),
not through cuDNN: PyTorch's default flags let cuDNN compute fp32 convs
in TF32 (``torch.backends.cudnn.allow_tf32``), while products follow the
float32 matmul precision, full fp32 by default. So the model computes in
its stated dtype under PyTorch's defaults, and sets no global flag.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MASKED_LOGIT = -1e30


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as jax.nn.gelu(approximate=False)


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"      # 'layer' | 'group'
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def large(cls) -> "HubertConfig":
        """facebook/hubert-large-ls960-ft."""
        return cls()

    @classmethod
    def base(cls) -> "HubertConfig":
        """facebook/hubert-base-ls960."""
        return cls(hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   conv_bias=False, feat_extract_norm="group",
                   do_stable_layer_norm=False)

    @classmethod
    def from_hf(cls, hf_config) -> "HubertConfig":
        """From an HF config: a dict, or the path of a ``config.json``
        (``transformers`` is never imported here)."""
        if not isinstance(hf_config, Mapping):
            hf_config = json.loads(pathlib.Path(hf_config).read_text())
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in hf_config:
                v = hf_config[f.name]
                kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)

    def num_frames(self, num_samples: int) -> int:
        """Output frame count for a waveform length (conv stride chain)."""
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """``F.conv1d`` as one batched product over unfolded windows: (B, C,
    L) in, (B, O, T) out. The windows are copied out once (C/groups x K
    values a frame a group), which the product reads."""
    if padding:
        x = F.pad(x, (padding, padding))
    b = x.shape[0]
    out_ch, cin_g, k = weight.shape
    cols = x.unfold(2, k, stride)                      # (B, C, T, K) view
    t = cols.shape[2]
    cols = cols.reshape(b, groups, cin_g, t, k).permute(0, 1, 3, 2, 4)
    cols = cols.reshape(b, groups, t, cin_g * k)
    w = weight.reshape(groups, out_ch // groups, cin_g * k)
    y = torch.matmul(cols, w.transpose(1, 2))          # (B, G, T, O/G)
    y = y.permute(0, 1, 3, 2).reshape(b, out_ch, t)
    return y if bias is None else y + bias[:, None]


class ProductConv1d(nn.Conv1d):
    """``nn.Conv1d`` (its parameters and state-dict keys) computed by
    :func:`conv1d`; no padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.stride[0],
                      groups=self.groups)


def normalize_wav(speech) -> torch.Tensor:
    """Per-utterance zero-mean unit-variance over the last axis
    (Wav2Vec2FeatureExtractor with do_normalize=True): fp32, population
    variance, eps 1e-7."""
    if not torch.is_tensor(speech):
        speech = torch.from_numpy(np.asarray(speech, np.float32))
    speech = speech.float()
    mean = speech.mean(dim=-1, keepdim=True)
    var = speech.var(dim=-1, unbiased=False, keepdim=True)
    return (speech - mean) / torch.sqrt(var + 1e-7)


class ConvLayer(nn.Module):
    """One feature-extractor layer: conv, then LayerNorm over channels
    ('layer'), GroupNorm with one group a channel ('group', first layer
    only) or nothing, then GELU. (B, C, T) in and out."""

    def __init__(self, cfg: HubertConfig, i: int):
        super().__init__()
        cin = 1 if i == 0 else cfg.conv_dim[i - 1]
        dim = cfg.conv_dim[i]
        self.conv = ProductConv1d(cin, dim, cfg.conv_kernel[i],
                                  stride=cfg.conv_stride[i],
                                  bias=cfg.conv_bias)
        norm = cfg.feat_extract_norm
        if norm not in ("layer", "group"):
            raise ValueError(f"unknown feat_extract_norm: {norm!r}")
        self.layer_norm = (
            nn.LayerNorm(dim, eps=cfg.layer_norm_eps) if norm == "layer"
            else nn.GroupNorm(dim, dim, eps=cfg.layer_norm_eps) if i == 0
            else None)

    def forward(self, x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """``n_valid`` (B,): the output steps computed from real samples
        only; the GroupNorm takes its statistics over those, so padding
        does not change them."""
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = _masked_group_norm(self.layer_norm, x, n_valid)
        return gelu(x)


def _masked_group_norm(norm: nn.GroupNorm, x: torch.Tensor,
                       n_valid: torch.Tensor) -> torch.Tensor:
    """A GroupNorm of one group a channel over (B, C, T), its mean and
    (biased) variance over each row's first ``n_valid`` steps (a row
    without one stays finite)."""
    t = torch.arange(x.shape[-1], device=x.device)
    m = (t[None, :] < n_valid[:, None]).to(x.dtype)[:, None]
    count = m.sum(dim=-1, keepdim=True).clamp(min=1)
    mean = (x * m).sum(dim=-1, keepdim=True) / count
    var = ((x - mean).square() * m).sum(dim=-1, keepdim=True) / count
    y = (x - mean) * torch.rsqrt(var + norm.eps)
    return y * norm.weight[None, :, None] + norm.bias[None, :, None]


class FeatureExtractor(nn.Module):
    """Raw wav (B, T) and the real samples of each row (B,) ->
    (B, frames, conv_dim[-1]) and the frames computed from real samples
    only (B,)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            [ConvLayer(cfg, i) for i in range(len(cfg.conv_dim))])

    def forward(self, wav: torch.Tensor, num_valid_samples: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = wav[:, None, :]
        n = num_valid_samples.to(wav.device)
        for layer in self.conv_layers:
            # the steps whose window holds real samples only
            n = (n - layer.conv.kernel_size[0]) // layer.conv.stride[0] + 1
            x = layer(x, n)
        return x.transpose(1, 2), n.clamp(min=0)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class WeightNormConv1d(nn.Module):
    """Grouped Conv1d whose weight is HF's weight-norm pair: w = g v /
    |v|, the norm over dims 0 and 1 for each kernel tap."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.padding = kernel // 2
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight_v, std=(kernel * channels / groups)
                        ** -0.5)

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g / _tap_norm(v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight().to(x.dtype), self.bias.to(x.dtype),
                      padding=self.padding, groups=self.groups)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torch >= 2.1 saves nn.utils.parametrizations.weight_norm's pair
        # under these names; they are the same g and v
        for new, old in (("weight_g", "parametrizations.weight.original0"),
                         ("weight_v", "parametrizations.weight.original1")):
            if prefix + old in state_dict:
                state_dict[prefix + new] = state_dict.pop(prefix + old)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _tap_norm(v: torch.Tensor) -> torch.Tensor:
    return v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding; an even kernel's trailing frame
    is trimmed (HF's HubertSamePadLayer). (B, T, C) in and out."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv = WeightNormConv1d(cfg.hidden_size,
                                     cfg.num_conv_pos_embeddings,
                                     cfg.num_conv_pos_embedding_groups)
        self.trim = cfg.num_conv_pos_embeddings % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.transpose(1, 2))
        if self.trim:
            y = y[:, :, :-1]
        return gelu(y).transpose(1, 2)


def _row_parallel(lin: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """``lin(x)``; under tensor parallelism (``tp`` = (mesh, axis), set by
    ``core/tp.py``) ``lin`` holds this rank's input columns, so the partial
    products are summed over the axis before the bias is added once."""
    if tp is None:
        return lin(x)
    from calipsync_tpu_torch.core.mesh import all_reduce

    return all_reduce(F.linear(x, lin.weight), *tp) + lin.bias


class SelfAttention(nn.Module):
    # (mesh, axis) when the heads are sharded over a mesh axis (core/tp.py)
    tp = None

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // self.heads
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            setattr(self, name, nn.Linear(cfg.hidden_size, cfg.hidden_size))

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape

        def heads(t):  # (B, N, H*D) -> (B, H, N, D)
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_proj(x) * self.head_dim ** -0.5)
        k = heads(self.k_proj(x))
        v = heads(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if key_mask is not None:  # (B, N) True = attend
            logits = logits.masked_fill(~key_mask[:, None, None, :],
                                        MASKED_LOGIT)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return _row_parallel(self.out_proj, out.to(x.dtype), self.tp)


class FeedForward(nn.Module):
    tp = None  # as SelfAttention.tp

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _row_parallel(self.output_dense,
                             gelu(self.intermediate_dense(x)), self.tp)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.stable:  # pre-LN (large)
            x = x + self.attention(self.layer_norm(x), key_mask)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, key_mask))  # post-LN
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The positional conv (and the post-LN model's norm): what runs
        ahead of the layers."""
        x = x + self.pos_conv_embed(x)
        return x if self.stable else self.layer_norm(x)

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        """What runs after the layers: the pre-LN model's final norm."""
        return self.layer_norm(x) if self.stable else x

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(x)
        for layer in self.layers:
            x = layer(x, key_mask)
        return self.finish(x)


class HubertModel(nn.Module):
    """(B, num_samples) normalized wav -> (B, frames, hidden) last states.

    ``num_valid_samples`` (B,) gives exact variable-length inference on
    bucket-padded inputs: the 'group' extractor's GroupNorm takes its
    statistics over the steps computed from real samples (the JAX module
    takes them over the whole padded length), features at pad frames are
    zeroed after the projection (the positional conv then sees the zero
    padding an unpadded run would) and pad keys are masked out of
    attention, so the real frames match an unpadded forward. Trim the
    output to ``config.num_frames(true_samples)`` rows. Without it every
    sample is real.

    The compute dtype is the parameters' (``model.to(torch.bfloat16)``);
    the attention logits and softmax stay fp32.
    """

    def __init__(self, config: HubertConfig = HubertConfig()):
        super().__init__()
        self.config = config
        self.masked_spec_embed = nn.Parameter(torch.zeros(config.hidden_size))
        self.feature_extractor = FeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)

    def forward(self, input_values: torch.Tensor,
                num_valid_samples: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x, key_mask = self.front(input_values, num_valid_samples)
        return self.encoder(x, key_mask)

    def front(self, input_values: torch.Tensor,
              num_valid_samples: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The conv front end and the projection, pad frames zeroed: the
        encoder's input and its key mask (None when unmasked)."""
        dtype = self.masked_spec_embed.dtype
        masked = num_valid_samples is not None
        if not masked:
            num_valid_samples = torch.full((input_values.shape[0],),
                                           input_values.shape[1],
                                           device=input_values.device)
        x, num_valid_frames = self.feature_extractor(
            input_values.to(dtype), num_valid_samples)
        x = self.feature_projection(x)
        key_mask = None
        if masked:
            frames = torch.arange(x.shape[1], device=x.device)
            key_mask = frames[None, :] < num_valid_frames[:, None]
            x = x.masked_fill(~key_mask[..., None], 0.0)
        return x, key_mask
