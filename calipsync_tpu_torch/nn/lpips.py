"""LPIPS perceptual metric (Zhang et al. 2018), counterpart of
calipsync_tpu/nn/lpips.py.

A frozen classification trunk (VGG16 or AlexNet) tapped at the standard
five stages, unit-normalised per channel, squared difference, learned
1x1 linear heads, mean over space, summed over the stages; not the
single-layer VGG19 proxy of :func:`calipsync_tpu_torch.eval.vgg_distance`.

The module keeps the two standard checkpoint layouts as its keys:
  - torchvision ``vgg16``/``alexnet`` ``features.N.*`` for the trunk
    (``trunk.features.N.*`` here), and
  - the ``lpips`` package's learned heads (``lin{k}.model.1.weight``,
    shape (1, C, 1, 1)).
:func:`import_lpips` assembles the two into the module's state_dict and
checks that every key is used.

Inputs are NHWC RGB in [0, 1]; the LPIPS scaling layer (shift and scale
of [-1, 1] inputs) is folded into one affine of [0, 1] inputs.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

# LPIPS ScalingLayer constants (RGB, [-1,1] inputs).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (torchvision features conv indices per stage, channels per stage)
_VGG16_STAGES = (
    ((0, 2), 64), ((5, 7), 128), ((10, 12, 14), 256),
    ((17, 19, 21), 512), ((24, 26, 28), 512))
# AlexNet: (conv index, out_ch, kernel, stride, pad, maxpool-before)
_ALEX_LAYERS = (
    (0, 64, 11, 4, 2, False),
    (3, 192, 5, 1, 2, True),
    (6, 384, 3, 1, 1, True),
    (8, 256, 3, 1, 1, False),
    (10, 256, 3, 1, 1, False),
)


def conv_indices(net: str) -> list:
    """torchvision ``features`` indices of the trunk's convs."""
    if net == "vgg":
        return [ci for convs, _ in _VGG16_STAGES for ci in convs]
    if net == "alex":
        return [layer[0] for layer in _ALEX_LAYERS]
    raise ValueError(f"unknown LPIPS net: {net}")


def _vgg16_features() -> tuple:
    """torchvision's ``vgg16().features[:30]`` and the indices of the five
    tapped ReLUs (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)."""
    layers: list = []
    taps = []
    cin = 3
    for si, (convs, width) in enumerate(_VGG16_STAGES):
        if si:
            layers.append(nn.MaxPool2d(2, 2))
        for _ in convs:
            layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
            cin = width
        taps.append(len(layers) - 1)
    return nn.Sequential(*layers), taps


def _alex_features() -> tuple:
    """torchvision's ``alexnet().features[:12]`` and its five post-ReLU
    taps."""
    layers: list = []
    taps = []
    cin = 3
    for _, width, k, s, p, pool in _ALEX_LAYERS:
        if pool:
            layers.append(nn.MaxPool2d(3, 2))
        layers += [nn.Conv2d(cin, width, k, s, p), nn.ReLU()]
        taps.append(len(layers) - 1)
        cin = width
    return nn.Sequential(*layers), taps


class Trunk(nn.Module):
    """The torchvision ``features`` prefix of VGG16 or AlexNet; returns the
    five LPIPS taps (NCHW)."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        conv_indices(net)  # raises on an unknown net
        self.features, self.taps = (_vgg16_features() if net == "vgg"
                                    else _alex_features())

    def forward(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out


class VGG16Trunk(Trunk):
    def __init__(self):
        super().__init__("vgg")


class AlexTrunk(Trunk):
    def __init__(self):
        super().__init__("alex")


class _NetLin(nn.Module):
    """The lpips package's ``NetLinLayer``: (dropout, 1x1 conv without
    bias); the dropout is the identity in eval, so it is one here."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPS(nn.Module):
    """lpips(a, b) for NHWC RGB in [0, 1] -> per-example distance (B,),
    fp32.

    Math per richzhang/PerceptualSimilarity ``lpips.LPIPS`` (eval mode):
    scale the inputs, run the trunk, unit-normalise each tap over the
    channels (eps 1e-10), squared difference, 1x1 linear head per tap
    (bias-free, non-negative weights in the released checkpoints), mean
    over space, sum over the taps.
    """

    def __init__(self, net: str = "vgg"):
        super().__init__()
        conv_indices(net)  # raises on an unknown net
        self.net = net
        self.trunk = VGG16Trunk() if net == "vgg" else AlexTrunk()
        widths = ([w for _, w in _VGG16_STAGES] if net == "vgg"
                  else [layer[1] for layer in _ALEX_LAYERS])
        for k, c in enumerate(widths):
            self.add_module(f"lin{k}", _NetLin(c))
        self.register_buffer(
            "shift", torch.from_numpy((_SHIFT + 1.0) / 2.0).view(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "scale", torch.from_numpy(_SCALE / 2.0).view(1, 3, 1, 1),
            persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def prep(x):
            x = x.permute(0, 3, 1, 2).float()
            return ((x - self.shift) / self.scale).contiguous(
                memory_format=torch.channels_last)

        n = a.shape[0]
        taps = self.trunk(torch.cat([prep(a), prep(b)]))
        total = torch.zeros(n, device=a.device)
        for k, f in enumerate(taps):
            f = f / (f.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            diff = (f[:n] - f[n:]).square()
            total = total + getattr(self, f"lin{k}")(diff).mean(dim=(1, 2, 3))
        return total


def import_lpips(trunk_sd: Mapping, heads_sd: Mapping,
                 net: str = "vgg") -> dict:
    """(torchvision trunk state_dict, lpips-package heads state_dict) ->
    the state_dict of :class:`LPIPS` (strict-loadable). Raises KeyError on
    any missing key and ValueError if a state_dict has unused extra
    ``features``/``lin`` keys, as the JAX package's importer does."""
    out = {}
    used = set()
    for ci in conv_indices(net):
        for name in ("weight", "bias"):
            key = f"features.{ci}.{name}"
            out[f"trunk.{key}"] = torch.as_tensor(
                np.asarray(trunk_sd[key]), dtype=torch.float32)
            used.add(key)
    extra = {k for k in trunk_sd if k.startswith("features.")} - used
    if extra:
        raise ValueError(f"unused trunk keys: {sorted(extra)[:4]}...")
    used_h = set()
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        out[key] = torch.as_tensor(np.asarray(heads_sd[key]),
                                   dtype=torch.float32)
        used_h.add(key)
    extra_h = {k for k in heads_sd if "lin" in k and k.endswith("weight")} \
        - used_h
    if extra_h:
        raise ValueError(f"unused head keys: {sorted(extra_h)}")
    return out


def load_lpips(trunk_sd: Mapping, heads_sd: Mapping, net: str = "vgg",
               device=None) -> LPIPS:
    """:func:`import_lpips` loaded strictly into :class:`LPIPS`, frozen, in
    eval mode on ``device`` (default the GPU, ``resolve_device``)."""
    from calipsync_tpu_torch.core.device import resolve_device

    model = LPIPS(net)
    model.load_state_dict(import_lpips(trunk_sd, heads_sd, net), strict=True)
    return model.to(resolve_device(device)).eval().requires_grad_(False)
