"""VGG19 feature trunk of the perceptual loss (counterpart of
calipsync_tpu/nn/vgg.py): torchvision's ``vgg19.features`` cut at index 14,
conv3_3 before its ReLU, with 2x2 max pools after conv1_2 and conv2_2. The
input is NHWC RGB in [0, 1] with no ImageNet normalization, as the
reference's PerceptualLoss feeds it.

The parameters keep torchvision's keys (``features.N.weight`` /
``features.N.bias``), so the 14 the trunk needs load by name from a full
``vgg19-dcbb9e9d.pth`` (:func:`load_vgg19`). They stay fp32; the compute
dtype is the module's ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg19.features indices of the kept convs, their widths, and
# whether a ReLU / 2x2 max pool follows inside the prefix [0..14]
LAYERS = (
    (0, 64, True, False),
    (2, 64, True, True),
    (5, 128, True, False),
    (7, 128, True, True),
    (10, 256, True, False),
    (12, 256, True, False),
    (14, 256, False, False),  # conv3_3: the loss taps it pre-activation
)


class VGG19Features(nn.Module):
    """conv1_1 .. conv3_3 of VGG19: (B, H, W, 3) in [0, 1] -> (B, H/4, W/4,
    256) in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        cin = 3
        for idx, width, relu, pool in LAYERS:
            layers.append(nn.Conv2d(cin, width, 3, padding=1))
            if relu:
                layers.append(nn.ReLU())
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            cin = width
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt),
                             padding=1)
            else:
                x = layer(x)
        return x.permute(0, 2, 3, 1)


def vgg19_state_dict(sd: dict) -> dict:
    """The trunk's 14 tensors out of a torchvision ``vgg19`` state_dict
    (38 keys) or its ``features.``-prefixed subset."""
    out = {}
    for idx, *_ in LAYERS:
        for name in ("weight", "bias"):
            key = f"features.{idx}.{name}"
            if key not in sd:
                raise KeyError(f"{key} missing from the VGG19 state_dict")
            out[key] = sd[key]
    return out


def load_vgg19(path: str, dtype: torch.dtype = torch.float32,
               device=None) -> VGG19Features:
    """``vgg19-dcbb9e9d.pth`` (or any state_dict with its keys) -> the
    trunk, loaded strictly, frozen, in eval mode on ``device`` (default
    the GPU, ``resolve_device``)."""
    from calipsync_tpu_torch.core.device import resolve_device

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = VGG19Features(dtype)
    model.load_state_dict(vgg19_state_dict(sd), strict=True)
    return model.to(resolve_device(device)).eval().requires_grad_(False)
