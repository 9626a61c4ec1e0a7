"""PFLD-GhostOne landmark regressor with MobileOne reparameterization
(counterpart of calipsync_tpu/nn/pfld.py; the reference's
utils/lip_detector/tools/pfld_mobileone.py and base_module.py).

A GhostNet-style backbone whose convs are MobileOne blocks: in the train
form each block is ``num_branches`` conv-BN branches, a 1x1 conv-BN scale
branch and a BN skip, with the keys of the reference's
``checkpoint_epoch_335.pth.tar`` (``rbr_conv.{i}.conv/bn``,
``rbr_scale.conv/bn``, ``rbr_skip``); in the deploy form each block is one
biased conv, ``reparam_conv``. :func:`fold_mobileone` folds a train-form
state_dict into the deploy form (RepVGG-style BN fusion), as the JAX
package's ``fold_mobileone_params`` folds its variables.

Forward: (B, 192, 192, 3) image in [0, 1] -> (B, 220) landmark residuals
(add the mean face, reshape (110, 2); see vision/lip_detector.py).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.nn.product_conv import ProductConv2d

NUM_BRANCHES = 6  # reference pfld_mobileone.py:17


class ConvBN(nn.Module):
    """Bias-less conv, then BN (eps 1e-5)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = ProductConv2d(cin, cout, kernel, stride, kernel // 2,
                                  groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class MobileOneBlock(nn.Module):
    """Multi-branch (train form) or single-conv (deploy form) block."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, depthwise: bool = False,
                 linear: bool = False, branches: int = NUM_BRANCHES,
                 deploy: bool = False):
        super().__init__()
        self.linear = linear
        groups = cin if depthwise else 1
        if deploy:
            self.reparam_conv = ProductConv2d(cin, cout, kernel, stride,
                                              kernel // 2, groups=groups)
            return
        self.rbr_conv = nn.ModuleList(
            ConvBN(cin, cout, kernel, stride, groups)
            for _ in range(branches))
        self.rbr_scale = (ConvBN(cin, cout, 1, stride, groups)
                          if kernel > 1 else None)
        self.rbr_skip = (nn.BatchNorm2d(cin) if cin == cout and stride == 1
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "reparam_conv"):
            y = self.reparam_conv(x)
        else:
            y = sum(b(x) for b in self.rbr_conv)
            if self.rbr_scale is not None:
                y = y + self.rbr_scale(x)
            if self.rbr_skip is not None:
                y = y + self.rbr_skip(x)
        return y if self.linear else F.relu(y)


class GhostOneModule(nn.Module):
    """Primary 1x1, then a cheap depthwise 3x3; the halves concatenated."""

    def __init__(self, cin: int, features: int, linear: bool = False,
                 deploy: bool = False):
        super().__init__()
        half = math.ceil(features / 2)
        self.primary_conv = MobileOneBlock(cin, half, 1, linear=linear,
                                           deploy=deploy)
        self.cheap_operation = MobileOneBlock(half, half, 3, depthwise=True,
                                              linear=linear, deploy=deploy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_conv(x)
        return torch.cat([x1, self.cheap_operation(x1)], dim=1)


class GhostOneBottleneck(nn.Module):
    """ghost_conv: ghost module, a stride-2 depthwise block (an empty slot
    at stride 1), then a linear ghost module."""

    def __init__(self, cin: int, hidden: int, features: int,
                 stride: int = 1, deploy: bool = False):
        super().__init__()
        self.ghost_conv = nn.Sequential(
            GhostOneModule(cin, hidden, deploy=deploy),
            (MobileOneBlock(hidden, hidden, 3, stride=2, depthwise=True,
                            linear=True, deploy=deploy)
             if stride == 2 else nn.Identity()),
            GhostOneModule(hidden, features, linear=True, deploy=deploy))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ghost_conv(x)


def _w(v: float, width: float) -> int:
    return int(v * width)


# (name, hidden, features, stride) of the bottlenecks, at width 1
_BOTTLENECKS = (("conv3_1", 96, 80, 2), ("conv3_2", 120, 80, 1),
                ("conv3_3", 120, 80, 1), ("conv4_1", 200, 96, 2),
                ("conv4_2", 240, 96, 1), ("conv4_3", 240, 96, 1),
                ("conv5_1", 336, 144, 2), ("conv5_2", 504, 144, 1),
                ("conv5_3", 504, 144, 1), ("conv5_4", 504, 144, 1),
                ("conv6", 216, 16, 1))


class PFLDGhostOne(nn.Module):
    """The landmark net; ``deploy=True`` takes folded weights."""

    def __init__(self, width: float = 0.5, input_size: int = 192,
                 landmarks: int = 110, deploy: bool = False):
        super().__init__()
        c64 = _w(64, width)
        self.conv1 = MobileOneBlock(3, c64, 3, stride=2, deploy=deploy)
        self.conv2 = MobileOneBlock(c64, c64, 3, depthwise=True,
                                    deploy=deploy)
        cin = c64
        pooled = [c64]
        for name, hidden, feats, stride in _BOTTLENECKS:
            setattr(self, name, GhostOneBottleneck(
                cin, _w(hidden, width), _w(feats, width), stride, deploy))
            cin = _w(feats, width)
            if name in ("conv3_3", "conv4_3", "conv5_4"):
                pooled.append(cin)
        self.conv7 = MobileOneBlock(cin, _w(32, width), 3, deploy=deploy)
        k8 = input_size // 16
        self.conv8 = nn.Sequential(
            ProductConv2d(_w(32, width), _w(128, width), k8, bias=False),
            nn.ReLU())
        # a 1x1 conv on the pooled vector: the JAX package's Dense
        self.conv_out = ProductConv2d(sum(pooled) + _w(128, width),
                                      landmarks * 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.conv_out.weight.dtype)
        x = self.conv2(self.conv1(x))
        pooled = [x.mean(dim=(2, 3))]
        for name, *_ in _BOTTLENECKS:
            x = getattr(self, name)(x)
            if name in ("conv3_3", "conv4_3", "conv5_4"):
                pooled.append(x.mean(dim=(2, 3)))
        x = self.conv8(self.conv7(x))
        pooled.append(x[:, :, 0, 0])
        multi = torch.cat(pooled, dim=1)[:, :, None, None]
        return self.conv_out(multi)[:, :, 0, 0].float()


class AuxiliaryNet(nn.Module):
    """FPN auxiliary head used when training PFLD (reference
    pfld_mobileone.py:252-286): 1x1 laterals at four backbone stages,
    top-down nearest upsampling with 3x3 merges, a 1-channel map. Conv-BN-
    ReLU blocks without bias, keyed ``{name}.conv`` / ``{name}.bn``.
    Inputs and output NHWC, as the JAX module's."""

    def __init__(self, in_channels: Sequence[int] = (32, 40, 48, 72),
                 width: float = 1.0):
        super().__init__()
        w = int(64 * width)
        for i, c in enumerate(in_channels, 1):
            setattr(self, f"conv{i}", ConvBN(c, w, 1))
        for name in ("merge3", "merge2", "merge1"):
            setattr(self, name, ConvBN(w, w, 3))
        self.conv_out = ConvBN(w, 1, 1)

    def forward(self, out1, out2, out3, out4):
        def cbr(name, x):
            return F.relu(getattr(self, name)(x))

        def up_to(x, ref):  # half-pixel nearest, as jax.image.resize
            return F.interpolate(x, size=ref.shape[2:], mode="nearest-exact")

        o1, o2, o3, o4 = (cbr(f"conv{i}", o.permute(0, 3, 1, 2))
                          for i, o in enumerate((out1, out2, out3, out4), 1))
        o3 = cbr("merge3", o3 + up_to(o4, o3))
        o2 = cbr("merge2", o2 + up_to(o3, o2))
        o1 = cbr("merge1", o1 + up_to(o2, o1))
        return cbr("conv_out", o1).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Reparameterization: a train-form state_dict -> the deploy form
# ---------------------------------------------------------------------------

_BRANCH = re.compile(r"(.*)\.rbr_conv\.0\.conv\.weight$")


def _fuse_conv_bn(kernel: torch.Tensor, sd: Mapping, bn: str, eps=1e-5):
    t = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
    return (kernel * t[:, None, None, None],
            sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * t)


def _fold_block(sd: Mapping, p: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One MobileOne block's train-form keys under ``p`` -> the folded
    (weight (O, I/g, k, k), bias (O,))."""
    k0 = sd[f"{p}.rbr_conv.0.conv.weight"]
    out, in_per_group, kh, _ = k0.shape
    kernel = torch.zeros_like(k0, dtype=torch.float64)
    bias = torch.zeros(out, dtype=torch.float64)
    i = 0
    while f"{p}.rbr_conv.{i}.conv.weight" in sd:
        fk, fb = _fuse_conv_bn(sd[f"{p}.rbr_conv.{i}.conv.weight"], sd,
                               f"{p}.rbr_conv.{i}.bn")
        kernel += fk
        bias += fb
        i += 1
    if f"{p}.rbr_scale.conv.weight" in sd:
        fk, fb = _fuse_conv_bn(sd[f"{p}.rbr_scale.conv.weight"], sd,
                               f"{p}.rbr_scale.bn")
        pad = kh // 2
        kernel += F.pad(fk, (pad, pad, pad, pad))
        bias += fb
    if f"{p}.rbr_skip.weight" in sd:
        ident = torch.zeros_like(kernel)
        c = kh // 2
        for o in range(out):
            ident[o, o % in_per_group, c, c] = 1.0
        fk, fb = _fuse_conv_bn(ident, sd, f"{p}.rbr_skip")
        kernel += fk
        bias += fb
    return kernel, bias


def fold_mobileone(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Train-form state_dict -> deploy-form state_dict: every MobileOne
    block's branches become ``{block}.reparam_conv.weight/bias``; the other
    keys pass through. Exact up to float rounding (the sums run in
    float64 and are rounded to the weights' dtype once)."""
    sd = {k: v.double() if v.is_floating_point() else v
          for k, v in state_dict.items()}
    blocks = [m.group(1) for k in sd if (m := _BRANCH.match(k))]
    out: Dict[str, torch.Tensor] = {}
    for p in blocks:
        w, b = _fold_block(sd, p)
        dtype = state_dict[f"{p}.rbr_conv.0.conv.weight"].dtype
        out[f"{p}.reparam_conv.weight"] = w.to(dtype)
        out[f"{p}.reparam_conv.bias"] = b.to(dtype)
    prefixes = tuple(f"{p}." for p in blocks)
    for k, v in state_dict.items():
        if not k.startswith(prefixes):
            out[k] = v
    return out
