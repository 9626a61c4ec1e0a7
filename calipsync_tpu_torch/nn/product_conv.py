"""2-D convolutions computed as products over unfolded windows, for the
face models (S3FD, PFLD, YOLOv8n-face).

PyTorch's default flags let cuDNN compute fp32 convolutions in TF32
(``torch.backends.cudnn.allow_tf32``), a 10-bit mantissa: on the card it
moved S3FD's boxes by over a pixel on every frame of a batch and PFLD's
integer landmarks by a pixel on a tenth of the values (chip_smoke.py's
phase 8a). Products follow the float32 matmul precision, full fp32 by
default, so these models compute in fp32 under the default flags as on
the CPU, and the port sets no global flag (as nn/hubert.py's conv1d does
for HuBERT).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride=1, padding=0, dilation=1,
           groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` (NCHW) as a product over ``F.unfold``'s windows; a
    depthwise conv (one channel a group) as a multiply and a sum."""
    n, c, h, w = x.shape
    out_ch, cin_g, kh, kw = weight.shape
    stride, padding, dilation = (nn.modules.utils._pair(v)
                                 for v in (stride, padding, dilation))
    oh = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    if (kh, kw, stride, padding) == (1, 1, (1, 1), (0, 0)):
        cols = x.reshape(n, c, h * w)
    else:
        cols = F.unfold(x, (kh, kw), dilation, padding, stride)
    k = cin_g * kh * kw
    cols = cols.reshape(n, groups, k, oh * ow)
    if cin_g == 1 and out_ch == groups:
        y = (cols * weight.reshape(1, groups, k, 1)).sum(dim=2)
    else:
        y = torch.matmul(weight.reshape(groups, out_ch // groups, k), cols)
    y = y.reshape(n, out_ch, oh, ow)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


class ProductConv2d(nn.Conv2d):
    """``nn.Conv2d`` (its parameters and state-dict keys) computed by
    :func:`conv2d` on the card; on the CPU, where no flag lowers fp32
    convolutions, by ``F.conv2d``. Zero padding only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)
