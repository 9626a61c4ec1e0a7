"""The lip-sync generator: audio-conditioned cross-attention UNet
(counterpart of calipsync_tpu/nn/unet.py; the reference implementation's
module/unet.py:109-345), with the reference torch
state_dict keys (582 for hubert with 4 blocks).

Forward contract, the JAX package's layout:
    x:     (B, 160, 160, 6)  NHWC, masked mouth crop + reference crop, [0,1]
    audio: (B, 32, 32, 32)   NHWC HuBERT window ('hubert'), or
           (B, 16, 32, 256)  NHWC WeNet window ('wenet')
    ->     (B, 160, 160, 3)  fp32 sigmoid mouth crop, NHWC

Parameters are fp32; ``dtype`` is the compute dtype (bf16 for serving).
Inside, tensors are NCHW in channels_last memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (BN_EPS, KERNEL_OPS, Down, DoubleConvDW, InConvDw,
                     InvertedResidual, OutConv, Up, batch_norm, conv,
                     conv_bn, leaky_relu, nchw, use_plain_ops)

CH = (32, 64, 128, 256, 512)  # reference channel plan (module/unet.py:277)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class AudioConvHubert(nn.Module):
    """HuBERT-window encoder: (B,32,32,32) -> (B,512,10,10)
    (ref module/unet.py:147-194; conv5 uses padding 3 with stride 2)."""

    def __init__(self):
        super().__init__()
        self.conv1 = InvertedResidual(32, CH[1], 1, False, 2)
        self.conv2 = InvertedResidual(CH[1], CH[2], 1, False, 2)
        self.conv3 = nn.Conv2d(CH[2], CH[3], 3, 2, 1)
        self.bn3 = _bn(CH[3])
        self.conv4 = InvertedResidual(CH[3], CH[3], 1, True, 2)
        self.conv5 = nn.Conv2d(CH[3], CH[4], 3, 2, 3)
        self.bn5 = _bn(CH[4])
        self.conv6 = InvertedResidual(CH[4], CH[4], 1, True, 2)
        self.conv7 = InvertedResidual(CH[4], CH[4], 1, True, 2)
        self.bn7 = _bn(CH[4])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        x = leaky_relu(conv_bn(self.conv3, self.bn3, x))
        x = self.conv4(x)
        x = leaky_relu(conv_bn(self.conv5, self.bn5, x))
        x = self.conv7(self.conv6(x))
        return leaky_relu(batch_norm(self.bn7, x))


class AudioConvWenet(nn.Module):
    """WeNet-feature encoder: (B,256,16,32) -> (B,512,10,10)
    (ref module/unet.py:109-144; its conv3/conv5 activations are plain
    ReLU)."""

    def __init__(self):
        super().__init__()
        self.conv1 = InvertedResidual(CH[3], CH[3], 1, True, 2)
        self.conv2 = InvertedResidual(CH[3], CH[3], 1, True, 2)
        self.conv3 = nn.Conv2d(CH[3], CH[3], 3, (1, 2), 1)
        self.bn3 = _bn(CH[3])
        self.conv4 = InvertedResidual(CH[3], CH[3], 1, True, 2)
        self.conv5 = nn.Conv2d(CH[3], CH[4], 3, 2, 3)
        self.bn5 = _bn(CH[4])
        self.conv6 = InvertedResidual(CH[4], CH[4], 1, True, 2)
        self.conv7 = InvertedResidual(CH[4], CH[4], 1, True, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        x = F.relu(conv_bn(self.conv3, self.bn3, x))
        x = self.conv4(x)
        x = F.relu(conv_bn(self.conv5, self.bn5, x))
        return self.conv7(self.conv6(x))


class CrossAttention(nn.Module):
    """Single-head spatial cross-attention over H*W tokens
    (ref module/unet.py:198-218): q from x, k/v from y, 1x1 projections
    (q/k to C/8, v to C), softmax(q k^T) with no 1/sqrt(d) scaling,
    gamma-gated residual. The attention itself is the kernel
    ``kernels/cross_attention.py``."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.query_conv = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.key_conv = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.value_conv = nn.Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.ops = KERNEL_OPS

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def tokens(t):  # (B,C',H,W) -> (B,H*W,C') contiguous
            return t.permute(0, 2, 3, 1).reshape(b, h * w, -1).contiguous()

        q = tokens(conv(self.query_conv, x))
        k = tokens(conv(self.key_conv, y))
        v = tokens(conv(self.value_conv, y))
        out = self.ops.attention(q, k, v)
        out = nchw(out.reshape(b, h, w, c)).to(x.dtype)
        return self.gamma.to(x.dtype) * out + x


class MLPFusion(nn.Module):
    """Token-wise MLP fusion of visual and audio features
    (ref module/unet.py:224-249): (B,H*W,C) tokens of both maps, concat,
    Linear -> BN1d -> LeakyReLU -> Linear -> BN1d, back to a map. BN1d
    normalizes each channel across batch and tokens."""

    def __init__(self, in_features: int, hidden: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.bn1 = nn.BatchNorm1d(hidden, eps=BN_EPS)
        self.fc2 = nn.Linear(hidden, out_features)
        self.bn2 = nn.BatchNorm1d(out_features, eps=BN_EPS)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dt = x.dtype
        fused = torch.cat([x.permute(0, 2, 3, 1).reshape(b, h * w, c),
                           y.permute(0, 2, 3, 1).reshape(b, h * w, c)], -1)
        fused = F.linear(fused, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        fused = leaky_relu(batch_norm(self.bn1, fused, dim=-1))
        fused = F.linear(fused, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        fused = batch_norm(self.bn2, fused, dim=-1)
        return nchw(fused.reshape(b, h, w, -1).contiguous())


class AttentionBlock(nn.Module):
    """1x1 down-proj -> cross-attention -> 1x1 up-proj -> +tx -> BN ->
    LeakyReLU (ref module/unet.py:252-270)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.attention_adjust_p_1 = nn.Conv2d(out_channels, in_channels, 1)
        self.cross_attention = CrossAttention(in_channels)
        self.attention_adjust_b_1 = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = _bn(out_channels)

    def forward(self, x: torch.Tensor, audio: torch.Tensor,
                tx: torch.Tensor) -> torch.Tensor:
        ox = conv(self.attention_adjust_p_1, x)
        ox = self.cross_attention(ox, audio)
        ox = conv(self.attention_adjust_b_1, ox) + tx
        return leaky_relu(batch_norm(self.bn, ox))


class Generator(nn.Module):
    """The 19.8M-param lip-sync generator (ref module/unet.py:273-345).

    Encoder 160->10 at widths (32,64,128,256,512); audio encoder to
    (10,10,512); concat + MLP fusion to 1024 channels; ``n_blocks``
    cross-attention blocks with dense residual accumulation; fuse convs
    back to 256; skip decoder back to 160; 1x1 + BN + sigmoid (fp32).

    ``ops="plain"`` makes every block call the kernels' plain versions on
    any device: the path the kernels are held against on the card.
    """

    def __init__(self, n_channels: int = 6, mode: str = "hubert",
                 n_blocks: int = 4, dtype: torch.dtype = torch.float32,
                 ops: str = "kernels"):
        super().__init__()
        if mode not in ("hubert", "wenet"):
            raise ValueError(f"unknown audio mode: {mode}")
        if ops not in ("kernels", "plain"):
            raise ValueError(f"unknown ops: {ops}")
        self.mode = mode
        self.dtype = dtype
        self.inc = InConvDw(n_channels, CH[0])
        self.down1 = Down(CH[0], CH[1])
        self.down2 = Down(CH[1], CH[2])
        self.down3 = Down(CH[2], CH[3])
        self.down4 = Down(CH[3], CH[4])
        self.audio_model = (AudioConvHubert() if mode == "hubert"
                            else AudioConvWenet())
        self.mlp_fusion = MLPFusion(CH[4] * 2, CH[4] * 2, CH[4] * 2)
        self.bn_tx = _bn(CH[4] * 2)
        self.attention_blocks = nn.ModuleList(
            [AttentionBlock(CH[4], CH[4] * 2) for _ in range(n_blocks)])
        self.bn_kx = _bn(CH[4] * 2)
        self.fuse_conv = nn.Sequential(DoubleConvDW(CH[4] * 2, CH[4], 1),
                                       DoubleConvDW(CH[4], CH[3], 1))
        self.up1 = Up(CH[4], CH[3] // 2)
        self.up2 = Up(CH[3], CH[2] // 2)
        self.up3 = Up(CH[2], CH[1] // 2)
        self.up4 = Up(CH[1], CH[0])
        self.outc = OutConv(CH[0], 3)
        self.outc_bn = _bn(3)
        if ops == "plain":
            use_plain_ops(self)

    def forward(self, x: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        cl = torch.channels_last
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=cl)
        audio = audio.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=cl)

        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        af = self.audio_model(audio)

        tx = torch.cat([x5, af], dim=1) + self.mlp_fusion(x5, af)
        tx = batch_norm(self.bn_tx, tx)
        ox = kx = tx
        for block in self.attention_blocks:
            ox = block(ox, af, tx)
            kx = ox + kx
        kx = leaky_relu(batch_norm(self.bn_kx, kx))

        x5 = self.fuse_conv(kx.contiguous(memory_format=cl))
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        out = batch_norm(self.outc_bn, self.outc(x))
        return torch.sigmoid(out.float()).permute(0, 2, 3, 1).contiguous()
