"""Conv building blocks of the generator (counterpart of
calipsync_tpu/nn/blocks.py), as ``nn.Module``s with the reference torch
state_dict keys (the reference implementation's module/unet.py:8-107).

Tensors inside the model are NCHW in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` hands a kernel NHWC-contiguous memory without a
copy. Parameters stay fp32; the compute dtype is the input's.

In eval mode each block folds its BatchNorms into the conv weights once per
dtype (cleared on ``train()``/``eval()``, ``to()`` and state_dict loads;
under ``torch.export`` the fold is traced, not cached) and runs its
kernels, the ``calipsync::`` ops of ``kernels/``:

  - stride-1 inverted residuals at H*W >= 40*40 run whole in the fused
    kernel (``kernels/fused_ir.py``), the gate of the JAX model
    (nn/blocks.py:125-137);
  - every other inverted residual runs its depthwise conv -> BN ->
    LeakyReLU stage in ``kernels/depthwise.py``, its 1x1 convs as
    ``F.conv2d``.

In train mode the blocks run the plain reference modules (no kernel),
with their fp32 parameters cast to the compute dtype, as the JAX model
does; BatchNorm then normalizes with the batch statistics and updates its
running statistics as flax does (:class:`BatchNorm2d`).

Numerics (reference, fp32 eval): LeakyReLU slope 0.01, BatchNorm eps 1e-5,
bilinear 2x upsample with align_corners=True.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.kernels import (cross_attention, depthwise3x3,
                                         fused_inverted_residual)
from calipsync_tpu_torch.kernels.cross_attention import cross_attention_plain
from calipsync_tpu_torch.kernels.depthwise import (depthwise3x3_plain,
                                                   fold_bn)
from calipsync_tpu_torch.kernels.fused_ir import (
    as_fp32, fold_ir_params, fused_inverted_residual_plain)

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
# Spatial area from which a stride-1 inverted residual runs fused (the
# JAX model's PALLAS_IR_MIN_HW, so both route the same blocks).
FUSED_IR_MIN_HW = 40 * 40

# The ops a model calls: the kernel wrappers (which take the plain versions
# on CPU tensors) or, to compare against them on the card, the plain
# versions everywhere.
KERNEL_OPS = SimpleNamespace(fused_ir=fused_inverted_residual,
                             depthwise=depthwise3x3,
                             attention=cross_attention)
PLAIN_OPS = SimpleNamespace(fused_ir=fused_inverted_residual_plain,
                            depthwise=depthwise3x3_plain,
                            attention=cross_attention_plain)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> contiguous NHWC; no copy when x is
    channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


class _FlaxRunningStats:
    """Train mode as flax's ``BatchNorm`` (calipsync_tpu/nn/blocks.py:30-46):
    normalize with the batch mean and biased variance, then move the running
    statistics 0.1 of the way to the batch's, the variance the biased one.
    torch's own module moves it to the unbiased one, n/(n-1) times larger,
    which shows at the 10x10 maps and in ``MLPFusion``'s BN1d at small
    batch. The batch statistics come from the normalization itself
    (``native_batch_norm``'s fp32 mean and 1/sqrt(var + eps)), so nothing
    reads the activations twice, and the running buffers are not inputs
    of the autograd graph, so updating them between the forward and the
    backward is safe."""

    # (mesh, axes) of the replicas whose batches share their statistics
    # (``sync_batchnorm``), or None
    sync = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync is not None and self.sync[0].axis_size(self.sync[1]) > 1:
            return self._synced(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._move_running(mean, invstd.pow(-2) - self.eps)
        return y

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var), self.momentum)
            self.num_batches_tracked.add_(1)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """flax's ``BatchNorm(axis_name=...)``: the batch mean and mean of
        squares of every replica's batch (in fp32 at least), averaged over
        the axes with their gradient, give the mean and the biased
        variance."""
        from calipsync_tpu_torch.core.mesh import all_mean_with_grad

        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([x32.mean(dims), (x32 * x32).mean(dims)])
        stats = all_mean_with_grad(stats, *self.sync)
        mean, mean2 = stats[:c], stats[c:]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = [1, c] + [1] * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(x32.dtype)
        y = ((x32 - mean.view(shape)) * scale.view(shape)
             + self.bias.to(x32.dtype).view(shape))
        self._move_running(mean.detach(), var.detach())
        return y.to(x.dtype)


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


def sync_batchnorm(model: nn.Module, mesh=None, axes=None) -> nn.Module:
    """Make every BatchNorm of ``model`` take its train-mode statistics
    over the batches of the ranks along ``axes`` of ``mesh`` (None: its
    own batch only); returns ``model``."""
    for m in model.modules():
        if isinstance(m, _FlaxRunningStats):
            m.sync = None if mesh is None else (mesh, axes)
    return model


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               dim: int = 1) -> torch.Tensor:
    """BatchNorm over channel axis ``dim``: eval mode applies the folded
    per-channel affine in x.dtype; train mode runs the module."""
    if bn.training:
        return bn(x.movedim(dim, 1)).movedim(1, dim)
    s, t = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                   bn.eps)
    shape = [1] * x.dim()
    shape[dim] = -1
    return x * s.to(x.dtype).view(shape) + t.to(x.dtype).view(shape)


def conv_bn(cv: nn.Conv2d, bn: nn.BatchNorm2d,
            x: torch.Tensor) -> torch.Tensor:
    """conv -> BatchNorm; eval mode folds the BN (and the conv's own bias)
    into one conv in x.dtype."""
    if bn.training:
        return bn(conv(cv, x))
    s, t = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                   bn.eps)
    if cv.bias is not None:
        t = t + cv.bias.float() * s
    w = cv.weight.float() * s[:, None, None, None]
    return F.conv2d(x, w.to(x.dtype), t.to(x.dtype), cv.stride,
                    cv.padding, cv.dilation, cv.groups)


def conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv with its fp32 parameters cast to x.dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def use_plain_ops(model: nn.Module) -> nn.Module:
    """Make every block of ``model`` call the kernels' plain versions, on
    any device (the reference path the kernels are held against)."""
    for m in model.modules():
        if hasattr(m, "ops"):
            m.ops = PLAIN_OPS
    return model


class InvertedResidual(nn.Module):
    """MobileNetV2-style inverted residual, reference variant
    (module/unet.py:8-40): expand 1x1 -> depthwise 3x3 (stride 1 or 2,
    pad 1) -> project 1x1, BN + LeakyReLU after every stage."""

    def __init__(self, inp: int, oup: int, stride: int = 1,
                 use_res_connect: bool = False, expand_ratio: int = 6):
        super().__init__()
        hidden = inp * expand_ratio
        self.stride = stride
        self.use_res_connect = use_res_connect
        self.conv = nn.Sequential(
            nn.Conv2d(inp, hidden, 1, bias=False),
            BatchNorm2d(hidden, eps=BN_EPS),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden,
                      bias=False),
            BatchNorm2d(hidden, eps=BN_EPS),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(hidden, oup, 1, bias=False),
            BatchNorm2d(oup, eps=BN_EPS),
            nn.LeakyReLU(LEAKY_SLOPE),
        )
        self.ops = KERNEL_OPS
        self._folds: dict = {}

    # -- eval-mode BN fold, cached per compute dtype ------------------------

    def train(self, mode: bool = True):
        self._folds = {}
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._folds = {}
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folds = {}
        return super()._load_from_state_dict(*args, **kwargs)

    def _fold(self, dtype: torch.dtype) -> SimpleNamespace:
        c = self.conv
        stages = [(c[i].weight, c[i + 1].weight, c[i + 1].bias,
                   c[i + 1].running_mean, c[i + 1].running_var)
                  for i in (0, 3, 6)]
        w1, b1, kd, bd, w2, b2 = fold_ir_params(*stages)
        dw_scale, dw_shift = fold_bn(*stages[1][1:], eps=BN_EPS)
        ch = w1.shape[1]

        def cast(t):  # no cast where there is none to make
            return t if t.dtype == dtype else t.to(dtype)

        return SimpleNamespace(
            fused=(cast(w1), b1, cast(kd), bd, cast(w2), b2),
            w1=cast(w1.t()[:, :, None, None]), b1=cast(b1),
            taps=as_fp32(c[3].weight).reshape(ch, 9).t().contiguous(),
            dw_scale=dw_scale, dw_shift=dw_shift,
            w2=cast(w2.t()[:, :, None, None]), b2=cast(b2))

    def folded(self, dtype: torch.dtype) -> SimpleNamespace:
        if torch.compiler.is_exporting():
            # traced from the parameters: an exported program folds the
            # weights it holds, never folds an eager forward cached
            return self._fold(dtype)
        f = self._folds.get(dtype)
        if f is None:
            with torch.no_grad():
                f = self._folds[dtype] = self._fold(dtype)
        return f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y = x
            for i in (0, 3, 6):
                y = leaky_relu(conv_bn(self.conv[i], self.conv[i + 1], y))
            return x + y if self.use_res_connect else y
        f = self.folded(x.dtype)
        if self.stride == 1 and x.shape[2] * x.shape[3] >= FUSED_IR_MIN_HW:
            return nchw(self.ops.fused_ir(nhwc(x), *f.fused,
                                          residual=self.use_res_connect))
        y = leaky_relu(F.conv2d(x, f.w1, f.b1))
        y = nchw(self.ops.depthwise(nhwc(y), f.taps, f.dw_scale, f.dw_shift,
                                    stride=self.stride))
        y = leaky_relu(F.conv2d(y, f.w2, f.b2))
        return x + y if self.use_res_connect else y


class DoubleConvDW(nn.Module):
    """Two stacked inverted residuals (ref module/unet.py:43-55)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.double_conv = nn.Sequential(
            InvertedResidual(in_channels, out_channels, stride=stride,
                             use_res_connect=False, expand_ratio=2),
            InvertedResidual(out_channels, out_channels, stride=1,
                             use_res_connect=True, expand_ratio=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class InConvDw(nn.Module):
    """Input stem (ref module/unet.py:58-67)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.inconv = nn.Sequential(
            InvertedResidual(in_channels, out_channels, stride=1,
                             use_res_connect=False, expand_ratio=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inconv(x)


class Down(nn.Module):
    """Stride-2 double conv (ref module/unet.py:70-79)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            DoubleConvDW(in_channels, out_channels, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, align_corners=True (torch nn.Upsample at
    the reference's module/unet.py:86-87)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class Up(nn.Module):
    """Upsample skip-connection merge (ref module/unet.py:82-97):
    upsample x1 2x, pad to x2's size (a no-op for this model's sizes),
    concat [x1, x2] on channels, DoubleConvDW at stride 1."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConvDW(in_channels, out_channels, stride=1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = upsample2x_bilinear_align_corners(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        x = torch.cat([x1, x2], dim=1)
        return self.conv(x.contiguous(memory_format=torch.channels_last))


class OutConv(nn.Module):
    """1x1 output projection with bias (ref module/unet.py:100-106)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, x)
