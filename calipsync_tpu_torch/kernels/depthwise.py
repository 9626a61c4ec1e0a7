"""Depthwise 3x3 conv + folded BatchNorm + LeakyReLU (NHWC), CUDA kernel
``csrc/depthwise.cu`` and its plain PyTorch version.

Counterpart of calipsync_tpu/kernels/depthwise.py: ``depthwise3x3`` and
``depthwise3x3_blocked`` there are two TPU tilings of one op, and one
Hopper kernel serves both. ``fold_bn`` turns BatchNorm parameters into the
(scale, bias) the op consumes.

``depthwise3x3`` runs the kernel on a CUDA tensor and the plain version on
a CPU tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LEAKY_SLOPE = 0.01


def _out_size(n: int, stride: int) -> int:
    return (n + 2 - 3) // stride + 1


def _taps9(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,C), (3,3,1,C) or (9,C) taps -> (9,C)."""
    c = kernel.shape[-1]
    if kernel.dim() == 4:
        kernel = kernel[:, :, 0, :]
    return kernel.reshape(9, c)


def depthwise3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None,
                       stride: int = 1) -> torch.Tensor:
    """The op in plain PyTorch: nine shifted fp32 multiply-adds over the
    zero-padded input, then scale, bias and LeakyReLU, cast to x.dtype."""
    b, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    taps = _taps9(kernel).float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                     dx:dx + (wo - 1) * stride + 1:stride, :]
            acc = acc + tap * taps[dy * 3 + dx]
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    acc = torch.where(acc >= 0, acc, acc * LEAKY_SLOPE)
    return acc.to(x.dtype)


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = _build.function("calipsync_depthwise3x3",
                              [p, p, p, p, p, i, i, i, i, i, i, i, i,
                               ctypes.c_float, p])
    return _FN


def depthwise3x3(x: torch.Tensor, kernel: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 stride: int = 1) -> torch.Tensor:
    """y = leaky_relu(dwconv3x3(x, kernel) * scale + bias), pad 1.

    x (B,H,W,C) NHWC float32 or bfloat16; kernel (3,3,C), (3,3,1,C) or
    (9,C); scale/bias (C,) (folded BN, default identity); stride 1 or 2.
    Returns (B, (H-1)//stride+1, (W-1)//stride+1, C) in x.dtype.
    """
    if x.device.type == "cpu":
        return depthwise3x3_plain(x, kernel, scale, bias, stride)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3: no kernel for device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("depthwise3x3: x must be a contiguous (B,H,W,C) "
                         "tensor")
    if stride not in (1, 2):
        raise ValueError(f"depthwise3x3: stride must be 1 or 2, not {stride}")
    b, h, w, c = x.shape
    code = _build.dtype_code(x.dtype)
    dev = x.device
    taps = _taps9(kernel).to(dev, torch.float32).contiguous()
    if taps.shape != (9, c):
        raise ValueError(f"depthwise3x3: kernel holds {tuple(kernel.shape)} "
                         f"taps for {c} channels")
    scale = (torch.ones(c, device=dev) if scale is None
             else scale.to(dev, torch.float32).contiguous())
    bias = (torch.zeros(c, device=dev) if bias is None
            else bias.to(dev, torch.float32).contiguous())
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("depthwise3x3: scale and bias must be (C,)")
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=dev)
    status = _kernel_fn()(
        x.data_ptr(), taps.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), code, b, h, w, c, ho, wo, stride, LEAKY_SLOPE,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "depthwise3x3")
    depthwise3x3.launches += 1
    return out


depthwise3x3.launches = 0


def fold_bn(bn_weight: torch.Tensor, bn_bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm -> per-channel (scale, bias) in fp32:
    s = weight / sqrt(var + eps), b = bias - mean * s."""
    s = bn_weight.float() / torch.sqrt(running_var.float() + eps)
    return s, bn_bias.float() - running_mean.float() * s
