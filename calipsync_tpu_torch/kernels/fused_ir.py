"""Fused stride-1 inverted-residual block (eval mode, BN folded), CUDA
kernel ``csrc/fused_ir.cu`` and its plain PyTorch version.

Counterpart of calipsync_tpu/kernels/fused_ir.py
(``fused_inverted_residual``, ``fused_inverted_residual_reference``,
``fold_ir_params``). The block computes

    hid = leaky(x w1 + b1)            cast to x.dtype
    y   = leaky(dw3x3(hid, kd) + bd)  cast   (hid zero-padded at the edges)
    out = leaky(y w2 + b2)            cast   [+ x]

with fp32 accumulation and w1, kd, w2 cast to x.dtype first.

``fused_inverted_residual`` runs the kernel on a CUDA tensor and the plain
version on a CPU tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
# One block's shared memory on the H100 (bytes).
MAX_SMEM = 232448


def _leaky(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, t, LEAKY_SLOPE * t)


def fused_inverted_residual_plain(x, w1, b1, kd, bd, w2, b2, *,
                                  residual: bool = False) -> torch.Tensor:
    """The block in plain PyTorch, with the kernel's fold and cast points
    (mirror of the JAX ``fused_inverted_residual_reference``)."""
    dtype = x.dtype
    ch = w1.shape[1]
    hid = x.float() @ w1.to(dtype).float()
    hid = _leaky(hid + b1.float()).to(dtype)
    b, h, w, _ = hid.shape
    hidp = torch.nn.functional.pad(hid.float(), (0, 0, 1, 1, 1, 1))
    kd9 = kd.reshape(9, ch).to(dtype).float()
    acc = torch.zeros((b, h, w, ch), dtype=torch.float32, device=x.device)
    for dr in range(3):
        for dc in range(3):
            acc = acc + hidp[:, dr:dr + h, dc:dc + w, :] * kd9[dr * 3 + dc]
    y = _leaky(acc + bd.float()).to(dtype)
    out = y.float() @ w2.to(dtype).float()
    out = _leaky(out + b2.float()).to(dtype)
    if residual:
        out = out + x
    return out


_FN = None
_SMEM = None


def _kernel_fns():
    global _FN, _SMEM
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _SMEM = _build.function("calipsync_fused_ir_smem", [i] * 6,
                                restype=ctypes.c_longlong)
        _FN = _build.function("calipsync_fused_ir",
                              [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                               i, ctypes.c_float, p])
    return _FN, _SMEM


def fused_inverted_residual(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, kd: torch.Tensor,
                            bd: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, *,
                            residual: bool = False) -> torch.Tensor:
    """Stride-1 inverted residual with BN folded (eval mode).

    x (B,H,W,Cin) NHWC float32 or bfloat16; w1 (Cin,Ch); b1 (Ch,);
    kd (9,Ch) or (3,3,Ch) [3x3 taps row-major]; bd (Ch,); w2 (Ch,Cout);
    b2 (Cout,). Returns (B,H,W,Cout) in x.dtype. ``residual`` adds x
    (Cin == Cout). On the card, bf16 runs the tensor-core kernel (Cout at
    most 128) and fp32 the CUDA-core kernel.
    """
    cin, ch = w1.shape
    cout = w2.shape[1]
    if residual and cin != cout:
        raise ValueError("residual needs cin == cout")
    if x.device.type == "cpu":
        return fused_inverted_residual_plain(x, w1, b1, kd, bd, w2, b2,
                                             residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_inverted_residual: no kernel for device "
                         f"{x.device}")
    if x.dim() != 4 or not x.is_contiguous() or x.shape[-1] != cin:
        raise ValueError(f"fused_inverted_residual: x must be a contiguous "
                         f"(B,H,W,{cin}) tensor, got {tuple(x.shape)}")
    if w2.shape[0] != ch or kd.numel() != 9 * ch:
        raise ValueError("fused_inverted_residual: w1/kd/w2 widths differ")
    b, h, w, _ = x.shape
    dtype, dev = x.dtype, x.device
    code = _build.dtype_code(dtype)
    fn, smem = _kernel_fns()
    need = smem(h, w, cin, ch, cout, code)
    if need == -1:
        raise ValueError(f"fused_inverted_residual: the {dtype} kernel takes "
                         f"Cout <= 128, not {cout}")
    if need < 0 or need > MAX_SMEM:
        raise ValueError(f"fused_inverted_residual: no tiling of Cin={cin}, "
                         f"Cout={cout} fits in the card's {MAX_SMEM} bytes "
                         f"of shared memory per block")

    weights = kernel_weights(x, w1, b1, kd, bd, w2, b2)
    out = torch.empty((b, h, w, cout), dtype=dtype, device=dev)
    status = fn(x.data_ptr(), *(t.data_ptr() for t in weights),
                out.data_ptr(), code, b, h, w, cin, ch, cout, int(residual),
                LEAKY_SLOPE, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "fused_inverted_residual")
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0


def kernel_weights(x, w1, b1, kd, bd, w2, b2) -> tuple:
    """The weights in the layout and order the kernel reads: w1t (Ch,Cin),
    b1, kd (9,Ch), bd, w2t (Cout,Ch), b2; the matrices in x.dtype, the
    biases fp32, all contiguous on x's device (a no-copy view for weights
    from fold_ir_params, which are stored transposed)."""
    ch, cout = w1.shape[1], w2.shape[1]

    def cast(t, dt):
        return t.to(x.device, dt).contiguous()

    return (cast(w1.t(), x.dtype), cast(b1.reshape(ch), torch.float32),
            cast(kd.reshape(9, ch), x.dtype),
            cast(bd.reshape(ch), torch.float32), cast(w2.t(), x.dtype),
            cast(b2.reshape(cout), torch.float32))


def fold_ir_params(expand: tuple, depthwise: tuple, project: tuple):
    """Fold an InvertedResidual's three conv+BN stages (eval mode).

    Each argument is ``(conv_weight, bn_weight, bn_bias, running_mean,
    running_var)`` with torch conv weights: expand (Ch,Cin,1,1), depthwise
    (Ch,1,3,3), project (Cout,Ch,1,1). Returns (w1 (Cin,Ch), b1, kd (9,Ch),
    bd, w2 (Ch,Cout), b2) in fp32; w1 and w2 are transposed views of
    (Ch,Cin) and (Cout,Ch) storage, the layout the CUDA kernel reads.

    BN(conv(x, W)) == conv(x, W * s) + (beta - mean * s) with
    s = gamma / sqrt(var + eps), exact in eval mode.
    """

    def fold(stage):
        wt, gamma, beta, mean, var = (t.float() for t in stage)
        s = gamma / torch.sqrt(var + BN_EPS)
        return wt * s[:, None, None, None], beta - mean * s

    k1, b1 = fold(expand)
    kd, bd = fold(depthwise)
    k2, b2 = fold(project)
    ch = k1.shape[0]
    return (k1[:, :, 0, 0].t(), b1, kd.reshape(ch, 9).t().contiguous(), bd,
            k2[:, :, 0, 0].t(), b2)
