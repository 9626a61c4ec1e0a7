"""Fused stride-1 inverted-residual block (eval mode, BN folded), CUDA
kernel ``csrc/fused_ir.cu`` and its plain PyTorch version.

Counterpart of calipsync_tpu/kernels/fused_ir.py
(``fused_inverted_residual``, ``fused_inverted_residual_reference``,
``fold_ir_params``). The block computes

    hid = leaky(x w1 + b1)            cast to x.dtype
    y   = leaky(dw3x3(hid, kd) + bd)  cast   (hid zero-padded at the edges)
    out = leaky(y w2 + b2)            cast   [+ x]

with fp32 accumulation and w1, kd, w2 cast to x.dtype first.

On the card both dtypes run tensor-core kernels. In fp32 (what ``infer``
and ``serve`` run by default) each 1x1 product is three TF32 passes,
a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with a = a_hi + a_lo split by
``cvt.rna``, which keeps fp32 accuracy; ``fused_inverted_residual_tf32x3``
is that arithmetic in plain PyTorch, for the CPU tests.

``fused_inverted_residual`` calls the op ``calipsync::fused_ir``
(``torch.library``), whose CUDA implementation launches the kernel and
whose CPU implementation is the plain version: an explicit dispatch on
the input's device, never a fallback from one to the other. The op's fake
implementation gives ``torch.export`` the output's shape and dtype, and
its FLOP formula lets ``FlopCounterMode`` count it. It has no gradient
(eval mode only): its registered backward raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build, _counts

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
# One block's shared memory on the H100 (bytes).
MAX_SMEM = 232448


def _leaky(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, t, LEAKY_SLOPE * t)


def as_fp32(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, with no cast where it is fp32 already (so a traced fold
    records none: ``torch.export`` keeps a node for every cast)."""
    return t if t.dtype == torch.float32 else t.float()


def fused_inverted_residual_plain(x, w1, b1, kd, bd, w2, b2, *,
                                  residual: bool = False) -> torch.Tensor:
    """The block in plain PyTorch, with the kernel's fold and cast points
    (mirror of the JAX ``fused_inverted_residual_reference``)."""
    return _block(x, w1, b1, kd, bd, w2, b2, residual, torch.matmul)


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 (10 stored mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero, on the
    bits (half a TF32 ulp added to the magnitude, the 13 low bits
    cleared)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """a @ b (fp32) as the TF32 tensor cores compute it: each operand split
    into a TF32 high part and a TF32 remainder, and three products of TF32
    values summed in fp32 (lo.hi + hi.lo + hi.hi, the fp32 kernel's
    order); ``passes=1`` is the single TF32 product hi.hi. Products of
    TF32 values are exact in fp32, so only the order of the sums differs
    from the card."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def fused_inverted_residual_tf32x3(x, w1, b1, kd, bd, w2, b2, *,
                                   residual: bool = False,
                                   passes: int = 3) -> torch.Tensor:
    """The fp32 CUDA kernel's arithmetic in plain PyTorch: the plain
    version with both 1x1 products through ``matmul_tf32`` (``passes=1``:
    one TF32 product each, the accuracy the split buys back). fp32 only."""
    if x.dtype != torch.float32:
        raise ValueError(f"the TF32 mirror takes fp32, not {x.dtype}")
    return _block(x, w1, b1, kd, bd, w2, b2, residual,
                  lambda a, b: matmul_tf32(a, b, passes))


def _block(x, w1, b1, kd, bd, w2, b2, residual, mm) -> torch.Tensor:
    """The block with its 1x1 products computed by ``mm`` (fp32 in and
    out)."""
    dtype = x.dtype
    ch = w1.shape[1]
    hid = mm(x.float(), w1.to(dtype).float())
    hid = _leaky(hid + b1.float()).to(dtype)
    b, h, w, _ = hid.shape
    hidp = torch.nn.functional.pad(hid.float(), (0, 0, 1, 1, 1, 1))
    kd9 = kd.reshape(9, ch).to(dtype).float()
    acc = torch.zeros((b, h, w, ch), dtype=torch.float32, device=x.device)
    for dr in range(3):
        for dc in range(3):
            acc = acc + hidp[:, dr:dr + h, dc:dc + w, :] * kd9[dr * 3 + dc]
    y = _leaky(acc + bd.float()).to(dtype)
    out = mm(y.float(), w2.to(dtype).float())
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
        _SMEM = _build.function("calipsync_fused_ir_smem", [i] * 7,
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
    """Stride-1 inverted residual with BN folded (eval mode), the op
    ``calipsync::fused_ir``.

    x (B,H,W,Cin) NHWC float32 or bfloat16; w1 (Cin,Ch); b1 (Ch,);
    kd (9,Ch) or (3,3,Ch) [3x3 taps row-major]; bd (Ch,); w2 (Ch,Cout);
    b2 (Cout,). Returns (B,H,W,Cout) in x.dtype. ``residual`` adds x
    (Cin == Cout). On the card both dtypes run tensor-core kernels (Cout
    at most 128; fp32 products as three TF32 passes, at fp32 accuracy).
    Not differentiable: a backward through it raises.
    """
    if residual and w1.shape[0] != w2.shape[1]:
        raise ValueError("residual needs cin == cout")
    return torch.ops.calipsync.fused_ir.default(x, w1, b1, kd, bd, w2, b2,
                                                residual)


_counts.init(fused_inverted_residual)


def _fused_ir_cpu(x, w1, b1, kd, bd, w2, b2, residual):
    return fused_inverted_residual_plain(x, w1, b1, kd, bd, w2, b2,
                                         residual=residual)


def _fused_ir_cuda(x, w1, b1, kd, bd, w2, b2, residual):
    """The kernel's launch: checks, then one launch on the current
    stream, counted."""
    cin, ch = w1.shape
    cout = w2.shape[1]
    if x.device.type != "cuda":
        raise ValueError(f"fused_inverted_residual: x on {x.device}, the "
                         f"weights on the card")
    if x.dim() != 4 or not x.is_contiguous() or x.shape[-1] != cin:
        raise ValueError(f"fused_inverted_residual: x must be a contiguous "
                         f"(B,H,W,{cin}) tensor, got {tuple(x.shape)}")
    if w2.shape[0] != ch or kd.numel() != 9 * ch:
        raise ValueError("fused_inverted_residual: w1/kd/w2 widths differ")
    b, h, w, _ = x.shape
    dtype, dev = x.dtype, x.device
    code = _build.dtype_code(dtype)
    fn, smem = _kernel_fns()
    need = smem(b, h, w, cin, ch, cout, code)
    if need == -1:
        raise ValueError(f"fused_inverted_residual: the kernel takes "
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
    _counts.count(fused_inverted_residual)
    return out


def _fused_ir_fake(x, w1, b1, kd, bd, w2, b2, residual):
    return x.new_empty((*x.shape[:3], w2.shape[1]))


def _fused_ir_backward(ctx, grad):
    raise RuntimeError("calipsync::fused_ir has no gradient: it runs "
                       "eval-mode blocks with BatchNorm folded (train mode "
                       "runs the plain modules)")


def _fused_ir_flops(x, w1, b1, kd, bd, w2, b2, residual, *args,
                    out_shape=None, **kwargs) -> int:
    """Multiply-adds of the expand, the depthwise taps and the project,
    two FLOP each (shapes, as FlopCounterMode passes them)."""
    b, h, w, _ = x
    cin, ch = w1
    return 2 * b * h * w * (cin * ch + 9 * ch + ch * w2[1])


_LIB = torch.library.Library("calipsync", "FRAGMENT")
_LIB.define("fused_ir(Tensor x, Tensor w1, Tensor b1, Tensor kd, Tensor bd, "
            "Tensor w2, Tensor b2, bool residual) -> Tensor")
_LIB.impl("fused_ir", _fused_ir_cpu, "CPU")
_LIB.impl("fused_ir", _fused_ir_cuda, "CUDA")
torch.library.register_fake("calipsync::fused_ir", _fused_ir_fake, lib=_LIB)
torch.library.register_autograd("calipsync::fused_ir", _fused_ir_backward,
                                lib=_LIB)
register_flop_formula(torch.ops.calipsync.fused_ir)(_fused_ir_flops)


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
        wt, gamma, beta, mean, var = (as_fp32(t) for t in stage)
        s = gamma / torch.sqrt(var + BN_EPS)
        return wt * s[:, None, None, None], beta - mean * s

    k1, b1 = fold(expand)
    kd, bd = fold(depthwise)
    k2, b2 = fold(project)
    ch = k1.shape[0]
    return (k1[:, :, 0, 0].t(), b1, kd.reshape(ch, 9).t().contiguous(), bd,
            k2[:, :, 0, 0].t(), b2)
