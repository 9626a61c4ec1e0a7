"""Spatial cross-attention, CUDA kernel ``csrc/cross_attention.cu`` for the
forward and plain PyTorch products for the backward.

Counterpart of calipsync_tpu/kernels/cross_attention.py
(``cross_attention`` / ``_attention_fwd_pallas``, with its ``custom_vjp``):
softmax(q k^T) v with no 1/sqrt(d) scaling, the scores, probabilities and
accumulation in fp32, the result in v's dtype.

``cross_attention`` is differentiable (:class:`CrossAttentionFunction`).
Its forward runs the kernel on a CUDA tensor and the plain version on a
CPU tensor, and never falls back from one to the other; its backward is
:func:`cross_attention_backward_plain` on either device, as the JAX
package's backward is plain XLA outside its Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Shared memory one block may use on the H100 (bytes).
MAX_SMEM = 232448


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The op in plain PyTorch, mirroring the Pallas body: p stays fp32
    (unlike the JAX ``_attention_reference``, which casts p to v.dtype);
    fp64 inputs compute in fp64."""
    acc = torch.promote_types(q.dtype, torch.float32)
    energy = q.to(acc) @ k.to(acc).transpose(1, 2)
    p = torch.softmax(energy, dim=-1)
    return (p @ v.to(acc)).to(v.dtype)


_FN = None
_SMEM = None


def _kernel_fns():
    global _FN, _SMEM
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _SMEM = _build.function("calipsync_cross_attention_smem", [i, i, i],
                                restype=ctypes.c_longlong)
        _FN = _build.function("calipsync_cross_attention",
                              [p, p, p, p, i, i, i, i, i, p])
    return _FN, _SMEM


def cross_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv) of softmax(q k^T) v against the output gradient ``g``:
    the JAX ``_bwd`` (calipsync_tpu/kernels/cross_attention.py:107-120).
    p is recomputed from q and k; every product runs in fp32 (fp64 for fp64
    inputs) and each gradient is cast to its input's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    p = torch.softmax(qf @ kf.transpose(1, 2), dim=-1)
    dv = p.transpose(1, 2) @ gf
    dp = gf @ vf.transpose(1, 2)
    de = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = de @ kf
    dk = de.transpose(1, 2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class CrossAttentionFunction(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward, with
    :func:`cross_attention_backward_plain` as its backward; q, k and v are
    saved for it."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return cross_attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return cross_attention_backward_plain(*ctx.saved_tensors, g)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q @ k^T) @ v over tokens, no scaling (reference-exact),
    differentiable in q, k and v.

    q, k (B,N,D); v (B,N,C); one dtype, float32 or bfloat16.
    Returns (B,N,C) in v.dtype. ``cross_attention.launches`` counts the
    kernel's launches (forwards on the card).
    """
    return CrossAttentionFunction.apply(q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention: no kernel for device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 \
            or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"cross_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("cross_attention: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("cross_attention: q, k and v must share a device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cross_attention: q, k and v must be contiguous")
    b, n, d = q.shape
    c = v.shape[-1]
    code = _build.dtype_code(q.dtype)
    fn, smem_fn = _kernel_fns()
    smem = smem_fn(n, d, code)
    if smem > MAX_SMEM:
        raise ValueError(f"cross_attention: N={n}, D={d} need {smem} bytes "
                         f"of shared memory, more than the card's {MAX_SMEM}")
    out = torch.empty((b, n, c), dtype=v.dtype, device=v.device)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), code, b, n, d, c,
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "cross_attention")
    cross_attention.launches += 1
    return out


cross_attention.launches = 0
