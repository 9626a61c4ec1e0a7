"""Spatial cross-attention, CUDA kernel ``csrc/cross_attention.cu`` for the
forward and plain PyTorch products for the backward.

Counterpart of calipsync_tpu/kernels/cross_attention.py
(``cross_attention`` / ``_attention_fwd_pallas``, with its ``custom_vjp``):
softmax(q k^T) v with no 1/sqrt(d) scaling, the scores, probabilities and
accumulation in fp32, the result in v's dtype.

``cross_attention`` calls the op ``calipsync::cross_attention``
(``torch.library``). Its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and it never falls back from one to
the other. Its registered autograd saves q, k and v and runs
:func:`cross_attention_backward_plain` on either device, as the JAX
package's backward is plain XLA outside its Pallas kernel. A fake
implementation and a FLOP formula serve ``torch.export`` and
``FlopCounterMode``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build, _counts

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


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q @ k^T) @ v over tokens, no scaling (reference-exact),
    differentiable in q, k and v: the op ``calipsync::cross_attention``.

    q, k (B,N,D); v (B,N,C); one dtype, float32 or bfloat16.
    Returns (B,N,C) in v.dtype. ``cross_attention.launches`` counts the
    kernel's launches (forwards on the card); a launch recorded into a
    CUDA graph counts when the graph is replayed (kernels/_counts.py).
    """
    return torch.ops.calipsync.cross_attention.default(q, k, v)


_counts.init(cross_attention)


def _attention_cuda(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The kernel's launch: checks, one launch on the current stream,
    counted."""
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
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                code, b, n, d, c,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "cross_attention")
    _counts.count(cross_attention)
    return out


def _attention_fake(q, k, v):
    return v.new_empty((*q.shape[:2], v.shape[-1]))


def _attention_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _attention_backward(ctx, g):
    return cross_attention_backward_plain(*ctx.saved_tensors, g)


def _attention_flops(q, k, v, *args, out_shape=None, **kwargs) -> int:
    """q k^T and p v, two FLOP a multiply-add (the softmax is elementwise
    work, which FlopCounterMode does not count)."""
    b, n, d = q
    return 2 * b * n * n * (d + v[-1])


_LIB = torch.library.Library("calipsync", "FRAGMENT")
_LIB.define("cross_attention(Tensor q, Tensor k, Tensor v) -> Tensor")
_LIB.impl("cross_attention", cross_attention_plain, "CPU")
_LIB.impl("cross_attention", _attention_cuda, "CUDA")
torch.library.register_fake("calipsync::cross_attention", _attention_fake,
                            lib=_LIB)
torch.library.register_autograd("calipsync::cross_attention",
                                _attention_backward,
                                setup_context=_attention_setup, lib=_LIB)
register_flop_formula(torch.ops.calipsync.cross_attention)(_attention_flops)
