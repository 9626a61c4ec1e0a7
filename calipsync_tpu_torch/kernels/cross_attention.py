"""Spatial cross-attention forward, CUDA kernel ``csrc/cross_attention.cu``
and its plain PyTorch version.

Counterpart of calipsync_tpu/kernels/cross_attention.py
(``cross_attention`` / ``_attention_fwd_pallas``): softmax(q k^T) v with no
1/sqrt(d) scaling, the scores, probabilities and accumulation in fp32, the
result in v's dtype. Forward only; serving takes no gradient.

``cross_attention`` runs the kernel on a CUDA tensor and the plain version
on a CPU tensor; it never falls back from one to the other.
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
    (unlike the JAX ``_attention_reference``, which casts p to v.dtype)."""
    energy = q.float() @ k.float().transpose(1, 2)
    p = torch.softmax(energy, dim=-1)
    return (p @ v.float()).to(v.dtype)


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


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q @ k^T) @ v over tokens, no scaling (reference-exact).

    q, k (B,N,D); v (B,N,C); one dtype, float32 or bfloat16.
    Returns (B,N,C) in v.dtype.
    """
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v)
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
