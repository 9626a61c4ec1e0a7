"""One yardstick for the kernels on the card, shared by ``chip_smoke.py``
and ``kernels/bench.py``: the CUDA-event timer, the tolerances of a kernel
against its plain version, the bound of each launch, the PyTorch library
call that computes the same function (timed for comparison, never called by
the port), and the launches of one generator forward, recorded with their
inputs.
"""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from . import WRAPPERS, launch_counts, reset_launches
from .cross_attention import cross_attention_plain
from .depthwise import depthwise3x3_plain
from .fused_ir import LEAKY_SLOPE, fused_inverted_residual_plain

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# Kernel vs plain version, (atol, atol per rms, rtol):
# |kernel - plain| <= atol + atol_per_rms * rms(plain) + rtol * |plain|.
# fp32: the two differ only in summation order.
TOL_FP32 = (1e-4, 0.0, 1e-4)
# bf16: the sums run in another order, so a cast point may round one bf16
# ulp (2^-8 of the intermediate) apart and carry into the next stage. The
# intermediates' scale sets that error, not the element's own size, so the
# absolute part follows the output's rms.
TOL_BF16 = (0.0, 0.1, 2e-2)
# The generator's launches per forward.
EXPECTED_PER_FORWARD = {"fused_ir": 9, "depthwise3x3": 17,
                        "cross_attention": 4}


class Timer:
    """Median CUDA-event time of a callable, with L2 flushed before each
    repetition (the main path meets its inputs cold). The flush (256 MB,
    ~0.1 ms on the device) also gives the host time to enqueue the timed
    call behind it, so the events time the device's work, not a wrapper's
    host cost."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, warmup: int = 2, reps: int = 10) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_err(a, b, tol) -> tuple[float, bool]:
    """Max abs error of a against b, and whether every element is within
    tol (see TOL_FP32)."""
    d = (a.float() - b.float()).abs()
    ref = b.float()
    limit = tol[0] + tol[1] * ref.pow(2).mean().sqrt() + tol[2] * ref.abs()
    return d.max().item(), bool((d <= limit).all())


def tol_text(tol) -> str:
    return f"tol {tol[0]:g} + {tol[1]:g} rms(ref) + {tol[2]:g}|ref|"


# ------------------------------------------------------ library calls

def _leaky(t):
    return F.leaky_relu(t, LEAKY_SLOPE)


def _library_dw(x, taps, scale, bias, stride=1):
    c, dt = x.shape[-1], x.dtype
    w = taps.t().reshape(c, 1, 3, 3).to(dt)
    s, b = scale.to(dt)[:, None, None], bias.to(dt)[:, None, None]
    xn = x.permute(0, 3, 1, 2)
    return lambda: _leaky(F.conv2d(xn, w, stride=stride, padding=1,
                                   groups=c) * s + b)


def _library_ir(x, w1, b1, kd, bd, w2, b2, residual=False):
    dt, ch = x.dtype, w1.shape[1]
    c1 = w1.t()[:, :, None, None].to(dt).contiguous()
    cd = kd.t().reshape(ch, 1, 3, 3).to(dt).contiguous()
    c2 = w2.t()[:, :, None, None].to(dt).contiguous()
    b1_, bd_, b2_ = b1.to(dt), bd.to(dt), b2.to(dt)
    xn = x.permute(0, 3, 1, 2)

    def run():
        h = _leaky(F.conv2d(xn, c1, b1_))
        h = _leaky(F.conv2d(h, cd, bd_, padding=1, groups=ch))
        o = _leaky(F.conv2d(h, c2, b2_))
        return o + xn if residual else o
    return run


def _library_attn(q, k, v):
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)


# ------------------------------------------------------------- bounds
# (bytes the call must move, each input read once and each output written
# once; operations on these inputs; the dtype whose peak rate applies)

def _size(t) -> int:
    return t.numel() * t.element_size()


def _bound_dw(x, taps, scale, bias, stride=1):
    b, h, w, c = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out_bytes = b * ho * wo * c * x.element_size()
    nbytes = _size(x) + out_bytes + _size(taps) + _size(scale) + _size(bias)
    ops = b * ho * wo * c * (2 * 9 + 3)
    return nbytes, ops, str(x.dtype)


def _bound_ir(x, w1, b1, kd, bd, w2, b2, residual=False):
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    s = x.element_size()
    nbytes = (_size(x) + b * h * w * cout * s
              + (cin * ch + 9 * ch + ch * cout) * s + 4 * (2 * ch + cout))
    ops = 2 * b * h * w * (cin * ch + 9 * ch + ch * cout)
    return nbytes, ops, str(x.dtype)


def _bound_attn(q, k, v):
    b, n, d = q.shape
    c = v.shape[-1]
    nbytes = _size(q) + _size(k) + 2 * _size(v)
    ops = 2 * b * n * n * (d + c)
    return nbytes, ops, str(q.dtype)


def bound_ms(nbytes: int, ops: int, dtype: str) -> tuple[float, float]:
    """(bytes over the memory rate, operations over the dtype's peak), ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3


def kernel_table() -> dict:
    """name -> (wrapper, plain version, library call builder, bound)."""
    plain = {"fused_ir": fused_inverted_residual_plain,
             "depthwise3x3": depthwise3x3_plain,
             "cross_attention": cross_attention_plain}
    library = {"fused_ir": _library_ir, "depthwise3x3": _library_dw,
               "cross_attention": _library_attn}
    bound = {"fused_ir": _bound_ir, "depthwise3x3": _bound_dw,
             "cross_attention": _bound_attn}
    return {name: SimpleNamespace(kernel=fn, plain=plain[name],
                                  library=library[name], bound=bound[name])
            for name, fn in WRAPPERS.items()}


# ------------------------------------------------------------ the generator

def random_generator(dtype, ops="kernels"):
    """The full-width generator (hubert, 4 attention blocks) on the card
    with random weights, every leaf randomized (the attention gammas
    included), carried in through the JAX layout."""
    from ..core.weights import from_jax_generator, random_jax_generator
    from ..nn.unet import Generator

    model = Generator(mode="hubert", n_blocks=4, dtype=dtype, ops=ops)
    model.load_state_dict(from_jax_generator(random_jax_generator(seed=0)),
                          strict=True)
    return model.cuda().eval()


def generator_inputs(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((batch, 160, 160, 6), dtype=np.float32))
    a = torch.from_numpy(rng.standard_normal(
        (batch, 32, 32, 32)).astype(np.float32))
    return x.cuda(), a.cuda()


def record_forward(model, x, a):
    """One forward through the kernels with every kernel call recorded:
    (output, launch counts of the forward, [(name, args, kwargs), ...])."""
    from ..nn.blocks import KERNEL_OPS

    calls = []

    def recording(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw))
            return out
        return run

    rec = SimpleNamespace(
        fused_ir=recording("fused_ir", KERNEL_OPS.fused_ir),
        depthwise=recording("depthwise3x3", KERNEL_OPS.depthwise),
        attention=recording("cross_attention", KERNEL_OPS.attention))
    with_ops = [m for m in model.modules() if hasattr(m, "ops")]
    for m in with_ops:
        m.ops = rec
    try:
        reset_launches()
        out = model(x, a)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        for m in with_ops:
            m.ops = KERNEL_OPS
    return out, counts, calls


def time_launches(table, calls, timer, plain: bool = True):
    """Kernel time (and the plain version's, when ``plain``), library time
    and bound of every recorded launch, each launch first held against its
    plain version at TOL_BF16; sums per kernel over the forward. Returns
    (totals by kernel name, per-launch rows, launches that disagree)."""
    per_launch, failures = [], []
    totals = {n: dict(ms=0.0, plain_ms=0.0 if plain else None,
                      library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                      max_abs_err=0.0)
              for n in EXPECTED_PER_FORWARD}
    with torch.inference_mode():
        for name, args, kw in calls:
            k = table[name]
            out = k.kernel(*args, **kw)
            ref = k.plain(*args, **kw)
            err, ok = max_err(out, ref, TOL_BF16)
            if not ok:
                failures.append(f"{name} on main-path input "
                                f"{tuple(args[0].shape)}: max abs err {err}")
            del out, ref
            ms = timer.ms(lambda: k.kernel(*args, **kw))
            plain_ms = (timer.ms(lambda: k.plain(*args, **kw), reps=5)
                        if plain else None)
            library_ms = timer.ms(k.library(*args, **kw))
            nbytes, ops, dt = k.bound(*args, **kw)
            bytes_ms, ops_ms = bound_ms(nbytes, ops, dt)
            row = dict(name=name, shape=list(args[0].shape),
                       out_channels=int(args[5].shape[1])
                       if name == "fused_ir" else None,
                       kw=dict(kw), ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       bound_ms=max(bytes_ms, ops_ms), bytes=nbytes, ops=ops,
                       bound_by="bytes" if bytes_ms >= ops_ms else
                       "operations", max_abs_err=err)
            per_launch.append(row)
            print(f"time {name} {row['shape']} {row['kw']}: {ms:.4f} ms"
                  + (f", plain {plain_ms:.4f}" if plain else "")
                  + f", library {library_ms:.4f}, bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})")
            t = totals[name]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                if row[key] is not None:
                    t[key] += row[key]
            t["bytes_ms"] += bytes_ms
            t["ops_ms"] += ops_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
    return totals, per_launch, failures
