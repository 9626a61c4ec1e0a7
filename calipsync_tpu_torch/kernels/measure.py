"""One yardstick for the kernels on the card, shared by ``chip_smoke.py``
and ``kernels/bench.py``: the CUDA-event timer, the tolerances of a kernel
against its plain version, the bound of each launch, the PyTorch library
call that computes the same function (timed for comparison, never called by
the port), the launches of one generator forward, recorded with their
inputs, and the serving numbers (compute-only fps, a streamed request's
first frame, multi-stream ticks).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from . import WRAPPERS, launch_counts, reset_launches
from .cross_attention import cross_attention_plain
from .depthwise import depthwise3x3_plain
from .fused_ir import LEAKY_SLOPE, fused_inverted_residual_plain

HBM_BYTES_PER_S = 3.35e12
# Peak rates by the arithmetic a kernel runs: bf16 on the tensor cores,
# fp32 on the CUDA cores, and fp32 products as three TF32 tensor-core
# passes (hi.hi + hi.lo + lo.hi: fp32 accuracy at a third of the 495
# TFLOP/s TF32 rate), which the fp32 fused IR runs.
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
            "tf32x3": 495e12 / 3}
# Kernel vs plain version, (atol, atol per rms, rtol):
# |kernel - plain| <= atol + atol_per_rms * rms(plain) + rtol * |plain|.
# fp32: the two differ only in summation order.
TOL_FP32 = (1e-4, 0.0, 1e-4)
# bf16: the sums run in another order, so a cast point may round one bf16
# ulp (2^-8 of the intermediate) apart and carry into the next stage. The
# intermediates' scale sets that error, not the element's own size, so the
# absolute part follows the output's rms.
TOL_BF16 = (0.0, 0.1, 2e-2)
# Gradients through the kernel (its forward, the plain backward) against
# autograd through the plain version, dq, dk and dv: the two backward
# passes run the same fp32 products in another order, and in bf16 each
# gradient is then rounded once to bf16 (one ulp, 2^-8 of the value).
TOL_GRAD_FP32 = (1e-4, 0.0, 1e-4)
TOL_GRAD_BF16 = (0.0, 0.02, 1e-2)
# A whole train step, kernels against plain versions. The generator's
# gradient is ill-conditioned in train mode: a perturbation at a block's
# input about doubles through the block, so rounding alone moves the
# early leaves by percents (fp32 against fp64 on the CPU: a median 6% a
# leaf). The yardstick is the plain versions in fp64: each leaf of the
# kernels' gradient must be as close to it as the plain versions' in the
# same dtype, within GRAD_LEAF_RATIO on every leaf and GRAD_RMS_RATIO in
# rms over the leaves (on the CPU, JAX against the port: a tail of 3.4 a
# leaf over 300 leaves, 1.1 at the median), plus GRAD_LEAF_SLACK of the
# leaf's norm: near the output, where the rounding error of a leaf is
# under 1%, it moves by more than 5x with the thread count alone.
GRAD_LEAF_RATIO = 5.0
GRAD_LEAF_SLACK = 0.01
GRAD_RMS_RATIO = 1.5
# The attention projections' weight gradients of a train step against the
# plain version, relative error over the leaf's norm: each CrossAttention
# re-run through cross_attention_plain on the inputs, parameters and output
# gradient recorded in the step (attention_grad_errors). The step and the
# re-run share all but the attention: in fp32 they differ in the order of
# the sums; in bf16 by a rounding (2^-8 of the value) of the output and of
# dq, dk and dv here and there. A gradient of the wrong sign or scale, or
# from another block, is O(1) away.
TOL_PROJ_GRAD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
    fp32 = x.dtype == torch.float32
    return nbytes, ops, "tf32x3" if fp32 else str(x.dtype)


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


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """A scope with cuDNN's TF32 flag set to ``on``, restored after."""
    kept = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = kept


def time_launches(table, calls, timer, plain: bool = True):
    """Kernel time (and the plain version's, when ``plain``), library time
    and bound of every recorded launch, each launch first held against its
    plain version at TOL_FP32 or TOL_BF16 by its dtype; sums per kernel
    over the forward. The library call of an fp32 launch is timed with
    cuDNN's TF32 off (``library_ms``, exact fp32) and on
    (``library_tf32_ms``, PyTorch's default). Each row also carries both
    fp32 bounds: the operations over the CUDA cores' 67 TFLOP/s
    (``ops_cuda_ms``) and as three TF32 passes over 495 TFLOP/s
    (``ops_tf32x3_ms``). Returns (totals by kernel name, per-launch rows,
    launches that disagree)."""
    per_launch, failures = [], []
    keys = ("ms", "plain_ms", "library_ms", "library_tf32_ms", "bound_ms",
            "bytes_ms", "ops_ms", "ops_cuda_ms", "ops_tf32x3_ms")
    totals = {n: dict({k: 0.0 for k in keys}, max_abs_err=0.0,
                      launches=0)
              for n in EXPECTED_PER_FORWARD}
    with torch.inference_mode():
        for name, args, kw in calls:
            k = table[name]
            fp32 = args[0].dtype == torch.float32
            out = k.kernel(*args, **kw)
            ref = k.plain(*args, **kw)
            err, ok = max_err(out, ref, TOL_FP32 if fp32 else TOL_BF16)
            if not ok:
                failures.append(f"{name} on main-path input "
                                f"{tuple(args[0].shape)}: max abs err {err}")
            del out, ref
            ms = timer.ms(lambda: k.kernel(*args, **kw))
            plain_ms = (timer.ms(lambda: k.plain(*args, **kw), reps=5)
                        if plain else None)
            with cudnn_tf32(False):
                library_ms = timer.ms(k.library(*args, **kw))
            library_tf32_ms = None
            if fp32:
                with cudnn_tf32(True):
                    library_tf32_ms = timer.ms(k.library(*args, **kw))
            nbytes, ops, rate = k.bound(*args, **kw)
            bytes_ms, ops_ms = bound_ms(nbytes, ops, rate)
            row = dict(name=name, shape=list(args[0].shape),
                       out_channels=int(args[5].shape[1])
                       if name == "fused_ir" else None,
                       kw=dict(kw), ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       library_tf32_ms=library_tf32_ms,
                       bound_ms=max(bytes_ms, ops_ms), bytes=nbytes, ops=ops,
                       rate=rate, bytes_ms=bytes_ms, ops_ms=ops_ms,
                       ops_cuda_ms=ops / PEAK_OPS["torch.float32"] * 1e3,
                       ops_tf32x3_ms=ops / PEAK_OPS["tf32x3"] * 1e3,
                       bound_by="bytes" if bytes_ms >= ops_ms else
                       "operations", max_abs_err=err)
            per_launch.append(row)
            print(f"time {name} {row['shape']} {row['kw']}: {ms:.4f} ms"
                  + (f", plain {plain_ms:.4f}" if plain else "")
                  + f", library {library_ms:.4f}"
                  + (f" (TF32 on {library_tf32_ms:.4f})" if fp32 else "")
                  + f", bound {row['bound_ms']:.4f} ({row['bound_by']}, "
                  f"{rate})")
            t = totals[name]
            for key in keys:
                if row[key] is not None:
                    t[key] += row[key]
            t["launches"] += 1
            t["max_abs_err"] = max(t["max_abs_err"], err)
    for t in totals.values():
        if not plain:
            t["plain_ms"] = None
        if not t["library_tf32_ms"]:
            t["library_tf32_ms"] = None
    return totals, per_launch, failures


def grad_agreement(ours: dict, plain: dict, exact: dict,
                   zero_norm: float = 1e-7, zero_atol: float = 1e-5) -> dict:
    """Leaf by leaf (name -> gradient), how far ``ours`` and ``plain`` are
    from ``exact``, relative to the exact leaf's norm. Returns the
    relative errors, the leaves that fail GRAD_LEAF_RATIO and whether the
    rms ratio is within GRAD_RMS_RATIO. A leaf whose exact gradient is zero
    (a bias ahead of a train-mode BatchNorm) must be zero to rounding:
    within ``zero_atol`` in both; ``zeros`` holds their largest |g|, ours
    and plain's."""
    rows, bad, zeros = {}, [], {}
    for name, g64 in exact.items():
        g64 = g64.double()
        a, b = ours[name].double(), plain[name].double()
        norm = g64.norm().item()
        if norm < zero_norm:
            zeros[name] = (a.abs().max().item(), b.abs().max().item())
            if max(zeros[name]) > zero_atol:
                bad.append(f"{name}: exact gradient zero, got "
                           f"{zeros[name][0]:.3g} (plain "
                           f"{zeros[name][1]:.3g}, bar {zero_atol:.3g})")
            continue
        e_ours = (a - g64).norm().item() / norm
        e_plain = (b - g64).norm().item() / norm
        rows[name] = (e_ours, e_plain)
        if e_ours > GRAD_LEAF_RATIO * e_plain + GRAD_LEAF_SLACK:
            bad.append(f"{name}: {e_ours:.3g} from exact, plain "
                       f"{e_plain:.3g}")
    rms_ours = float(np.sqrt(np.mean([r[0] ** 2 for r in rows.values()])))
    rms_plain = float(np.sqrt(np.mean([r[1] ** 2 for r in rows.values()])))
    return dict(errors=rows, bad=bad, rms=rms_ours, rms_plain=rms_plain,
                zeros=zeros,
                ok=not bad and rms_ours <= GRAD_RMS_RATIO * rms_plain + 1e-4)


def record_attention(model) -> tuple[dict, list]:
    """Hooks on every CrossAttention of ``model`` that record, in its next
    forward, the module's inputs and parameters and then the gradient of
    its output (a step with one forward: no grad_accum, no remat). Returns
    (records by module name, the hooks' handles)."""
    from ..nn.unet import CrossAttention

    records, handles = {}, []

    def hook(name):
        def run(module, inputs, out):
            rec = records[name] = dict(
                inputs=tuple(t.detach() for t in inputs),
                params={n: p.detach().clone()
                        for n, p in module.named_parameters()})
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach()))
        return run

    for name, m in model.named_modules():
        if isinstance(m, CrossAttention):
            handles.append(m.register_forward_hook(hook(name)))
    return records, handles


def attention_grad_errors(model, records: dict, ops) -> dict:
    """For each attention projection's weight (``<block>.query_conv.weight``
    and the key's and value's): the relative error, over the re-run's norm,
    between the gradient that the recorded step left in ``.grad`` and the
    module re-run through ``ops`` on the recorded inputs, parameters and
    output gradient (see TOL_PROJ_GRAD)."""
    from torch.func import functional_call

    errors = {}
    for name, rec in records.items():
        module = model.get_submodule(name)
        params = {n: p.clone().requires_grad_()
                  for n, p in rec["params"].items()}
        kept, module.ops = module.ops, ops
        try:
            with torch.enable_grad():
                out = functional_call(module, params, rec["inputs"])
                grads = torch.autograd.grad(out, list(params.values()),
                                            rec["grad"])
        finally:
            module.ops = kept
        leaves = dict(module.named_parameters())
        for n, g in zip(params, grads):
            if n.endswith("_conv.weight"):
                g = g.double()
                errors[f"{name}.{n}"] = ((leaves[n].grad.double() - g).norm()
                                         / g.norm()).item()
    return errors


# --------------------------------------------------------------- serving

def compute_only_fps(synth, feats: torch.Tensor, timer,
                     reps: int = 5) -> float:
    """Frames a second of the serving device step alone: ``synth``'s
    resident bgr step at its batch size over every row of ``feats``
    ((rows, 2, 1024) on the card, in the model's dtype), CUDA events, L2
    flushed."""
    step = synth._generate_resident_fns["bgr"]
    dev, batch = synth.device, synth.batch_size
    phys = torch.arange(batch, device=dev) % synth.total_frames
    idx = [torch.arange(i, i + batch, device=dev)
           for i in range(0, len(feats), batch)]

    def all_batches():
        for fi in idx:
            step(synth._crops_dev, phys, feats, fi)

    return len(feats) / (timer.ms(all_batches, warmup=1, reps=reps) / 1e3)


def timed_request(synth, feats: np.ndarray, head_batch: int = 0):
    """One streamed request of ``feats`` through ``synth`` with a first
    batch of ``head_batch`` rows (0: none): (frames, wall seconds,
    seconds to the first frame, the head batch taken)."""
    head_batch = synth.set_first_batch_size(head_batch)
    frames, first = [], None
    t0 = time.perf_counter()
    for item in synth.iterate_synthesized_frames(feats):
        if first is None:
            first = time.perf_counter() - t0
        frames.append(item)
    return frames, time.perf_counter() - t0, first, head_batch


def multistream_ticks(ms, ticks: list):
    """MultiStreamSynthesizer ``ms`` over ``ticks`` (each {stream id:
    window of feature rows}): each tick's frames, wall seconds and seconds
    to its first composited frame."""
    first = {}
    saved = [(spk, spk._paste_back) for spk in ms._speakers]
    for spk, inner in saved:
        def paste(pred, entry, _inner=inner):
            first.setdefault("t", time.perf_counter())
            return _inner(pred, entry)

        spk._paste_back = paste
    outs, walls, firsts = [], [], []
    try:
        for tick in ticks:
            first.clear()
            t0 = time.perf_counter()
            outs.append(ms.synthesize_windows(tick))
            walls.append(time.perf_counter() - t0)
            firsts.append(first["t"] - t0)
    finally:
        for spk, inner in saved:
            spk._paste_back = inner
    return outs, walls, firsts
