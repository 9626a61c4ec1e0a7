"""Per-launch times of the kernels at the generator's main-path inputs, and
the fused-IR stage bisect, on one GPU.

    python -m calipsync_tpu_torch.kernels.bench [--bisect] [--out PATH]

Builds the kernels and records the kernel calls of one B=128 bf16
generator forward (random weights from seed 0). Each launch is held
against its plain version and timed beside its bound and one PyTorch
library call computing the same function, on the yardstick that
``chip_smoke.py`` uses (``kernels/measure.py``); the sums per kernel over
the forward and the forward's own time follow. For the first
cross-attention launch it also reads the kernel's and SDPA's device time
from torch.profiler, and the wrapper's host time. With ``--bisect`` it
builds a second library with the fused-IR variants that stop after each
stage (x tile in and out stored; + expand; + depthwise; the full kernel),
times them at every fused-IR launch and reads the full kernel's clock64()
phase stamps. Results also go to ``--out`` as JSON.

Without ``--bisect`` the script needs only the wrappers and the generator,
so it times an earlier tree's kernels on the same yardstick: copy this file
and ``measure.py`` into that tree's ``calipsync_tpu_torch/kernels/`` and
run it there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch
import torch.nn.functional as F

from . import _build, measure
from .cross_attention import cross_attention
from .fused_ir import LEAKY_SLOPE

BATCH = 128
STAGES = ["x in, out stored", "+ expand", "+ depthwise", "full"]
# Phases of the clock64() stamps (warp 0 of each block, barrier waits
# included)
PHASES = ["x load wait", "expand", "depthwise+project", "epilogue+store"]


def device_ms(fn, name_part: str, calls: int = 20) -> float:
    """Mean device time of the CUDA kernels whose name holds name_part over
    `calls` calls of fn, from torch.profiler (no host time in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name_part in e.key:
            us += e.self_device_time_total
    return us / calls / 1e3


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of fn (enqueue only), microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bisect_fn():
    """calipsync_fused_ir_bisect of the library built with the stage
    variants."""
    path, _ = _build.build(defines=("CALIPSYNC_FUSED_IR_BISECT",))
    fn = ctypes.CDLL(str(path)).calipsync_fused_ir_bisect
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, i, p, p]
    fn.restype = i
    return fn


def run_bisect(fn, x, w1, b1, kd, bd, w2, b2, residual, stop, stamps=None):
    from .fused_ir import kernel_weights
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    weights = kernel_weights(x, w1, b1, kd, bd, w2, b2)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), *(t.data_ptr() for t in weights),
                    out.data_ptr(), b, h, w, cin, ch, cout, int(residual),
                    LEAKY_SLOPE, stop,
                    None if stamps is None else stamps.data_ptr(),
                    torch.cuda.current_stream().cuda_stream),
                 "fused_ir bisect")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--out", default="kernel_bench.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _, build_s = _build.build()
    print(f"kernel build: {build_s:.1f} s")
    stop_fn = bisect_fn() if args.bisect else None
    timer = measure.Timer()
    model = measure.random_generator(torch.bfloat16)
    x, a = measure.generator_inputs(BATCH, seed=1)
    with torch.inference_mode():
        _, counts, calls = measure.record_forward(model, x, a)
        fwd_ms = timer.ms(lambda: model(x, a), warmup=1, reps=5)
    del model
    print(f"generator forward bf16 B={BATCH}: {fwd_ms:.3f} ms, launches "
          f"{counts}")
    totals, rows, failures = measure.time_launches(
        measure.kernel_table(), calls, timer, plain=False)
    with torch.inference_mode():
        for row, (name, a_, kw) in zip(rows, calls):
            if name == "fused_ir" and stop_fn is not None:
                row["bisect_ms"] = [
                    timer.ms(lambda: run_bisect(stop_fn, *a_, stop=s, **kw))
                    for s in range(4)]
                stamps = torch.zeros(4, dtype=torch.int64, device="cuda")
                run_bisect(stop_fn, *a_, stop=4, stamps=stamps, **kw)
                cycles = stamps.tolist()
                row["phase_share"] = dict(zip(PHASES, (
                    c / sum(cycles) for c in cycles)))
                print(f"bisect fused_ir {row['shape']} -> "
                      f"{row['out_channels']}: " + ", ".join(
                          f"{s} {t:.4f}" for s, t in zip(STAGES,
                                                         row["bisect_ms"]))
                      + "; cycles " + ", ".join(
                          f"{k} {v:.2f}" for k, v in
                          row["phase_share"].items()))
            if name == "cross_attention" and "device_ms" not in totals[name]:
                q, k, v = a_
                q4, k4, v4 = q[:, None], k[:, None], v[:, None]
                row.update(
                    device_ms=device_ms(lambda: cross_attention(q, k, v),
                                        "calipsync"),
                    library_device_ms=device_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, scale=1.0), ""),
                    host_us=host_us(lambda: cross_attention(q, k, v)))
                totals[name]["device_ms"] = row["device_ms"]
                print(f"cross_attention {row['shape']}: device "
                      f"{row['device_ms']:.4f} ms (SDPA "
                      f"{row['library_device_ms']:.4f}), host "
                      f"{row['host_us']:.1f} us a call")
    for name, t in totals.items():
        print(f"{name} per forward: {t['ms']:.4f} ms, library "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "batch": BATCH, "forward_ms": fwd_ms,
                   "per_forward": totals, "per_launch": rows}, f, indent=1)
    for msg in failures:
        print("FAIL: " + msg)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
