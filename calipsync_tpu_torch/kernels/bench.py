"""Per-launch times of the kernels at the generator's main-path inputs, and
the fused-IR stage bisect, on one GPU.

    python -m calipsync_tpu_torch.kernels.bench [--bisect] [--dw-sweep]
                                                [--serving] [--out PATH]

Builds the kernels and records the kernel calls of one B=128 bf16
generator forward (random weights from seed 0). Each launch is held
against its plain version and timed beside its bound and one PyTorch
library call computing the same function, on the yardstick that
``chip_smoke.py`` uses (``kernels/measure.py``); the sums per kernel over
the forward, the forward's own time, the serving step's compute-only
fps, and each kernel's host time over the forward and a call (enqueue
only) follow, through the wrapper and, where the kernels are
``torch.library`` ops, through the op and its CUDA implementation alone.
With ``--serving`` it adds the serving numbers that the host's enqueue
bounds: multi-stream fps and first frame, and a live-sized window's time
and first frame at the default batch and head batch. For the first
cross-attention launch it also reads the kernel's and SDPA's device time
from torch.profiler, and the wrapper's host time. With ``--bisect`` it builds a
second library with the fused-IR variants that stop after each stage (x
tile in and out stored; + expand; + depthwise; the full kernel), times
them at every fused-IR launch and reads the full kernel's clock64() phase
stamps. With ``--dw-sweep`` it holds, at every depthwise launch, the TMA
kernel's planned tiling (``depthwise.plan_tiles``) against the simple
kernel (which the bf16 path no longer takes) and against every tiling of
a grid (tiles of 2-20 rows and columns that divide the output, 1-4 runs
of rows, 2-4 stages), each checked against the plain version first; the
device time of the planned and simple kernels comes from torch.profiler.
Results also go to ``--out`` as JSON.

Without ``--bisect`` or ``--dw-sweep`` the script needs only the wrappers
and the generator, so it times an earlier tree's kernels on the same
yardstick: copy this file and ``measure.py`` into that tree's
``calipsync_tpu_torch/kernels/`` and run it there.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from . import _build, depthwise, measure
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


def host_us_per_forward(fns: dict, calls, reps: int = 200) -> dict:
    """Host time of each kernel's calls of one forward through ``fns[name]``
    (enqueue only, the device idle at the start of each), microseconds: the
    least and the median of `reps` forwards' worth. The host is shared, so
    the least is the steadier reading."""
    out = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            mine = [(a, kw) for n, a, kw in calls if n == name]
            times = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for a, kw in mine:
                    fn(*a, **kw)
                times.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            out[name] = dict(min=min(times[1:]),
                             median=statistics.median(times[1:]))
    return out


def call_layers(table) -> dict:
    """What a kernel call goes through, each layer callable on the
    recorded wrapper arguments: the wrapper and, where this tree binds the
    kernels as ``torch.library`` ops, the op (the dispatcher and the CUDA
    implementation) and the CUDA implementation alone."""
    layers = {"wrapper": {n: t.kernel for n, t in table.items()}}
    if hasattr(depthwise, "_depthwise_cuda"):
        from .cross_attention import _attention_cuda
        from .fused_ir import _fused_ir_cuda

        ops = torch.ops.calipsync
        layers["op"] = {"fused_ir": ops.fused_ir.default,
                        "depthwise3x3": ops.depthwise3x3.default,
                        "cross_attention": ops.cross_attention.default}
        layers["impl"] = {"fused_ir": _fused_ir_cuda,
                          "depthwise3x3": depthwise._depthwise_cuda,
                          "cross_attention": _attention_cuda}
    return layers


def _speaker(tmp: str, name: str) -> str:
    from ..bench_assets import make_synthetic_speaker
    return make_synthetic_speaker(os.path.join(tmp, name), n_frames=40,
                                  res=480)


def compute_only_fps(model, timer, rows: int = 1024) -> float:
    """``measure.compute_only_fps`` (chip_smoke.py's compute-only number)
    of FrameSynthesizer at B=BATCH over ``rows`` feature rows of a
    synthetic 480x480 speaker."""
    import tempfile

    import numpy as np

    from ..infer.synthesizer import FrameSynthesizer

    feats = np.random.default_rng(3).standard_normal(
        (rows, 2, 1024)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        synth = FrameSynthesizer(None, _speaker(tmp, "s0"), model=model,
                                 batch_size=BATCH, seed=0,
                                 transfer_format="bgr")
        fps = measure.compute_only_fps(synth, torch.from_numpy(feats).to(
            synth.device, model.dtype), timer)
        synth.close()
    return fps


def serving(model, streams: int = 16, window: int = 25, ticks: int = 8,
            requests: int = 20) -> dict:
    """The serving numbers that the host's enqueue bounds, bgr, synthetic
    480x480 speakers: multi-stream at B=BATCH (``streams`` streams of
    ``window`` frames over two speakers, a warm-up tick and ``ticks``
    timed) and live-sized windows (``window`` rows at InferConfig's batch
    size and first-window head batch, a warm-up and ``requests`` timed);
    medians and least."""
    import tempfile

    import numpy as np

    from ..config import InferConfig
    from ..infer.synthesizer import FrameSynthesizer
    from ..serve.multi_stream import MultiStreamSynthesizer

    rng = np.random.default_rng(40)

    def rows(n):
        return rng.standard_normal((n, 2, 1024)).astype(np.float32)

    def stats(values, scale=1e3):
        return dict(median=statistics.median(values) * scale,
                    min=min(values) * scale)

    icfg = InferConfig()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        speakers = [_speaker(tmp, "s0"), _speaker(tmp, "s1")]
        ms = MultiStreamSynthesizer(None, speakers, model=model,
                                    batch_size=BATCH, transfer_format="bgr")
        ids = [f"s{i}" for i in range(streams)]
        for i, sid in enumerate(ids):
            ms.add_stream(sid, speaker=i % 2)
        windows = [{sid: rows(window) for sid in ids}
                   for _ in range(ticks + 1)]
        _, walls, firsts = measure.multistream_ticks(ms, windows)
        ms.close()
        out["multistream_bgr"] = dict(
            fps=ticks * streams * window / sum(walls[1:]),
            tick_ms=stats(walls[1:]), first_frame_ms=stats(firsts[1:]))
        synth = FrameSynthesizer(None, speakers[0], model=model,
                                 batch_size=icfg.batch_size, seed=0,
                                 transfer_format="bgr")
        feats = rows(window)
        walls, firsts = [], []
        for _ in range(requests + 1):
            _, wall, first, head = measure.timed_request(
                synth, feats, icfg.first_window_batch)
            walls.append(wall)
            firsts.append(first)
        synth.close()
        out["live_window"] = dict(
            batch=icfg.batch_size, head_batch=head, rows=window,
            window_ms=stats(walls[1:]), first_frame_ms=stats(firsts[1:]))
    return out


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


def _sweep_plans(shape, stride):
    """The grid of tilings a sweep times: tiles of 2-20 output rows and
    columns that divide the output, 1-4 runs of at least 2 rows, 2-4
    stages."""
    b, h, w, c = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1

    def sizes(n):
        return [d for d in range(2, 21) if n % d == 0] or [n]
    plans = []
    for th in sizes(ho):
        for tw in sizes(wo):
            for segments in range(1, 5):
                for stages in range(2, depthwise.MAX_STAGES + 1):
                    p = depthwise.tiling(b, h, w, c, stride, th, tw,
                                         segments, stages)
                    if p is not None and -(-th // segments) >= 2:
                        plans.append(p)
    return plans


def dw_sweep(calls, timer) -> list[dict]:
    """The --dw-sweep rows, one a depthwise launch (see the docstring); the
    grid is timed once a distinct (shape, stride)."""
    rows, grids = [], {}
    with torch.inference_mode():
        for name, a_, kw in calls:
            if name != "depthwise3x3":
                continue
            x, kernel, scale, bias = a_
            stride = kw.get("stride", 1)
            taps = depthwise._taps9(kernel).float().contiguous()
            scale, bias = scale.float().contiguous(), bias.float().contiguous()
            shape = tuple(x.shape)
            ref = depthwise.depthwise3x3_plain(x, taps, scale, bias, stride)
            planned = depthwise.plan_tiles(*shape, stride)

            def timed(plan):
                args = (None if plan is None else
                        (ctypes.c_int * 8)(*plan.kernel_args()))
                run = lambda: depthwise.launch(x, taps, scale, bias, stride,
                                               args)
                err, ok = measure.max_err(run(), ref, measure.TOL_BF16)
                if not ok:
                    raise RuntimeError(f"depthwise {shape} {plan}: max abs "
                                       f"err {err}")
                return timer.ms(run), run

            ms, run_planned = timed(planned)
            simple_ms, run_simple = timed(None)
            row = dict(
                shape=list(shape), stride=stride, ms=ms,
                wrapper_ms=timer.ms(lambda: depthwise.depthwise3x3(*a_,
                                                                   **kw)),
                simple_ms=simple_ms,
                device_ms=device_ms(run_planned, "dw3x3_tma"),
                simple_device_ms=device_ms(run_simple, "dw3x3_kernel"),
                library_ms=timer.ms(measure._library_dw(x, taps, scale,
                                                        bias, stride)),
                bound_ms=measure.bound_ms(*measure._bound_dw(
                    x, taps, scale, bias, stride))[0],
                planned=dataclasses.asdict(planned))
            key = (shape, stride)
            if key not in grids:
                grids[key] = [dict(dataclasses.asdict(p), ms=timed(p)[0])
                              for p in _sweep_plans(shape, stride)]
            row["plans"] = grids[key]
            best = min(row["plans"], key=lambda r: r["ms"])
            row["best_swept_ms"] = best["ms"]
            print(f"dw {shape} s{stride}: planned {ms:.4f} (wrapper "
                  f"{row['wrapper_ms']:.4f}) "
                  f"({planned.tile_h}x{planned.tile_w}/{planned.segments} "
                  f"st{planned.stages} bps{planned.blocks_per_sm}), device "
                  f"{row['device_ms']:.4f}; best of {len(row['plans'])} "
                  f"swept {best['ms']:.4f} "
                  f"({best['tile_h']}x{best['tile_w']}/{best['segments']} "
                  f"st{best['stages']} bps{best['blocks_per_sm']}); simple "
                  f"{simple_ms:.4f} (device {row['simple_device_ms']:.4f}); "
                  f"cuDNN {row['library_ms']:.4f}; bound "
                  f"{row['bound_ms']:.4f}")
            rows.append(row)
    sums = {k: sum(r[k] for r in rows)
            for k in ("ms", "wrapper_ms", "device_ms", "best_swept_ms",
                      "simple_ms", "simple_device_ms", "library_ms",
                      "bound_ms")}
    print("dw sums over the forward: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sums.items()))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--dw-sweep", action="store_true")
    ap.add_argument("--serving", action="store_true")
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
    fps = compute_only_fps(model, timer)
    serve = serving(model) if args.serving else None
    if serve:
        ms_, live = serve["multistream_bgr"], serve["live_window"]
        print(f"multi-stream bgr: {ms_['fps']:.2f} fps, tick "
              f"{ms_['tick_ms']['median']:.2f} ms, first frame "
              f"{ms_['first_frame_ms']['median']:.2f} ms (medians); live "
              f"window of {live['rows']} rows at B={live['batch']}, head "
              f"{live['head_batch']}: {live['window_ms']['median']:.2f} / "
              f"{live['window_ms']['min']:.2f} ms, first frame "
              f"{live['first_frame_ms']['median']:.2f} / "
              f"{live['first_frame_ms']['min']:.2f} ms (median / least)")
    del model
    print(f"generator forward bf16 B={BATCH}: {fwd_ms:.3f} ms, launches "
          f"{counts}; compute-only {fps:.1f} fps")
    table = measure.kernel_table()
    host_layers = {layer: host_us_per_forward(fns, calls)
                   for layer, fns in call_layers(table).items()}
    host = host_layers["wrapper"]
    print("wrapper host time a forward (enqueue only, least / median): "
          + ", ".join(f"{k} {v['min']:.1f} / {v['median']:.1f} us"
                      for k, v in host.items()))
    for layer, times in host_layers.items():
        print(f"{layer} host time a call (least / median): " + ", ".join(
            f"{k} {v['min'] / n:.2f} / {v['median'] / n:.2f} us"
            for k, v in times.items()
            for n in [measure.EXPECTED_PER_FORWARD[k]]))
    totals, rows, failures = measure.time_launches(table, calls, timer,
                                                   plain=False)
    for name, us in host.items():
        totals[name]["host_us"] = us
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
    sweep = dw_sweep(calls, timer) if args.dw_sweep else None
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "batch": BATCH, "forward_ms": fwd_ms,
                   "compute_only_fps": fps, "serving": serve,
                   "host_us_by_layer": host_layers,
                   "per_forward": totals, "per_launch": rows,
                   "dw_sweep": sweep}, f, indent=1)
    for msg in failures:
        print("FAIL: " + msg)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
