#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calipsync_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from calipsync_tpu_torch/kernels/csrc with nvcc,
then, on the card and with no fallback anywhere:

  1. holds each kernel against its plain PyTorch version at check shapes
     (the largest main-path shape and odd ones), in fp32 with TF32 off
     and in bf16, at the tolerances of calipsync_tpu_torch/kernels/
     measure.py (the timer, bounds and library calls are there too, shared
     with calipsync_tpu_torch/kernels/bench.py);
  2. runs the full-width generator (hubert, 4 attention blocks, random
     weights with every leaf randomized, the attention gammas included)
     in bf16 at B=128 through the kernels and through the plain versions,
     compares the two, checks the launch counts per forward (fused IR 9,
     depthwise 17, attention 4), that the output is not saturated and
     that the audio reaches it; the same in fp32 at a small batch at the
     repo's tolerance;
  3. times every kernel launch of that forward on its own inputs (CUDA
     events, L2 flushed before each repetition): the
     kernel, its plain version and one PyTorch library call computing the
     same function (never called by the port), beside the bound the card
     could reach (bytes over 3.35 TB/s or operations over the dtype's
     peak, whichever is larger);
  4. serves: FrameSynthesizer over a synthetic speaker, batch 128, 1024
     feature rows per request, bgr and yuv420 requests and one request
     with a 4-frame head batch, with the launch counters set to 0 just
     before and read just after; prints fps, compute-only fps and
     first-frame latency;
  5. profiles one more bgr request with torch.profiler: the device's busy
     share of the request and the kernels with the most device time.

Prints the card's name and power limit, a {"kernels": [...]} line and,
last, {"ok": true, "device": {...}}. Exits non-zero, with no result line,
when CUDA is unavailable, when the port is not beside this script, or
when any phase fails. Per-launch details go to
chiprun_out/chip_smoke_detail.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Whole generator, kernels vs plain, in units of the output's own spread
# (std over the batch): bf16 rounding flips compound over 26 blocks.
GEN_BF16_MEAN_ERR_PER_STD = 0.05
GEN_BF16_MAX_ERR_PER_STD = 0.5
# fp32 generator, kernels vs plain: the repo's bar (atol, rtol).
GEN_FP32_TOL = (1e-5, 0.0, 1e-3)
GEN_AUDIO_REACH_PER_STD = 0.1
KERNEL_INFO = {
    "fused_ir": ("calipsync_tpu_torch/kernels/csrc/fused_ir.cu",
                 "calipsync_tpu/kernels/fused_ir.py:122"),
    "depthwise3x3": ("calipsync_tpu_torch/kernels/csrc/depthwise.cu",
                     "calipsync_tpu/kernels/depthwise.py:88; "
                     "calipsync_tpu/kernels/depthwise.py:193"),
    "cross_attention": ("calipsync_tpu_torch/kernels/csrc/cross_attention.cu",
                        "calipsync_tpu/kernels/cross_attention.py:55"),
}
BATCH = 128
FEATURE_ROWS = 1024


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ the phases

def check_kernels(torch, table):
    """Each kernel against its plain version at check shapes, fp32 then
    bf16. Returns name -> max abs error over the bf16 checks."""
    from calipsync_tpu_torch.kernels.measure import (TOL_BF16, TOL_FP32,
                                                     max_err, tol_text)
    rng = np.random.default_rng(0)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    def ir_args(shape, ch, cout, residual):
        cin = shape[-1]
        return ((t(shape), t((cin, ch), cin ** -0.5), t(ch, 0.1),
                 t((9, ch), 1 / 3), t(ch, 0.1), t((ch, cout), ch ** -0.5),
                 t(cout, 0.1)), {"residual": residual})

    def dw_args(shape, stride):
        c = shape[-1]
        return ((t(shape), t((9, c), 1 / 3), t(c, 0.2) + 1, t(c, 0.1)),
                {"stride": stride})

    def misaligned(x):
        """x's values in a view whose data pointer is one element past a
        16-byte boundary."""
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:].copy_(x.flatten())
        return flat[1:].view(x.shape)

    def attn_args(b, n, d, c):
        return (t((b, n, d), 0.3), t((b, n, d), 0.3), t((b, n, c))), {}

    cases = {
        # the largest main-path launch (weights resident), the stem's Cin
        # of 6, Ch not a multiple of the 32-channel chunk, Cout 100,
        # weights streamed a chunk at a time (256 -> 512 -> 64; at B=2 one
        # tile a block, at the main path's B=128 many tiles a block that
        # reuse the two weight slots), a tile straddling the right and
        # bottom edges, W smaller than a tile
        "fused_ir": [ir_args((BATCH, 160, 160, 64), 128, 32, False),
                     ir_args((3, 37, 29, 12), 20, 12, True),
                     ir_args((2, 41, 23, 6), 12, 32, False),
                     ir_args((2, 13, 21, 40), 72, 100, False),
                     ir_args((2, 19, 35, 256), 512, 64, False),
                     ir_args((2, 40, 40, 256), 512, 64, False),
                     ir_args((BATCH, 40, 40, 256), 512, 64, False),
                     ir_args((2, 50, 70, 32), 64, 32, True),
                     ir_args((2, 11, 5, 16), 32, 16, True)],
        # the largest main-path launch; C 12 and 5 (the simple kernel);
        # C a multiple of 8 but not of the 64-channel slab, both strides;
        # a stride-2 launch whose last boxes take the bottom and right pad;
        # the main path's 10x10 whole-plane tiles; B=1; an x view that is
        # not 16-byte aligned (the simple kernel)
        "depthwise3x3": [dw_args((BATCH, 160, 160, 64), 2),
                         dw_args((3, 37, 29, 12), 2),
                         dw_args((2, 19, 21, 72), 1),
                         dw_args((2, 11, 13, 5), 1),
                         dw_args((2, 19, 21, 72), 2),
                         dw_args((2, 41, 23, 128), 2),
                         dw_args((BATCH, 10, 10, 2048), 1),
                         dw_args((1, 20, 20, 1024), 1),
                         dw_args((2, 20, 20, 512), 1) + (misaligned,)],
        # N 77 and 300 (three 128-key blocks and three query tiles), D 24,
        # C not a multiple of the 64-column slab, rows not 16-byte aligned
        "cross_attention": [attn_args(BATCH, 100, 64, 512),
                            attn_args(3, 77, 24, 200),
                            attn_args(2, 300, 64, 96),
                            attn_args(2, 100, 64, 200),
                            attn_args(2, 50, 20, 100)],
    }
    errors = {}
    for name, arg_list in cases.items():
        k = table[name]
        worst = 0.0
        for args, kw, *prep in arg_list:
            for dtype, tol in ((torch.float32, TOL_FP32),
                               (torch.bfloat16, TOL_BF16)):
                # the wrappers cast weights themselves; activations carry
                # the dtype
                a = ([x.to(dtype) for x in args] if name == "cross_attention"
                     else [args[0].to(dtype), *args[1:]])
                for f in prep:
                    a[0] = f(a[0])
                    check(a[0].data_ptr() % 16 != 0, "view is aligned")
                out = k.kernel(*a, **kw)
                torch.cuda.synchronize()
                ref = k.plain(*a, **kw)
                err, ok = max_err(out, ref, tol)
                shape = tuple(args[0].shape)
                print(f"check {name} {shape} {kw} {str(dtype)[6:]}"
                      f"{' misaligned' if prep else ''}: "
                      f"max_abs_err {err:.3g} "
                      f"({tol_text(tol)})")
                check(ok, f"{name} {shape} {dtype} disagrees with its "
                          f"plain version: max abs err {err}")
                check(out.dtype == dtype and out.shape == ref.shape,
                      f"{name} returned {out.dtype} {tuple(out.shape)}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
        errors[name] = worst
    return errors


def run_generator(torch, timer):
    """Full-width generator, kernels vs plain, bf16 at B=128 and fp32 at
    B=4. Returns the recorded kernel calls of one bf16 forward."""
    from calipsync_tpu_torch.kernels.measure import (
        EXPECTED_PER_FORWARD, generator_inputs, max_err, random_generator,
        record_forward, tol_text)

    model = random_generator(torch.bfloat16)
    plain = random_generator(torch.bfloat16, ops="plain")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"generator: hubert, 4 attention blocks, {n_params} params, bf16")
    check(abs(n_params - 19.79e6) < 0.01e6, f"{n_params} params")

    x, a = generator_inputs(BATCH, seed=1)
    with torch.inference_mode():
        out, counts, calls = record_forward(model, x, a)
        ref = plain(x, a)
        torch.cuda.synchronize()
        print(f"generator launches per forward: {counts}")
        check(counts == EXPECTED_PER_FORWARD,
              f"launches per forward {counts} != {EXPECTED_PER_FORWARD}")
        check(out.shape == (BATCH, 160, 160, 3) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), "generator output")
        std = ref.std().item()
        lo, hi = out.min().item(), out.max().item()
        err = (out - ref).abs()
        mean_err, max_abs = err.mean().item(), err.max().item()
        print(f"generator bf16 B={BATCH}: out in [{lo:.4f}, {hi:.4f}], "
              f"std {std:.4g}; kernels vs plain mean abs err {mean_err:.3g}, "
              f"max abs err {max_abs:.3g} (limits "
              f"{GEN_BF16_MEAN_ERR_PER_STD} / {GEN_BF16_MAX_ERR_PER_STD} "
              f"x std)")
        check(0.01 < lo and hi < 0.99 and std > 1e-3,
              "generator output saturated or constant")
        check(mean_err <= GEN_BF16_MEAN_ERR_PER_STD * std
              and max_abs <= GEN_BF16_MAX_ERR_PER_STD * std,
              "bf16 generator: kernels and plain versions disagree")
        # the comparison sees every layer only if the deep path (audio
        # encoder, fusion, attention) reaches the output
        moved = (model(x, torch.zeros_like(a)) - out).abs().max().item()
        print(f"generator: zeroing the audio moves the output by up to "
              f"{moved:.3g} (needs > {GEN_AUDIO_REACH_PER_STD} x std)")
        check(moved > GEN_AUDIO_REACH_PER_STD * std,
              "the audio does not reach the generator's output")
        fwd_ms = timer.ms(lambda: model(x, a), warmup=1, reps=5)
        plain_ms = timer.ms(lambda: plain(x, a), warmup=1, reps=3)
        print(f"generator forward bf16 B={BATCH}: {fwd_ms:.3f} ms "
              f"(plain versions {plain_ms:.3f} ms)")

        m32 = random_generator(torch.float32)
        p32 = random_generator(torch.float32, ops="plain")
        x4, a4 = generator_inputs(4, seed=2)
        o32, r32 = m32(x4, a4), p32(x4, a4)
        err32, ok32 = max_err(o32, r32, GEN_FP32_TOL)
        print(f"generator fp32 B=4: kernels vs plain max abs err "
              f"{err32:.3g} ({tol_text(GEN_FP32_TOL)})")
        check(ok32, "fp32 generator: kernels and plain versions disagree")
    del plain, m32, p32
    return calls, fwd_ms


def serve(torch, timer):
    """FrameSynthesizer over a synthetic speaker; returns launch counts of
    the serving run and the serving metrics."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker
    from calipsync_tpu_torch.config import InferConfig
    from calipsync_tpu_torch.infer.synthesizer import (
        FrameSynthesizer, make_generate_resident_fn)

    from calipsync_tpu_torch.kernels.measure import (EXPECTED_PER_FORWARD,
                                                     random_generator)

    model = random_generator(torch.bfloat16)
    feats = np.random.default_rng(3).standard_normal(
        (FEATURE_ROWS, 2, 1024)).astype(np.float32)
    metrics = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_speaker(tmp, n_frames=40, res=480)
        synths = {f: FrameSynthesizer(None, data, model=model,
                                      batch_size=BATCH, seed=0,
                                      transfer_format=f, pipeline_depth=3)
                  for f in ("bgr", "yuv420")}
        head = InferConfig().first_window_batch
        requests = [("bgr", 0), ("yuv420", 0), ("bgr", 0), ("yuv420", 0),
                    ("yuv420", head)]
        n_batches = 0
        kernels.reset_launches()
        for fmt, head_batch in requests:
            synth = synths[fmt]
            head_batch = synth.set_first_batch_size(head_batch)
            t0 = time.perf_counter()
            first = None
            frames = []
            for item in synth.iterate_synthesized_frames(feats):
                if first is None:
                    first = time.perf_counter() - t0
                frames.append(item)
            wall = time.perf_counter() - t0
            n_batches += (1 if head_batch else 0) + -(
                -(FEATURE_ROWS - head_batch) // BATCH)
            check(len(frames) == FEATURE_ROWS
                  and [f["index"] for f in frames] == list(range(
                      FEATURE_ROWS)), f"{fmt}: frames missing or reordered")
            for f in frames[:: FEATURE_ROWS // 8]:
                check(f["frame"].shape == (480, 480, 3)
                      and f["frame"].dtype == np.uint8, "frame shape/dtype")
            fps = FEATURE_ROWS / wall
            print(f"serve {fmt} head={head_batch}: {FEATURE_ROWS} frames in "
                  f"{wall:.3f} s = {fps:.2f} fps, first frame "
                  f"{first * 1e3:.2f} ms")
            metrics.setdefault(f"{fmt}_fps", []).append(fps)
            if head_batch:
                metrics["first_frame_ms_head4"] = first * 1e3
            else:
                metrics.setdefault("first_frame_ms", []).append(first * 1e3)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        expected = {n: c * n_batches for n, c in EXPECTED_PER_FORWARD.items()}
        print(f"serving launches: {counts} over {n_batches} device batches")
        check(counts == expected,
              f"serving launches {counts} != {expected}")

        # compute-only: the resident device step alone, and one batch of
        # it held against the plain versions
        synth = synths["bgr"]
        step = synth._generate_resident_fn
        dev = synth.device
        feats_dev = torch.from_numpy(feats).to(dev).to(model.dtype)
        phys = torch.arange(BATCH, device=dev) % synth.total_frames
        idx = [torch.arange(i, i + BATCH, device=dev)
               for i in range(0, FEATURE_ROWS, BATCH)]

        def all_batches():
            for fi in idx:
                step(synth._crops_dev, phys, feats_dev, fi)

        ms = timer.ms(all_batches, warmup=1, reps=3)
        metrics["compute_only_fps"] = FEATURE_ROWS / (ms / 1e3)
        print(f"compute-only (device step, bgr, B={BATCH}): "
              f"{metrics['compute_only_fps']:.2f} fps")
        rows = step(synth._crops_dev, phys, feats_dev, idx[0])
        plain_step = make_generate_resident_fn(
            random_generator(torch.bfloat16, ops="plain"),
            synth.crop, "bgr")
        ref = plain_step(synth._crops_dev, phys, feats_dev, idx[0])
        lsb = (rows.int() - ref.int()).abs()
        print(f"serving step bgr: kernels vs plain max {lsb.max().item()} "
              f"LSB, {(lsb > 1).float().mean().item():.3g} of values "
              f"beyond 1 LSB")
        check((lsb > 1).float().mean().item() <= 0.01,
              "serving step: kernels and plain versions disagree")
        metrics["profile"] = profile_request(torch, synth, feats)
        for s in synths.values():
            s.close()
    return counts, metrics


def profile_request(torch, synth, feats):
    """One bgr request under torch.profiler: its wall time, the device's
    busy share (kernel time over wall time; one stream, so kernels do not
    overlap) and the kernels with the most device time. The profiler slows
    the host, so the busy share it shows is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in synth.iterate_synthesized_frames(feats):
            pass
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:  # the attribute's name before torch 2.4
                us = e.self_cuda_time_total
            kernels.append((e.key, us / 1e3))
    kernels.sort(key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    if busy_ms == 0:
        print("profiled request: the profiler recorded no device time "
              "(device busy share not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    print(f"profiled request (bgr, {len(feats)} frames): wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms = "
          f"{busy_ms / wall_ms:.3f} of wall")
    for name, ms in kernels[:8]:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_kernels_ms": kernels[:20]}


def print_kernel_resources(_build):
    """Each compiled kernel's registers, static shared memory, spills and
    any performance warning (from ptxas -v in build/nvcc.log), and the
    dynamic shared memory the main path's launches ask for."""
    import ctypes
    import re

    name = None
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            name = re.sub(r"^_ZN9calipsync\d+_GLOBAL__N__\w+?_\d+", "",
                          raw)[:60]
            spills = "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Performance Loss: (.*) in the function '(\S+)'",
                      line)
        if m:  # e.g. wgmma serialized by ptxas
            short = re.sub(r"^_ZN9calipsync\d+_GLOBAL__N__\w+?_\d+", "",
                           m.group(2))[:60]
            print(f"  {short}: {m.group(1)}")
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            print(f"  {name}: {m.group(1)} registers, static smem "
                  f"{smem.group(1) if smem else 0} B, {spills}")
            name = None
    i = ctypes.c_int
    attn = _build.function("calipsync_cross_attention_smem", [i, i, i],
                           restype=ctypes.c_longlong)
    print(f"  cross_attention (N 100, D 64, bf16): dynamic smem "
          f"{attn(100, 64, 1)} B")
    from calipsync_tpu_torch.kernels.depthwise import plan_tiles
    for h, w, c, s in [(160, 160, 64, 2), (80, 80, 128, 2), (40, 40, 256, 2),
                       (20, 20, 512, 2), (20, 20, 1024, 1), (32, 32, 64, 1),
                       (16, 16, 512, 1), (10, 10, 2048, 1)]:
        p = plan_tiles(BATCH, h, w, c, s)
        print(f"  depthwise {h}x{h} C{c} s{s}: tile {p.tile_h}x{p.tile_w} "
              f"(box {p.box_h}x{p.box_w}x{p.slab}), {p.segments} runs of "
              f"rows, {p.stages} stages, {p.threads} threads, "
              f"{p.blocks_per_sm} blocks/SM, dynamic smem {p.smem} B")
    plan = _build.function("calipsync_fused_ir_plan", [i] * 5 +
                           [ctypes.c_void_p])
    for hw, cin, ch, cout in [(160, 6, 12, 32), (80, 64, 128, 64),
                              (40, 128, 256, 128), (40, 256, 512, 64),
                              (40, 64, 128, 64), (80, 128, 256, 32),
                              (80, 32, 64, 32), (160, 64, 128, 32),
                              (160, 32, 64, 32)]:
        out = (ctypes.c_int * 7)()
        plan(hw, hw, cin, ch, cout, ctypes.addressof(out))
        print(f"  fused_ir {hw}x{hw} {cin}->{ch}->{cout}: tile {out[0]}x"
              f"{out[1]} ({out[2]} haloed rows), weights "
              f"{'resident' if out[3] else 'streamed'}, dynamic smem "
              f"{out[4]} B, {out[5]} blocks/SM")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from calipsync_tpu_torch.kernels import _build, measure
    except ImportError as e:
        print(f"FAIL: the port is not importable beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    _, build_s = _build.build(force=True)
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources in parallel)")
    print_kernel_resources(_build)

    timer = measure.Timer()
    table = measure.kernel_table()
    check_errors = check_kernels(torch, table)
    calls, fwd_ms = run_generator(torch, timer)
    totals, per_launch, failures = measure.time_launches(table, calls, timer)
    check(not failures, "; ".join(failures))
    del calls
    torch.cuda.empty_cache()
    counts, metrics = serve(torch, timer)

    kernels_line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = totals[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(t["max_abs_err"], check_errors[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "library_ms": t["library_ms"]})
    detail = {"device": smi, "batch": BATCH, "per_launch": per_launch,
              "kernels": kernels_line, "generator_forward_ms": fwd_ms,
              "serving": metrics}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump(detail, f, indent=1)
    print("per forward (B=128 bf16), ms = sum over the kernel's launches:")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
