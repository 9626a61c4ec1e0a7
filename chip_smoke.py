#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calipsync_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

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
     that the audio reaches it; compares the two in bf16 at the streaming
     defaults' batch 8 and head batch 4 too, and in fp32 at B=4 at the
     repo's tolerance;
  3. times every kernel launch of that forward on its own inputs (CUDA
     events, L2 flushed before each repetition): the
     kernel, its plain version and one PyTorch library call computing the
     same function (never called by the port), beside the bound the card
     could reach (bytes over 3.35 TB/s or operations over the dtype's
     peak, whichever is larger);
  4. serves: FrameSynthesizer over a synthetic speaker, batch 128, 1024
     feature rows per request, bgr and yuv420 requests and one request
     with a 4-frame head batch; prints fps, compute-only fps and
     first-frame latency;
  5. profiles one more bgr request with torch.profiler: the device's busy
     share of the request and the kernels with the most device time;
  6. audio in, video out (random weights, synthetic wavs from --seed),
     under PyTorch's default flags as a user's process runs:
     (a) HuBERT-large at full width (fp32) on a 4 s wav against the port
     on the CPU, unchanged by cuDNN's TF32 flag, two wavs' features
     apart, the 65 s wav through the chunked path (3 x 20 s + 5 s) equal
     to its streamed pieces, ms a 20 s chunk;
     (b) VideoStreamManager.process_single_file on the 65 s wav, bf16
     generator at B=128, in turns sequential, pipelined, pipelined,
     sequential: 1624 frames of 480x480 and the PCM track read back,
     pipelined frames equal to sequential, wall time and ttff_s, then
     each stage alone; a head batch of 4 against none, within 1 uint8
     level; (c) StreamingVideoManager with a NullPlayer over the serving
     defaults (batch 8, head batch 4, adaptive format): warm-up, two wavs
     (one 'danmu') played in order, every device batch of the session
     replayed through the plain versions, time to first frame (and a
     window's first frame on a fresh thread against the manager's) and
     the format chosen; (d) ``python -m calipsync_tpu_torch.cli infer``
     in a subprocess with checkpoints written here.

Every path that runs the generator (4, the four runs of 6b, 6c, 6d) reads the launch counters, set to 0 just before it, just after it,
and must show whole forwards of 9/17/4 launches.

Prints the card's name and power limit, a {"kernels": [...]} line and,
last, {"ok": true, "device": {...}}. Exits non-zero, with no result line,
when CUDA is unavailable, when the port is not beside this script, or
when any phase fails. Per-launch details and every phase's numbers go to
chiprun_out/chip_smoke_detail.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Whole generator, kernels vs plain, in units of the output's own spread
# (std over the batch): bf16 rounding flips compound over 26 blocks.
GEN_BF16_MEAN_ERR_PER_STD = 0.05
GEN_BF16_MAX_ERR_PER_STD = 0.5
# fp32 generator, kernels vs plain: the repo's bar (atol, rtol).
GEN_FP32_TOL = (1e-5, 0.0, 1e-3)
GEN_AUDIO_REACH_PER_STD = 0.1
# HuBERT-large fp32, card (default flags) vs CPU: the same math summed in
# another order over 24 layers; (atol, atol per rms, rtol) as in
# kernels/measure.py.
HUBERT_CPU_TOL = (1e-3, 0.0, 1e-3)
# Two different wavs' features must differ by this share of their spread
# on average: random weights that saturated or collapsed would not.
HUBERT_MIN_SPREAD = 0.1
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
# A frame must not depend on the batch it was generated in (a 4-frame
# head batch against none): at most this many uint8 levels apart, on at
# most this share of values (every run of PR 4 read 0 levels).
HEAD_BATCH_MAX_LSB = 1
HEAD_BATCH_MAX_SHARE = 1e-3
# Streamed frames against the same calls replayed through the plain
# versions: the serving step's bound, at most this share of values more
# than 1 uint8 level apart.
STREAM_PLAIN_MAX_SHARE = 0.01


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


def bf16_against_plain(out, ref, what: str) -> None:
    """Kernels against plain versions in units of the plain output's
    spread (GEN_BF16_*_PER_STD)."""
    std = ref.std().item()
    err = (out - ref).abs()
    mean_err, max_abs = err.mean().item(), err.max().item()
    print(f"{what}: kernels vs plain mean abs err {mean_err:.3g}, max abs "
          f"err {max_abs:.3g}, plain std {std:.4g} (limits "
          f"{GEN_BF16_MEAN_ERR_PER_STD} / {GEN_BF16_MAX_ERR_PER_STD} x std)")
    check(out.shape == ref.shape and bool(out.isfinite().all()),
          f"{what}: output shape or non-finite")
    check(mean_err <= GEN_BF16_MEAN_ERR_PER_STD * std
          and max_abs <= GEN_BF16_MAX_ERR_PER_STD * std,
          f"{what}: kernels and plain versions disagree")


def run_generator(torch, timer):
    """Full-width generator, kernels vs plain, bf16 at B=128 and at the
    streaming defaults' batch 8 and head batch 4 (the kernels plan their
    tiling per shape), and fp32 at B=4. Returns the recorded kernel calls
    of one B=128 bf16 forward."""
    from calipsync_tpu_torch.config import InferConfig
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
        print(f"generator bf16 B={BATCH}: out in [{lo:.4f}, {hi:.4f}], "
              f"std {std:.4g}")
        check(0.01 < lo and hi < 0.99 and std > 1e-3,
              "generator output saturated or constant")
        bf16_against_plain(out, ref, f"generator bf16 B={BATCH}")
        icfg = InferConfig()
        for b in (icfg.batch_size, icfg.first_window_batch):
            xb, ab = generator_inputs(b, seed=b)
            bf16_against_plain(model(xb, ab), plain(xb, ab),
                               f"generator bf16 B={b}")
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
        step = synth._generate_resident_fns["bgr"]
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


# ------------------------------------------------ audio in, video out

def tone_wav(seconds: float, seed: int) -> np.ndarray:
    """16 kHz float32 speech stand-in made from ``seed``: three tones
    whose pitches glide, an amplitude envelope at syllable rate, and
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000
    wav = np.zeros_like(t)
    for _ in range(3):
        f0, glide = rng.uniform(100, 900), rng.uniform(-40, 40)
        wav += rng.uniform(0.05, 0.2) * np.sin(
            2 * np.pi * (f0 * t + glide * t * t / 2) + rng.uniform(0, 6))
    wav *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
    wav += rng.standard_normal(t.shape) * 0.01
    return wav.astype(np.float32)


def feature_rows(n_samples: int) -> int:
    """Rows the chunked extractor gives: (L - 80) // 320 frames, paired."""
    return (n_samples - 80) // 320 // 2


def hubert_phase(torch, seed: int, out: dict):
    """(a) HuBERT-large at full width, random weights from seed 0 in the
    JAX layout: the card against the CPU on a 4 s wav, the chunked path
    over a 65 s wav (streamed pieces against the one array), time per
    20 s chunk, the spread between two wavs, and that cuDNN's TF32 flag
    (on by default) leaves the features unchanged. Runs under PyTorch's
    default flags, as a user's process does."""
    from calipsync_tpu_torch.audio.hubert_pipeline import (
        CHUNK_LEN, HubertFeatureExtractor)
    from calipsync_tpu_torch.core.weights import (from_jax_hubert,
                                                  random_jax_hubert)
    from calipsync_tpu_torch.kernels.measure import max_err, tol_text
    from calipsync_tpu_torch.nn.hubert import HubertConfig

    cfg = HubertConfig.large()
    t0 = time.perf_counter()
    sd = from_jax_hubert(random_jax_hubert(cfg, seed=0), cfg)
    ex = HubertFeatureExtractor(sd, cfg)
    n_params = sum(p.numel() for p in ex.model.parameters())
    print(f"hubert-large: {cfg.num_hidden_layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, {n_params} "
          f"params (masked_spec_embed included), fp32, on {ex.device} "
          f"({time.perf_counter() - t0:.1f} s to make and load)")
    check(n_params == 315_438_720, f"{n_params} HuBERT params")

    short = tone_wav(4.0, seed)
    other = tone_wav(4.0, seed + 1)
    f_card = ex.extract(short)
    cpu = HubertFeatureExtractor(sd, cfg, device="cpu")
    f_cpu = cpu.extract(short)
    del cpu
    err, ok = max_err(torch.from_numpy(f_card), torch.from_numpy(f_cpu),
                      HUBERT_CPU_TOL)
    std = float(f_cpu.std())
    print(f"hubert 4 s wav: {f_card.shape} rows; card (fp32, default "
          f"flags) vs "
          f"CPU max abs err {err:.3g} ({tol_text(HUBERT_CPU_TOL)}), "
          f"features std {std:.4g}")
    check(f_card.shape == f_cpu.shape and np.isfinite(f_card).all(),
          "hubert features: shape or non-finite")
    check(ok, "hubert on the card disagrees with the CPU")
    f_other = ex.extract(other)
    spread = float(np.abs(f_card - f_other).mean()) / std
    print(f"hubert: two wavs' features differ by {spread:.3g} x std on "
          f"average (needs > {HUBERT_MIN_SPREAD})")
    check(spread > HUBERT_MIN_SPREAD, "hubert features ignore their input")

    # HuBERT's convs run as products (nn/hubert.py conv1d), so cuDNN's
    # TF32 flag, on by default, must not move the features
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not flag
    try:
        f_flipped = ex.extract(short)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    same = bool(np.array_equal(f_flipped, f_card))
    print(f"hubert with cuDNN's TF32 flag {not flag} against {flag}: "
          f"features equal: {same}")
    check(same, "cuDNN's TF32 flag moves HuBERT's features")

    long = tone_wav(65.0, seed)
    feats = ex.extract_auto(long)
    n_rows = feature_rows(len(long))
    streamed = np.concatenate(list(ex.extract_features_stream(long)))
    print(f"hubert 65 s wav, chunked (3 x 20 s + 5 s): {feats.shape}; "
          f"streamed pieces concatenate to it: "
          f"{bool(np.array_equal(streamed, feats))}")
    check(feats.shape == (n_rows, 2, 1024) and np.isfinite(feats).all(),
          f"65 s features {feats.shape}, expected {n_rows} rows")
    check(np.array_equal(streamed, feats),
          "streamed hubert pieces differ from the chunked array")
    norm = ex._normalized(long)[:CHUNK_LEN]
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        ex._forward_rows([norm])
        times.append((time.perf_counter() - t0) * 1e3)
    chunk_ms = float(np.median(times[1:]))
    print(f"hubert one 20 s chunk (bucket-padded to 22 s, fp32, convs as "
          f"products, host copies included): {chunk_ms:.2f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in times)})")
    out.update(hubert_cpu_max_abs_err=err, hubert_feature_std=std,
               hubert_two_wav_spread=spread,
               hubert_chunk_ms=chunk_ms, hubert_chunk_runs_ms=times)
    return ex, long, feats


def frame_hashes(synth):
    """Wrap synth.iterate_synthesized_frames to keep a hash of each frame
    (1624 full frames would take 1.1 GB)."""
    import hashlib

    hashes = []
    inner = synth.iterate_synthesized_frames

    def iterate(*args, **kwargs):
        for item in inner(*args, **kwargs):
            hashes.append(hashlib.sha1(item["frame"].tobytes()).hexdigest())
            yield item

    synth.iterate_synthesized_frames = iterate
    return hashes


def expect_forwards(counts: dict, what: str, forwards=None) -> int:
    """The launch counts are whole generator forwards (9/17/4 each), and
    as many as ``forwards`` when given; returns the number."""
    from calipsync_tpu_torch.kernels.measure import EXPECTED_PER_FORWARD

    n = counts["fused_ir"] // EXPECTED_PER_FORWARD["fused_ir"]
    print(f"{what}: launches {counts} = {n} generator forwards")
    check(n > 0 and counts == {k: c * n for k, c in
                               EXPECTED_PER_FORWARD.items()},
          f"{what}: launches {counts} are not whole forwards")
    if forwards is not None:
        check(n == forwards, f"{what}: {n} forwards, expected {forwards}")
    return n


def offline_phase(torch, ex, wav_path, n_wav, model, data, tmp, out):
    """(b) VideoStreamManager.process_single_file on the 65 s wav, bf16
    generator at B=128, bgr, in turns sequential, pipelined, pipelined,
    sequential: the mp4's frames and PCM track read back, the first
    pipelined run's frames equal to the first sequential run's (the two
    hashed runs hash each frame on the host, ~0.5 ms a frame); then each
    stage alone."""
    import cv2

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.media.mp4 import read_pcm_audio
    from calipsync_tpu_torch.pipelines.inference import VideoStreamManager

    n_rows = feature_rows(n_wav)
    forwards = -(-n_rows // BATCH)
    runs = {}
    for name, pipelined, hashed in (("sequential", False, True),
                                    ("pipelined", True, True),
                                    ("pipelined_2", True, False),
                                    ("sequential_2", False, False)):
        synth = FrameSynthesizer(None, data, model=model, batch_size=BATCH,
                                 seed=0, transfer_format="bgr")
        hashes = frame_hashes(synth) if hashed else None
        mgr = VideoStreamManager(synth, ex, pipelined=pipelined)
        path = os.path.join(tmp, f"{name}.mp4")
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = mgr.process_single_file(wav_path, path)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        synth.close()
        print(f"offline {name}{' (frames hashed)' if hashed else ''}: "
              f"{res['frames']} frames in {wall:.3f} s "
              f"({res['frames'] / wall:.2f} fps, featurize, synthesize, "
              f"encode and mux), ttff_s {res['ttff_s']}")
        expect_forwards(counts, f"offline {name}", forwards)
        cap = cv2.VideoCapture(path)
        n_read = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            check(frame.shape == (480, 480, 3), f"mp4 frame {frame.shape}")
            n_read += 1
        cap.release()
        rate, audio = read_pcm_audio(path)
        print(f"offline {name}: mp4 reads back {n_read} frames 480x480, "
              f"PCM track {len(audio)} samples at {rate} Hz")
        check(res["frames"] == n_read == n_rows
              and (hashes is None or len(hashes) == n_rows),
              f"offline {name}: {res['frames']} frames, {n_read} read "
              f"back, expected {n_rows}")
        check(rate == 24_000 and len(audio) == n_wav * 24_000 // 16_000,
              f"offline {name}: PCM track {len(audio)} at {rate} Hz")
        runs[name] = dict(wall_s=wall, ttff_s=res["ttff_s"],
                          frames=res["frames"], launches=counts,
                          hashes=hashes)
    same = runs["sequential"]["hashes"] == runs["pipelined"]["hashes"]
    print(f"offline: pipelined frames equal the sequential ones: {same}")
    check(same, "pipelined frames differ from the sequential ones")
    for r in runs.values():
        del r["hashes"]
    out["offline"] = runs
    out["offline_stages_s"] = offline_stages(ex, wav_path, model, data,
                                             runs, tmp)
    return {f"offline_{name}": r["launches"] for name, r in runs.items()}


def offline_stages(ex, wav_path, model, data, runs, tmp):
    """Each stage of the offline path alone, on the same inputs: HuBERT
    over the file, synthesis of its rows (frames consumed, not encoded),
    the mp4v encode of as many 480x480 frames, and the mux."""
    import glob

    import cv2

    from calipsync_tpu_torch.audio.io import mux_audio
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.media.video import open_video_writer

    t0 = time.perf_counter()
    feats = ex.extract_from_file(wav_path)
    featurize = time.perf_counter() - t0
    synth = FrameSynthesizer(None, data, model=model, batch_size=BATCH,
                             seed=0, transfer_format="bgr")
    t0 = time.perf_counter()
    for _ in synth.iterate_synthesized_frames(feats):
        pass
    synthesize = time.perf_counter() - t0
    synth.close()
    frames = [cv2.imread(p) for p in
              sorted(glob.glob(os.path.join(data, "frames", "*.jpg")))]
    path = os.path.join(tmp, "encode_only.mp4")
    t0 = time.perf_counter()
    writer = open_video_writer(path, 25, 480, 480)
    for i in range(len(feats)):
        writer.write(frames[i % len(frames)])
    writer.release()
    encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    mux_audio(path, wav_path, os.path.join(tmp, "mux_only.mp4"))
    mux = time.perf_counter() - t0
    stages = dict(featurize=featurize, synthesize=synthesize, encode=encode,
                  mux=mux)
    print("offline stages alone (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()) + f" (sum "
        f"{sum(stages.values()):.3f}; the runs above "
        + ", ".join(f"{r['wall_s']:.3f}" for r in runs.values()) + ")")
    return stages


def batch_invariance(model, data, feats, out):
    """A frame must not depend on the batch it was generated in: a 4-frame
    head batch against none, at HEAD_BATCH_MAX_LSB / _SHARE."""
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer

    def frames(features, head):
        synth = FrameSynthesizer(None, data, model=model, batch_size=BATCH,
                                 seed=0, transfer_format="bgr",
                                 first_batch_size=head)
        got = [it["frame"] for it in
               synth.iterate_synthesized_frames(features)]
        synth.close()
        return np.stack(got).astype(np.int16)

    def lsb(a, b):
        d = np.abs(a - b)
        return int(d.max()), float((d > 0).mean())

    rows = feats[:2 * BATCH]
    head_max, head_share = lsb(frames(rows, 0), frames(rows, 4))
    print(f"batch invariance ({len(rows)} frames, head batch 4 vs none): "
          f"max {head_max} uint8 levels, {head_share:.3g} of values differ "
          f"(limits {HEAD_BATCH_MAX_LSB} levels, {HEAD_BATCH_MAX_SHARE})")
    check(head_max <= HEAD_BATCH_MAX_LSB
          and head_share <= HEAD_BATCH_MAX_SHARE,
          "a frame depends on the batch it was generated in")
    out.update(head_batch_max_lsb=head_max, head_batch_share=head_share)


class _ReplaySequence:
    """A PingPongSequencer stand-in that walks recorded physical frames."""

    def __init__(self, phys):
        self.phys = list(phys)

    def next(self, needed: int) -> list:
        out, self.phys = self.phys[:needed], self.phys[needed:]
        return out


def record_calls(synth):
    """Keep each iterate call of ``synth``: its features, start index,
    sync flag, transfer format, physical frames and, in order, the packed
    rows of each device batch (the _Pending of _dispatch). ``done`` marks
    a call that ran to its end. Undo with ``del synth.<name>``."""
    calls = []
    iterate, dispatch = synth.iterate_synthesized_frames, synth._dispatch

    def recording_iterate(features, start_frame_idx=0,
                          is_generate_sync_frame=True, row_range=None):
        call = dict(features=np.array(features), start=start_frame_idx,
                    sync=is_generate_sync_frame, phys=[], batches=[],
                    done=False)
        calls.append(call)
        for item in iterate(features, start_frame_idx,
                            is_generate_sync_frame, row_range):
            call["format"] = synth._active_format  # the call's, by now
            call["phys"].append(item["physical_index"])
            yield item
        call["done"] = True

    def recording_dispatch(entries, *args, **kwargs):
        pending = dispatch(entries, *args, **kwargs)
        calls[-1]["batches"].append((pending, len(entries)))
        return pending

    synth.iterate_synthesized_frames = recording_iterate
    synth._dispatch = recording_dispatch
    return calls


def replay_plain(torch, calls, data, out):
    """Every streamed call that ran to its end, replayed through the plain
    versions (same features, physical frames, format, batch 8 and head
    batch 4): each device batch's packed rows within the serving step's
    bound (STREAM_PLAIN_MAX_SHARE of values beyond 1 uint8 level)."""
    from calipsync_tpu_torch.config import InferConfig
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.kernels.measure import random_generator

    icfg = InferConfig()
    plain = random_generator(torch.bfloat16, ops="plain")
    refs, beyond, total, worst, shapes = {}, 0, 0, 0, {}
    for call in (c for c in calls if c["done"] and c["batches"]):
        fmt = call["format"]
        if fmt not in refs:
            refs[fmt] = FrameSynthesizer(
                None, data, model=plain, batch_size=icfg.batch_size, seed=0,
                transfer_format=fmt,
                first_batch_size=icfg.first_window_batch)
        ref = refs[fmt]
        ref.sequencer = _ReplaySequence(call["phys"])
        got = record_calls(ref)
        for _ in ref.iterate_synthesized_frames(
                call["features"], call["start"], call["sync"]):
            pass
        del ref.iterate_synthesized_frames, ref._dispatch
        ref_batches = got[0]["batches"]
        check(len(ref_batches) == len(call["batches"]),
              "streaming replay: another batch partition")
        for (a, n), (b, m) in zip(call["batches"], ref_batches):
            a, b = a.numpy(), b.numpy()
            check(a.shape == b.shape and n == m,
                  "streaming replay: batch shapes")
            d = np.abs(a[:n].astype(np.int16) - b[:n].astype(np.int16))
            beyond += int((d > 1).sum())
            total += d.size
            worst = max(worst, int(d.max()))
            shapes[a.shape[0]] = shapes.get(a.shape[0], 0) + 1
    for r in refs.values():
        r.close()
    share = beyond / max(total, 1)
    print(f"streaming: the streamed device batches against the plain "
          f"versions (batches by padded size {shapes}, formats "
          f"{sorted(refs)}): "
          f"max {worst} uint8 levels, {share:.3g} of values beyond 1 "
          f"(limit {STREAM_PLAIN_MAX_SHARE})")
    check(set(shapes) == {icfg.batch_size, icfg.first_window_batch},
          f"streaming replay: batches of {sorted(shapes)} rows")
    check(share <= STREAM_PLAIN_MAX_SHARE,
          "streaming: frames disagree with the plain versions")
    out["streaming"].update(plain_max_lsb=worst, plain_share=share,
                            plain_batches_by_size=shapes)


def streaming_phase(torch, ex, model, data, tmp, seed, out):
    """(c) StreamingVideoManager with a NullPlayer over the serving
    defaults (InferConfig: batch 8, head batch 4, adaptive format, 1 s
    windows): warm-up of both formats, a 3 s wav and a 2 s 'danmu' wav,
    played in priority order one frame a feature row; each device batch
    of the session held against the plain versions."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.config import InferConfig
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.serve.players import NullPlayer
    from calipsync_tpu_torch.serve.stream_manager import \
        StreamingVideoManager

    icfg = InferConfig()
    synth = FrameSynthesizer(None, data, model=model,
                             batch_size=icfg.batch_size, seed=0,
                             transfer_format=icfg.transfer_format,
                             first_batch_size=icfg.first_window_batch)
    played = []
    player = NullPlayer(fps=icfg.fps, sample_rate=24_000,
                        on_frame=lambda item: played.append(item["audio"]))
    mgr = StreamingVideoManager(
        synth, ex, player, output_sample_rate=24_000, fps=icfg.fps,
        buffer_threshold=int(icfg.fps * icfg.buffer_threshold_s))
    t0 = time.perf_counter()
    mgr.warmup()
    warm_s = time.perf_counter() - t0
    paths = {}
    for name, seconds, s in (("normal", 3.0, seed + 2), ("danmu", 2.0,
                                                          seed + 3)):
        paths[name] = os.path.join(tmp, f"{name}.wav")
        save_wav(paths[name], tone_wav(seconds, s), 16_000)
    queued = {name: mgr.add_audio_to_queue(paths[name], queue_name=name)
              for name in ("normal", "danmu")}
    check(queued == {"normal": feature_rows(48_000),
                     "danmu": feature_rows(32_000)},
          f"queued frames {queued}")
    expected = [b.original_audio_chunk for name in ("danmu", "normal")
                for b in list(mgr.audio_queues[name].queue)]
    calls = record_calls(synth)
    kernels.reset_launches()
    t0 = time.perf_counter()
    mgr.start_playing()
    deadline = time.monotonic() + 60
    while len(played) < len(expected) and time.monotonic() < deadline:
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    mgr.stop_playing()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    marks = mgr.ttf_marks
    ttf_ms = (marks["uploaded"] - marks["producer_start"]) * 1e3
    print(f"streaming: warm-up {warm_s:.2f} s; {len(played)} frames played "
          f"in {wall:.2f} s ({queued}), time to first frame {ttf_ms:.2f} ms "
          f"(collected {1e3 * (marks['collected'] - marks['producer_start']):.2f}"
          f", synthesized {1e3 * (marks['synth_first'] - marks['producer_start']):.2f}"
          f"), format the bandit chose: {synth._active_format}, table "
          f"{synth._fmt_fps}, producer errors {mgr.producer_errors}")
    check(mgr.producer_errors == 0, "streaming producer errors")
    check(len(played) >= len(expected)
          and all(np.array_equal(a, b) for a, b in zip(played, expected)),
          "streaming: frames missing or out of priority order")
    expect_forwards(counts, "streaming")
    out["streaming"] = dict(warmup_s=warm_s, frames=len(played),
                            queued=queued, wall_s=wall, ttf_ms=ttf_ms,
                            chosen_format=synth._active_format,
                            fmt_fps={f"{k[0]}/{k[1]}": v
                                     for k, v in synth._fmt_fps.items()},
                            launches=counts)
    del synth.iterate_synthesized_frames, synth._dispatch
    replay_plain(torch, calls, data, out)
    del calls
    # what a host thread's first window costs: one window's first frame
    # on the manager's synthesis thread and on a fresh thread, in turns
    window = np.stack([b.hubert_feature for b in mgr._silence_window()])

    def first_frame_ms():
        t0 = time.perf_counter()
        for _ in synth.iterate_synthesized_frames(window):
            return (time.perf_counter() - t0) * 1e3

    same, fresh = [], []
    for _ in range(2):
        same.append(mgr._thread.submit(first_frame_ms).result())
        with ThreadPoolExecutor(max_workers=1) as pool:
            fresh.append(pool.submit(first_frame_ms).result())
    print(f"first frame of a {len(window)}-row window: on the manager's "
          f"synthesis thread {', '.join(f'{t:.2f}' for t in same)} ms, on "
          f"a fresh thread {', '.join(f'{t:.2f}' for t in fresh)} ms")
    out["streaming"].update(same_thread_first_ms=same,
                            fresh_thread_first_ms=fresh)
    mgr.close()
    synth.close()
    return counts


def cli_phase(torch, ex, data, tmp, seed, out):
    """(d) ``python -m calipsync_tpu_torch.cli infer`` in a subprocess on a
    2 s wav, with a reference-layout generator .pth and an HF-layout
    HuBERT-large directory written here, bf16 at B=128 by a config file."""
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  random_jax_generator)

    ckpt = os.path.join(tmp, "generator.pth")
    torch.save(from_jax_generator(random_jax_generator(seed=0)), ckpt)
    hub = os.path.join(tmp, "hubert")
    os.makedirs(hub)
    torch.save({k: v.cpu() for k, v in ex.model.state_dict().items()},
               os.path.join(hub, "pytorch_model.bin"))
    with open(os.path.join(hub, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(ex.config), f)
    cfg = os.path.join(tmp, "serve.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"dtype": "bfloat16"},
                   "infer": {"batch_size": BATCH}}, f)
    wav = os.path.join(tmp, "short.wav")
    save_wav(wav, tone_wav(2.0, seed + 4), 16_000)
    mp4 = os.path.join(tmp, "cli.mp4")
    cmd = [sys.executable, "-m", "calipsync_tpu_torch.cli", "infer",
           "--assets", data, "--ckpt", ckpt, "--hubert", hub, "--audio",
           wav, "--out", mp4, "--config", cfg, "--seed", "0"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"cli infer exited {proc.returncode}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cli infer (subprocess, {wall:.1f} s with start-up and loading "
          f"1.26 GB of HuBERT): {res}")
    check(os.path.exists(mp4) and os.path.getsize(mp4) > 0
          and res["frames"] == feature_rows(32_000)
          and res["device"].startswith("cuda"), "cli infer output")
    expect_forwards(res["kernel_launches"], "cli infer", 1)
    out["cli"] = dict(wall_s=wall, result=res)
    return res["kernel_launches"]


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


def audio_to_video(torch, seed: int, metrics: dict) -> dict:
    """Phases (a)-(d); returns the launch counts of each path that runs
    the generator, each read from counters set to 0 just before it."""
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker
    from calipsync_tpu_torch.kernels.measure import random_generator

    ex, long, feats = hubert_phase(torch, seed, metrics)
    model = random_generator(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_speaker(tmp, n_frames=40, res=480)
        wav = os.path.join(tmp, "speech65.wav")
        save_wav(wav, long, 16_000)
        paths = offline_phase(torch, ex, wav, len(long), model, data, tmp,
                              metrics)
        batch_invariance(model, data, feats, metrics)
        paths["streaming"] = streaming_phase(torch, ex, model, data, tmp,
                                             seed, metrics)
        paths["cli_infer"] = cli_phase(torch, ex, data, tmp, seed, metrics)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic wavs")
    args = ap.parse_args()
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
    # the kernels' fp32 checks hold true fp32 plain versions: TF32 off
    # until the audio phases
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
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
    paths = {"serve": counts}
    # the audio phases run under PyTorch's default flags, as the CLI does
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    paths.update(audio_to_video(torch, args.seed, metrics))

    kernels_line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = totals[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
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
