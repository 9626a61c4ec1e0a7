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

  7. trains (random weights, a synthetic step-1 speaker from --seed):
     (a) the attention's gradients through the kernel against autograd
     through its plain version at the training shape (B=16), fp32 with
     TF32 off and bf16, and forward + backward ms; (b) one full-width
     train step at B=16, kernels against plain versions: in fp32 with
     TF32 off every gradient leaf against the plain versions in fp64
     (kernels/measure.py grad_agreement); in fp32 and bf16 the attention
     projections' gradients against each block re-run through the plain
     version on the step's own inputs (measure.attention_grad_errors); (c)
     the resident bf16 step's ms (the first apart), peak memory, an epoch
     resident against streaming, then train_digital_model for two epochs
     (bf16, B=16, the perceptual term on) and a third resumed from its
     checkpoint, the loss falling; (d) ``python -m
     calipsync_tpu_torch.cli train`` in a subprocess for one epoch and its
     generator.pth served through the kernels; (f) K steps a dispatch
     (make_resident_multi_step, one CUDA graph of the resident step
     replayed a (K, B) block): a K=4 dispatch against 4 eager steps in
     bf16, in fp32 with TF32 off, and in bf16 with remat and with two
     microbatches a step (the eager steps with the graph's capturable
     Adam; the losses, weights and BatchNorm statistics
     within two eager runs' spread under deterministic algorithms, the
     weights within 2 lr K, in fp32 the statistics at rtol 1e-6), ms a
     step for eager steps and K = 4 and 8 over the same 64 steps with
     each graph's capture seconds, peak memory, busy share and the
     attention launches its replays ran (those in the profiler's trace
     against those counted), the eager step with a plain and a
     capturable Adam (ABBA), then step 2 with steps_per_dispatch 4
     (JAX's steps an epoch) preempted by SIGTERM and resumed.

  8. clones and serves many speakers (run before 7, with seeded weights;
     the face models compute their convs as fp32 products on the card,
     nn/product_conv.py): (a) S3FD (VGG16, 480x480 frames at scale 0.25),
     PFLD-GhostOne (deploy form, 192x192) and YOLOv8n-face (640
     letterbox), batch 16, on the card against the CPU: the raw heads
     (and cuDNN's TF32 flag moving nothing), the boxes after NMS, S3FD's
     top-k path against its full grid, the integer landmarks, each
     forward's ms; (b) steps 1 and 3 in-process on a 10 s synthetic video
     with HuBERT-large and bench_assets.write_face_weights (S3FD arranged
     to fire on every frame): frames/s, the directories whole, step 1's
     landmarks against a CPU run, then ``python -m calipsync_tpu_torch.cli
     clone`` in a subprocess (two bf16 epochs) and its stage seconds; (c)
     MultiStreamSynthesizer, 16 streams of 25-frame windows over the
     cloned speaker and a synthetic one, bf16 at B=128, bgr and yuv420:
     aggregate fps, realtime streams, a tick's wall and first frame, every
     device batch a whole forward, each stream's frames against a
     single-stream replay of its walk (the batch-invariance bound), one
     tick profiled.

  9. live output, under the default flags: (a) StreamingVideoManager
     (bf16 generator at the serving defaults, random HuBERT-large) into
     RTMPPlayer(backend='native') pushing FSV1 + 44.1 kHz PCM to
     MiniRTMPServer on 127.0.0.1 (in a process of its own): a 30 s wav
     at 480x480, held to real time (the median A/V drift of reads every
     50 ms within one frame, the median frame period within 1% of 40 ms;
     the largest gap between renders is attributed: render, starvation,
     garbage collection, or the whole process), and a 1.6 s wav (40
     frames) at 1080x1920, the serve command's default size, whose FSV1
     encode on the player's thread is slower than 25 fps on the card's
     host (measured, drift reported);
     each capture read back: one audio tag a video tag, video timestamps
     40 ms apart, every frame decoded by cv2 equal to the frame played
     after the player's resize; first frame, frame period, render ms,
     drift, a profiled second of the session after the wav, and the
     FSV1 encode alone at each size; (b) ``python -m
     calipsync_tpu_torch.cli serve --player rtmp`` in a subprocess on
     6d's checkpoints, a 1 s wav dropped into --watch, SIGINT once its
     frames and 3 more are captured, the capture checked, and the metrics
     its calipsync.serve log shows on stop (serve.frames = the frames
     uploaded); (c) the ffmpeg backend, where the machine has ffmpeg.
 10. evaluation, seeded SyncNet / VGG16 / AlexNet / LPIPS-head weights in
     the reference layouts: (a) SyncNet, card (TF32 flag on and off)
     against the CPU: the embeddings of step 3's lip crops at B=64 within
     1e-3 (TF32) / 1e-5 (fp32) of their unit norm, and the sync report of
     a 250-frame clip with a planted 3-frame shift (weights arranged to
     see it, bench_assets.planted_sync) within 1e-3, the planted offset
     found on both; (b) ``cli syncnet-train`` in a subprocess, two epochs
     over 8b's step 1, and a batch's host read alone; (c) ``sync-score``
     on the card and the CPU over the planted clip as lip-crop JPEGs and
     as an mp4; (d) LPIPS per frame, card against CPU
     within 1e-3 relative, and ``eval --lpips`` (frames/s); (e)
     generator_parity_report: the serving generator (kernels) in bf16
     and fp32 against the fp32 plain generator on the CPU (fp32 >= 60
     dB).
 11. tools: (a) ``cli cost`` at B=1 and 128, card against --device cpu
     (subprocesses), equal to the integer, and one count in process
     through the kernels; (b) the full-width generator exported with
     torch.export on the card (bf16 B=128, fp32 B=8), saved, loaded and
     run in a fresh subprocess: 9/17/4 launches a forward, fp32 within
     the repo's bar of eager, bf16 equal to eager, the three kernels in a
     profiling.trace of one loaded forward, export / load seconds and
     the loaded forward's ms against eager; (c) the CTC recognizer at
     wav2vec2-base-960h's width (bench_assets.write_ctc_dir, its head
     planted on a 30 s speech-like clip by bench_assets.planted_ctc):
     card logits against the CPU, the least top-2 margin 10x the largest
     difference, spans equal, ``cli slice --asr`` card against CPU, ms a
     clip and the real-time factor; (d) ``cli verify-weights`` over every
     seeded file (face weights with YOLO, generator, SyncNet, HuBERT-large,
     LPIPS, the recognizer), card against CPU, all ok; (e) LegacyLandmark
     with the seeded YOLOv8n-face keypoints and PFLD, card against CPU
     within 1 px, ms a frame.

 12. many cards (core/mesh.py; the card's compute mode must let two
     processes share it): (a) NCCL at world size 1 on this card, the
     production backend: build_mesh, FrameSynthesizer(mesh=) bgr and
     yuv420 at B=128, 256 frames equal to the unsharded ones, a DP step
     with sync-BN and a ZeRO-1 step (fp32, B=16) against the one-card
     step (the loss, BatchNorm statistics, weights within Adam's
     first-step envelope and 0.999 of them within 1e-6, every gradient
     leaf against fp64), and one K=4 resident DP dispatch (one CUDA
     graph replay, its NCCL all-reduces captured) against four per-step
     DP calls; (b) two gloo ranks spawned on this card
     (kernels built here first): FrameSynthesizer(mesh=) at B=128
     against one card at the batch-invariance bound, one
     MultiStreamSynthesizer(mesh=) tick (8 streams x 25 rows) likewise,
     DP steps in fp32 and bf16, 8 + 8 rows with sync-BN, against one card
     at B=16 (every gradient leaf against fp64 as close as the one-card
     step's, grad_agreement), ZeRO-1 against DP (0.999 of the weights
     within 1e-6) and half the Adam moments a rank, a K=2 resident DP
     dispatch (eager over gloo) against two per-step DP calls,
     HuBERT-large TP and PP
     on a 20 s chunk against one card at (a)'s tolerance, EP (8 experts
     of 1024x4096, 1000 tokens) against moe_ffn, and
     dryrun.run_sections(2) on the card; each rank's launches of the
     parallel paths, every kernel on every rank; each part's seconds, the
     DP step's ms and sharded serving's fps at 1 and 2 ranks.

Every path that runs the generator (4, the four runs of 6b, 6c, 6d, 7b,
7c, 7d, 7f, 8c, 9a, 9b, 10e, 11a, 11b, 12a, 12b) reads the launch
counters, set to 0 just before it, just after it, and must show whole forwards: 9/17/4 launches in eval
mode, 0/0/4 in train mode (the blocks run their plain modules; the
attention is the kernel), twice that with remat or two microbatches. A
CUDA graph's replays count the kernel launches their capture recorded
(kernels.note_replay; the kernels line's ``launches_in_graph_replays``),
and 7f holds that count to the profiler's trace of a replay.

Prints every phase's wall seconds, the card's name and power limit, a
{"kernels": [...]} line and,
last, {"ok": true, "device": {...}}. Exits non-zero, with no result line,
when CUDA is unavailable, when the port is not beside this script, or
when any phase fails. Per-launch details and every phase's numbers go to
chiprun_out/chip_smoke_detail.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import signal
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


# wall seconds of each phase, in the order they ran
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Records the wall seconds of the block as PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)


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
                                                     compute_only_fps,
                                                     random_generator,
                                                     timed_request)

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
            frames, wall, first, head_batch = timed_request(
                synths[fmt], feats, head_batch)
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
        dev = synth.device
        feats_dev = torch.from_numpy(feats).to(dev).to(model.dtype)
        metrics["compute_only_fps"] = compute_only_fps(synth, feats_dev,
                                                       timer)
        print(f"compute-only (device step, bgr, B={BATCH}): "
              f"{metrics['compute_only_fps']:.2f} fps")
        phys = torch.arange(BATCH, device=dev) % synth.total_frames
        idx = torch.arange(BATCH, device=dev)
        rows = synth._generate_resident_fns["bgr"](synth._crops_dev, phys,
                                                   feats_dev, idx)
        plain_step = make_generate_resident_fn(
            random_generator(torch.bfloat16, ops="plain"),
            synth.crop, "bgr")
        ref = plain_step(synth._crops_dev, phys, feats_dev, idx)
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
    busy share and the kernels with the most device time."""
    def request():
        for _ in synth.iterate_synthesized_frames(feats):
            pass

    return device_profile(torch, request, f"request (bgr, {len(feats)} "
                                          "frames)")


def device_profile(torch, fn, what: str):
    """``fn`` under torch.profiler: its wall time, the device's busy share
    (kernel time over wall time; one stream, so kernels do not overlap),
    the kernels with the most device time and each kernel's launches in
    the trace (``kernel_launches``, CUDA graph replays' included). The
    profiler slows the host, so the busy share it shows is an upper
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, spans, launches = [], [], {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                launches[e.key] = launches.get(e.key, 0) + e.count
            us = getattr(e, "self_device_time_total", None)
            if us is None:  # the attribute's name before torch 2.4
                us = e.self_cuda_time_total
            # a user annotation (Optimizer.step#Adam.step) spans its
            # kernels on the device timeline: not busy time of its own
            (spans if getattr(e, "is_user_annotation", False)
             else kernels).append((e.key, us / 1e3))
    kernels.sort(key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    if busy_ms == 0:
        print(f"profiled {what}: the profiler recorded no device time "
              "(device busy share not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                "kernel_launches": launches}
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of wall")
    for name, ms in kernels[:8]:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_kernels_ms": kernels[:20], "kernels_ms": kernels,
            "annotations_ms": spans, "kernel_launches": launches}


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
                          is_generate_sync_frame=True, row_range=None,
                          should_stop=None):
        call = dict(features=np.array(features), start=start_frame_idx,
                    sync=is_generate_sync_frame, phys=[], batches=[],
                    done=False)
        calls.append(call)
        for item in iterate(features, start_frame_idx,
                            is_generate_sync_frame, row_range, should_stop):
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


# --------------------------------------------------------------- training

TRAIN_BATCH = 16     # TrainConfig's default
TRAIN_FRAMES = 250   # the synthetic speaker: ~10 s of video
TRAIN_EPOCHS = 2     # then one more, resumed from the checkpoint
# the attention of a train step: (B, N, D, C)
TRAIN_ATTN = (TRAIN_BATCH, 100, 64, 512)
TRAIN_LAUNCHES = {"fused_ir": 0, "depthwise3x3": 0, "cross_attention": 4}


def attention_backward_phase(torch, timer, out):
    """(a) dq, dk and dv through the kernel (its forward, the plain
    backward) against autograd through cross_attention_plain at the
    training shape, fp32 with TF32 off then bf16, q and k at 0.2 so that
    the softmax is not one-hot; and forward + backward ms of each."""
    from calipsync_tpu_torch.kernels import cross_attention, measure
    from calipsync_tpu_torch.kernels.cross_attention import \
        cross_attention_plain

    b, n, d, c = TRAIN_ATTN
    rng = np.random.default_rng(5)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    q0, k0, v0, g0 = t((b, n, d), 0.2), t((b, n, d), 0.2), t((b, n, c)), \
        t((b, n, c))
    res = {}
    for dtype, tol in ((torch.float32, measure.TOL_GRAD_FP32),
                       (torch.bfloat16, measure.TOL_GRAD_BF16)):
        q, k, v = (x.to(dtype).requires_grad_() for x in (q0, k0, v0))
        g = g0.to(dtype)

        def run(fn):
            return torch.autograd.grad(fn(q, k, v), (q, k, v), g)

        before = cross_attention.launches
        ours = run(cross_attention)
        torch.cuda.synchronize()
        check(cross_attention.launches == before + 1,
              "attention backward: the kernel did not launch")
        ref = run(cross_attention_plain)
        errs = {}
        for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
            err, ok = measure.max_err(a, r, tol)
            print(f"attention {name} {str(dtype)[6:]} {TRAIN_ATTN}: kernel "
                  f"vs plain max abs err {err:.3g} ({measure.tol_text(tol)}"
                  f", grad rms {r.float().pow(2).mean().sqrt().item():.3g})")
            check(ok and a.dtype == dtype and a.shape == r.shape,
                  f"attention {name} {dtype}: kernel and plain disagree")
            errs[name] = err
        ms = timer.ms(lambda: run(cross_attention))
        plain_ms = timer.ms(lambda: run(cross_attention_plain))
        print(f"attention forward + backward {str(dtype)[6:]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        res[str(dtype)[6:]] = dict(max_abs_err=errs, ms=ms,
                                   plain_ms=plain_ms)
    out["attention_backward"] = res
    return res


def train_batch(seed: int):
    """A host batch of the training shape and a feature array, from seed."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, 256, (TRAIN_BATCH, 160, 160, 3),
                             dtype=np.uint8)
             for k in ("ref", "masked", "target")}
    batch["index"] = rng.integers(0, 64, TRAIN_BATCH).astype(np.int32)
    return batch, rng.standard_normal((64, 2, 1024)).astype(np.float32)


def train_step_phase(torch, out):
    """(b) One full-width train step (B=16, the perceptual term on, random
    weights with the attention gammas set), the same state and batch
    through the kernels and through the plain versions: in fp32 with TF32
    off, the loss and every gradient leaf against the plain versions in
    fp64 (kernels/measure.py grad_agreement); in fp32 and in bf16, the
    loss, and the attention projections' gradients against each block
    re-run through the plain version on the inputs and output gradient
    recorded in the kernels' step (measure.attention_grad_errors: in bf16
    the whole step's gradient is too far from fp64 to be compared with
    it). Each kernels step launches 4 attention kernels and no other
    (train mode runs the plain blocks)."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.config import TrainConfig
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  from_jax_vgg,
                                                  random_jax_generator,
                                                  random_jax_vgg)
    from calipsync_tpu_torch.kernels import measure
    from calipsync_tpu_torch.nn.blocks import PLAIN_OPS
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.nn.vgg import VGG19Features
    from calipsync_tpu_torch.train import trainer

    batch, feats = train_batch(6)
    sd = from_jax_generator(random_jax_generator(seed=0))
    vsd = from_jax_vgg(random_jax_vgg(seed=0))
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)

    def step(dtype, ops, params=torch.float32):
        model = Generator(dtype=dtype, ops=ops)
        model.load_state_dict(sd, strict=True)
        vgg = VGG19Features(dtype)
        vgg.load_state_dict(vsd, strict=True)
        state = trainer.create_train_state(model.to("cuda", params), tcfg)
        records, hooks = measure.record_attention(model)
        kernels.reset_launches()
        m = trainer.make_train_step(tcfg)(
            state, batch, torch.from_numpy(feats).to("cuda", params),
            vgg.to("cuda", params))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for h in hooks:
            h.remove()
        expected = TRAIN_LAUNCHES if ops == "kernels" else {
            k: 0 for k in TRAIN_LAUNCHES}
        check(counts == expected, f"train step {ops} {dtype}: launches "
                                  f"{counts}, expected {expected}")
        grads = {n: p.grad for n, p in model.named_parameters()}
        proj = (measure.attention_grad_errors(model, records, PLAIN_OPS)
                if ops == "kernels" else None)
        return float(m["loss"]), grads, counts, proj

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        l64, exact, _, _ = step(torch.float64, "plain", torch.float64)
        res, total = {}, {k: 0 for k in TRAIN_LAUNCHES}
        attn = [n for n in exact if ".cross_attention." in n
                and n.endswith("_conv.weight")]
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            lk, gk, counts, proj = step(dtype, "kernels")
            lp, gp, _, _ = step(dtype, "plain")
            total = {k: total[k] + counts[k] for k in total}
            name = str(dtype)[6:]
            print(f"train step {name} B={TRAIN_BATCH}: loss kernels "
                  f"{lk:.6f}, plain {lp:.6f}, plain fp64 {l64:.6f}")
            check(abs(lk - lp) <= rtol * abs(lp),
                  f"train step {name}: losses {lk} and {lp}")
            tol = measure.TOL_PROJ_GRAD[dtype]
            worst = max(proj.items(), key=lambda kv: kv[1])
            print(f"train step {name}: attention projections' gradients "
                  f"against each block re-run through the plain version: "
                  f"{len(proj)} leaves, worst {worst[0]} {worst[1]:.3g} "
                  f"(limit {tol:g} of the leaf's norm)")
            check(sorted(proj) == sorted(attn) and worst[1] <= tol,
                  f"train step {name}: the attention projections' "
                  f"gradients disagree with the plain version: {worst}")
            for n in attn:
                check(gk[n].abs().max().item() > 0,
                      f"train step {name}: no gradient for {n}")
            res[name] = dict(loss=lk, plain_loss=lp, proj_grad_errors=proj)
            if dtype != torch.float32:
                continue
            agree = measure.grad_agreement(gk, gp, exact)
            worst = max(agree["errors"].items(),
                        key=lambda kv: kv[1][0] / max(kv[1][1], 1e-12))
            print(f"train step {name}: {len(agree['errors'])} gradient "
                  f"leaves, rms relative error to fp64 kernels "
                  f"{agree['rms']:.3g}, plain {agree['rms_plain']:.3g}; "
                  f"worst leaf {worst[0]} {worst[1][0]:.3g} vs "
                  f"{worst[1][1]:.3g} (limits {measure.GRAD_LEAF_RATIO}x a "
                  f"leaf, {measure.GRAD_RMS_RATIO}x rms)")
            check(agree["ok"], f"train step {name}: gradients disagree: "
                               + "; ".join(agree["bad"][:5]))
            res[name].update(rms_err=agree["rms"],
                             plain_rms_err=agree["rms_plain"],
                             leaves=len(agree["errors"]),
                             worst_leaf=[worst[0], *worst[1]])
        res["fp64_loss"] = l64
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out["train_step"] = res
    return total


def train_timing(torch, data, base, vgg_path, out):
    """Step time of the resident bf16 step at B=16 with the perceptual
    term (each step synchronized; the first one apart: the train-mode
    shapes' cuDNN plans are built there), peak device memory, and one epoch
    each, resident and streaming (LipSyncDataset + Prefetcher into pinned
    memory, copied on this thread), one synchronize at the end."""
    import statistics

    from calipsync_tpu_torch.config import TrainConfig
    from calipsync_tpu_torch.data.dataset import (LipSyncDataset, Prefetcher,
                                                  ResidentLipSyncDataset,
                                                  batch_iterator, pin_memory)
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.nn.vgg import load_vgg19
    from calipsync_tpu_torch.train import trainer

    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    model = Generator(dtype=torch.bfloat16)
    model.load_state_dict(torch.load(base, weights_only=True), strict=True)
    state = trainer.create_train_state(model.cuda(), tcfg)
    vgg = load_vgg19(vgg_path, torch.bfloat16, "cuda")
    ds = ResidentLipSyncDataset(data, device="cuda")
    feats = torch.from_numpy(ds.audio_feats).cuda()
    step = trainer.make_resident_train_step(tcfg)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in ds.epoch_indices(TRAIN_BATCH, rng):
        t0 = time.perf_counter()
        step(state, ds.store, *b, feats, vgg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times[1:])
    b = next(ds.epoch_indices(TRAIN_BATCH, rng))
    profiled = device_profile(
        torch, lambda: step(state, ds.store, *b, feats, vgg),
        f"train step (bf16, B={TRAIN_BATCH})")
    adam = sum(ms for name, ms in profiled.get("kernels_ms", [])
               if "multi_tensor" in name)
    adam_span = sum(ms for name, ms in profiled.get("annotations_ms", [])
                    if name.startswith("Optimizer.step"))
    print(f"  Adam's update: its multi-tensor kernels {adam:.3f} ms, its "
          f"span on the device {adam_span:.3f} ms")

    def epoch(batches, fn):
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for b in batches:
            fn(b)
            n += TRAIN_BATCH
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    resident = epoch(ds.epoch_indices(TRAIN_BATCH, rng),
                     lambda b: step(state, ds.store, *b, feats, vgg))
    host_step = trainer.make_train_step(tcfg)
    with Prefetcher(batch_iterator(LipSyncDataset(data), TRAIN_BATCH, rng,
                                   drop_last=True),
                    depth=2, put_fn=pin_memory) as pf:
        streaming = epoch(pf, lambda b: host_step(state, b, feats, vgg))
    print(f"train step bf16 B={TRAIN_BATCH} (resident, perceptual on): "
          f"first {times[0]:.1f} ms, then median {step_ms:.2f} ms "
          f"({TRAIN_BATCH / step_ms * 1e3:.1f} samples/s; steps "
          f"{', '.join(f'{t:.1f}' for t in times[1:])}); peak device "
          f"memory {peak / 2**30:.3f} GiB; an epoch of {len(ds)} samples: "
          f"resident {resident:.1f} samples/s, streaming (host decode, 4 "
          f"threads) {streaming:.1f} samples/s")
    out["train_timing"] = dict(first_step_ms=times[0], step_ms=step_ms,
                               step_runs_ms=times, peak_bytes=peak,
                               resident_samples_per_s=resident,
                               streaming_samples_per_s=streaming,
                               profile=profiled, adam_ms=adam,
                               adam_span_ms=adam_span)


# the attention launches that CUDA graph replays ran, by path (a share of
# the path's launch counts)
REPLAYED: dict = {}
MULTI_K = 4            # 7f's equality block, 12a's dispatch
MULTI_KS = (4, 8)      # the timed dispatches
MULTI_STEPS = 64       # the steps each timing runs


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (a warning where an op has none), so that two eager
    runs of the same steps give the same bits. Under PyTorch's defaults
    they do not: the generator's bilinear upsample runs its backward with
    atomic adds (two eager runs of 4 fp32 steps differed by 9.1e-5 in
    the loss, H100 80GB HBM3, 700 W); in this mode it runs a
    decomposition whose backward is a sorted index_put. The timings run
    under the defaults."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         on, warn) = flags
        torch.use_deterministic_algorithms(on, warn_only=warn)


def within_spread(torch, got: dict, ref: dict, again: dict, what: str,
                  k: int, bn_rtol=None) -> dict:
    """A K-step dispatch (``got``) against K eager steps (``ref``), with
    a second eager run of the same steps (``again``) as the yardstick,
    all under :func:`deterministic`: each loss, every weight and every
    BatchNorm running statistic within the two eager runs' spread (0 when
    they agree to the bit), the weights also within Adam's sign-flip
    envelope, 2 lr K, and with ``bn_rtol`` the statistics within that
    bar of the eager run's (relative to the statistic plus its buffer's
    rms: running means sit near 0). Each dict: ``loss`` (K floats) and
    ``state`` (CPU state_dict)."""
    spread = max(abs(a - b) for a, b in zip(ref["loss"], again["loss"]))
    diff = max(abs(a - b) for a, b in zip(got["loss"], ref["loss"]))

    def worst(a, b, bn):
        w = 0.0
        for key, r in b["state"].items():
            if key.endswith("num_batches_tracked") or bn != key.endswith(
                    ("running_mean", "running_var")):
                continue
            r = r.double()
            d = (a["state"][key].double() - r).abs()
            if bn:
                d = d / (r.abs() + r.pow(2).mean().sqrt() + 1e-12)
            w = max(w, float(d.max()))
        return w

    weights, w_spread = worst(got, ref, False), worst(again, ref, False)
    bn, bn_spread = worst(got, ref, True), worst(again, ref, True)
    print(f"{what}: losses {', '.join(f'{x:.7f}' for x in got['loss'])}; "
          f"against {k} eager steps max diff {diff:.3g}, two eager runs "
          f"{spread:.3g}; weights max diff {weights:.3g} (two eager runs "
          f"{w_spread:.3g}, envelope {2 * MC_LR * k:g}); BatchNorm "
          f"statistics max relative diff {bn:.3g} (two eager runs "
          f"{bn_spread:.3g})")
    check(diff <= spread, f"{what}: losses {got['loss']} against the eager "
                          f"{ref['loss']}, beyond the eager spread {spread}")
    check(weights <= w_spread and weights <= 2 * MC_LR * k,
          f"{what}: weights {weights} from the eager run's, beyond the "
          f"eager spread {w_spread}")
    check(bn <= bn_spread and (bn_rtol is None or bn <= bn_rtol),
          f"{what}: BatchNorm statistics at {bn} relative, the eager "
          f"spread {bn_spread}")
    return dict(loss=got["loss"], eager_loss=ref["loss"], loss_diff=diff,
                eager_spread=spread, max_weight_diff=weights,
                weight_eager_spread=w_spread, bn_rel=bn,
                bn_rel_eager_spread=bn_spread)


def train_launches(tcfg) -> dict:
    """The kernels' launches of one train step under ``tcfg``: one
    forward per microbatch, and with ``remat`` its recompute in the
    backward."""
    n = tcfg.grad_accum * (2 if tcfg.remat else 1)
    return {name: c * n for name, c in TRAIN_LAUNCHES.items()}


def attention_in_trace(prof: dict) -> int:
    """The attention kernel's launches in a torch.profiler trace: the
    port's kernels in it (``calipsync::``), which on the train path are
    the attention's alone (TRAIN_LAUNCHES)."""
    return sum(n for name, n in prof.get("kernel_launches", {}).items()
               if "calipsync::" in name)


def index_pool(ds, n: int, seed: int) -> list:
    """``n`` index batches of TRAIN_BATCH, epoch after epoch."""
    rng = np.random.default_rng(seed)
    pool = []
    while len(pool) < n:
        pool.extend(ds.epoch_indices(TRAIN_BATCH, rng))
    return pool[:n]


def multi_step_phase(torch, data, base, vgg_path, out) -> dict:
    """(f) K steps a dispatch (train/trainer.py make_resident_multi_step,
    one CUDA graph of the resident step replayed a block), at the clone
    recipe (B=16, bf16, the perceptual term on), in fp32 with TF32 off, and
    at the recipe with remat and with grad_accum 2: one K=4 dispatch
    against 4 eager steps from the same state with the same (capturable)
    Adam update, under deterministic algorithms (within_spread; the
    BatchNorm statistics also at rtol 1e-6 in fp32); ms a step of eager steps and of K = 4 and 8 dispatches over
    the same 64 steps, each graph's capture seconds (warm-up included),
    peak device memory, the device's busy share under torch.profiler and
    the attention launches its replays ran, held to the profiler's trace;
    the eager step with Adam plain and capturable; then step2 with
    steps_per_dispatch 4 (multi_step_pipeline). Returns the launch counts
    of each path."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.config import TrainConfig
    from calipsync_tpu_torch.data.dataset import ResidentLipSyncDataset
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.nn.vgg import load_vgg19
    from calipsync_tpu_torch.pipelines.step2_train import dispatch_blocks
    from calipsync_tpu_torch.train import trainer

    res = out["multi_step"] = {}
    paths = {}
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    base_sd = torch.load(base, weights_only=True)
    ds = ResidentLipSyncDataset(data, device="cuda")
    feats = torch.from_numpy(ds.audio_feats).cuda()
    pool = index_pool(ds, MULTI_STEPS, 1)
    vggs = {}

    def fresh(dtype, cfg=tcfg):
        model = Generator(dtype=dtype)
        model.load_state_dict(base_sd, strict=True)
        if dtype not in vggs:
            vggs[dtype] = load_vgg19(vgg_path, dtype, "cuda")
        return trainer.create_train_state(model.cuda(), cfg), vggs[dtype]

    def snapshot(state):
        return {k: v.detach().float().cpu()
                for k, v in state.model.state_dict().items()}

    def eager(dtype, cfg, block):
        state, vgg = fresh(dtype, cfg)
        # the update a graph captures (a plain Adam's rounds otherwise)
        state.optimizer.make_capturable()
        step = trainer.make_resident_train_step(cfg)
        loss = [float(step(state, ds.store, *block[:, i], feats, vgg)[
            "loss"]) for i in range(block.shape[1])]
        return dict(loss=loss, state=snapshot(state))

    # equality: one K=4 dispatch against 4 eager steps, twice measured; the
    # clone recipe, fp32 with TF32 off, and the recipe with remat and with
    # two microbatches a step (each captured with its recompute or its
    # microbatches)
    block = dispatch_blocks(pool[:MULTI_K], MULTI_K)[0]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cases = (("bfloat16", torch.bfloat16, tcfg, None),
             ("float32", torch.float32, tcfg, 1e-6),
             ("bfloat16_remat", torch.bfloat16,
              dataclasses.replace(tcfg, remat=True), None),
             ("bfloat16_grad_accum2", torch.bfloat16,
              dataclasses.replace(tcfg, grad_accum=2), None))
    for name, dtype, cfg, bn_rtol in cases:
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with deterministic(torch):
                a, b = eager(dtype, cfg, block), eager(dtype, cfg, block)
                state, vgg = fresh(dtype, cfg)
                fn = trainer.make_resident_multi_step(cfg)
                kernels.reset_launches()
                m = fn(state, ds.store, *block, feats, vgg)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                got = dict(loss=m["loss"].tolist(), state=snapshot(state))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        check(fn.graphed and state.step == MULTI_K,
              f"7f {name}: graphed {fn.graphed}, step {state.step}")
        # the first dispatch: the warm-up's eager steps and one replay of
        # a graph that captured K steps' launches
        per_step = train_launches(cfg)
        want = {k: c * (trainer.GRAPH_WARMUP_STEPS + MULTI_K)
                for k, c in per_step.items()}
        check(counts == want and fn.graph.launches == {
            k: c * MULTI_K for k, c in per_step.items()},
            f"7f {name}: launches {counts}, captured {fn.graph.launches}; "
            f"expected {want}")
        paths[f"7f_first_dispatch_{name}"] = counts
        REPLAYED[f"7f_first_dispatch_{name}"] = \
            kernels.cross_attention.replayed
        res[f"equal_{name}"] = within_spread(
            torch, got, a, b, f"7f one K={MULTI_K} dispatch {name} B="
            f"{TRAIN_BATCH} (perceptual on), deterministic", MULTI_K, bn_rtol)
        del state, fn, m
        torch.cuda.empty_cache()

    # timing at the clone recipe: the same 64 steps each way
    def timed(k, capturable=False, profiled=True):
        state, vgg = fresh(torch.bfloat16)
        if capturable:
            state.optimizer.make_capturable()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if k == 1:
            fn = trainer.make_resident_train_step(tcfg)
            blocks = list(pool)
            t0 = time.perf_counter()
            fn(state, ds.store, *blocks[0], feats, vgg)  # cuDNN's plans
        else:
            fn = trainer.make_resident_multi_step(tcfg)
            blocks = dispatch_blocks(pool, k)
            t0 = time.perf_counter()
            fn(state, ds.store, *blocks[0], feats, vgg)  # warm-up, capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        for blk in blocks:
            fn(state, ds.store, *blk, feats, vgg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / MULTI_STEPS
        counts = kernels.launch_counts()
        replayed = kernels.cross_attention.replayed
        peak = torch.cuda.max_memory_allocated()
        check(counts == {n: c * MULTI_STEPS for n, c in
                         TRAIN_LAUNCHES.items()},
              f"7f K={k}: launches {counts} over {MULTI_STEPS} steps")
        out = dict(ms=ms, first_s=first_s, peak_bytes=peak,
                   launches=counts, replayed=replayed)
        if profiled:
            # 4 eager steps against one dispatch; the attention launches
            # in the trace (a replay's are the graph's kernel nodes) must
            # be those its wrapper counted: the captured count a replay
            n = max(k, MULTI_K)
            before = kernels.cross_attention.launches
            prof = device_profile(
                torch, lambda: [fn(state, ds.store, *blk, feats, vgg)
                                for blk in blocks[:n // k]],
                f"{n} steps, K={k} (bf16, B={TRAIN_BATCH})")
            counted = kernels.cross_attention.launches - before
            traced = attention_in_trace(prof)
            if k > 1:
                check(counted == fn.graph.launches["cross_attention"]
                      * (n // k), f"7f K={k}: {counted} attention launches "
                      f"counted, the graph captured "
                      f"{fn.graph.launches['cross_attention']}")
            check(traced == counted == TRAIN_LAUNCHES["cross_attention"] * n,
                  f"7f K={k}: the profiler traced {traced} attention "
                  f"launches over {n} steps, the wrapper counted {counted}")
            out.update(busy=prof.get("device_busy_share"),
                       traced_attention_launches=traced,
                       profile={k2: v for k2, v in prof.items()
                                if k2 != "kernels_ms"})
        del state, fn
        torch.cuda.empty_cache()
        return out

    timing = {k: timed(k) for k in (1,) + MULTI_KS}
    res["timing"] = timing
    for k, t in timing.items():
        busy = ("not measured" if t["busy"] is None
                else f"{t['busy']:.3f}")
        print(f"7f bf16 B={TRAIN_BATCH} K={k}: {t['ms']:.2f} ms a step over "
              f"{MULTI_STEPS} steps ({TRAIN_BATCH / t['ms'] * 1e3:.1f} "
              f"samples/s); {'first step' if k == 1 else 'capture'} "
              f"{t['first_s']:.2f} s; peak device memory "
              f"{t['peak_bytes'] / 2**30:.3f} GiB; device busy {busy}; "
              f"attention launches {t['launches']['cross_attention']} "
              f"({t['replayed']} of them in graph replays; in the "
              f"profiler's trace of {max(k, MULTI_K)} steps "
              f"{t['traced_attention_launches']}, as counted)")
        paths[f"7f_timed_k{k}"] = t["launches"]
        REPLAYED[f"7f_timed_k{k}"] = t["replayed"]
    # what a capturable Adam (its step count on the device, as a captured
    # optimizer's) costs an eager step: plain, capturable, capturable,
    # plain, each over the same 64 steps
    ab = {"plain": [timing[1]["ms"]], "capturable": []}
    for capturable in (True, True, False):
        t = timed(1, capturable=capturable, profiled=False)
        ab["capturable" if capturable else "plain"].append(t["ms"])
    res["eager_adam_ab_ms"] = ab
    print(f"7f eager bf16 B={TRAIN_BATCH} step, Adam plain against "
          f"capturable (ABBA, {MULTI_STEPS} steps each): plain "
          f"{', '.join(f'{x:.2f}' for x in ab['plain'])} ms, capturable "
          f"{', '.join(f'{x:.2f}' for x in ab['capturable'])} ms")
    paths.update(multi_step_pipeline(torch, data, base, vgg_path, pool,
                                     res))
    return paths


def multi_step_pipeline(torch, data, base, vgg_path, pool, res) -> dict:
    """step2 (train_digital_model) with steps_per_dispatch 4 on 7c's
    dataset (bf16, B=16, perceptual on): each epoch's steps, JAX's rule
    (the tail of n_batches % K dropped), and its mean loss over two
    epochs; then the same run preempted by a real SIGTERM after the first
    block of the second epoch (step2 checkpoints under that epoch, with
    the state after that block, and a resumed run redoes the epoch) and
    resumed, all under deterministic algorithms. The losses before the
    signal must be the uninterrupted run's, and the resumed epoch's those
    of the preempted run's live state carried on in this process over the
    same blocks (no checkpoint in between), each within 7f's bf16 eager
    spread."""
    import dataclasses

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.config import (ModelConfig, PipelineConfig,
                                            TrainConfig)
    from calipsync_tpu_torch.core import checkpoint as ckpt
    from calipsync_tpu_torch.pipelines import step2_train
    from calipsync_tpu_torch.train import trainer

    k = MULTI_K
    n_batches = TRAIN_FRAMES // TRAIN_BATCH
    per_epoch = n_batches // k * k  # JAX's rule
    cfg = PipelineConfig(model=ModelConfig(dtype="bfloat16"),
                         train=TrainConfig(batch_size=TRAIN_BATCH, epochs=2,
                                           steps_per_dispatch=k))
    real = step2_train.make_resident_multi_step
    calls = []  # (state, blocks, losses) of each dispatch

    def recording(trip_at=None):
        def make(*a, **kw):
            fn = real(*a, **kw)

            def step(state, store, idx, fidx, ex, feats, vgg):
                m = fn(state, store, idx, fidx, ex, feats, vgg)
                calls.append((state, np.stack([idx, fidx, ex]),
                              m["loss"].tolist(), feats, vgg, store))
                if len(calls) == trip_at:
                    signal.raise_signal(signal.SIGTERM)
                return m
            return step
        return make

    def run(save, trip_at=None, resume=False):
        losses = []
        step2_train.make_resident_multi_step = recording(trip_at)
        try:
            path = step2_train.train_digital_model(
                data, save, vgg_path=vgg_path, unet_checkpoint=base,
                cfg=cfg, loss_history=losses, log_every=0, resume=resume)
        finally:
            step2_train.make_resident_multi_step = real
        torch.cuda.synchronize()
        return path, losses

    spread = max(r["eager_spread"] for n, r in res.items()
                 if n.startswith("equal_bfloat16"))
    with tempfile.TemporaryDirectory() as tmp, deterministic(torch):
        kernels.reset_launches()
        t0 = time.perf_counter()
        path, whole = run(os.path.join(tmp, "whole"))
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        REPLAYED["7f_train_digital_model"] = kernels.cross_attention.replayed
        blocks_whole = [c[1] for c in calls]
        means = [float(np.mean(whole[i * per_epoch:(i + 1) * per_epoch]))
                 for i in range(2)]
        print(f"7f train_digital_model steps_per_dispatch {k}, bf16 B="
              f"{TRAIN_BATCH}: {n_batches} batches an epoch -> {per_epoch} "
              f"steps ({len(whole)} in 2 epochs, JAX's rule {per_epoch} an "
              f"epoch) in {wall:.1f} s; epoch mean losses "
              f"{', '.join(f'{x:.5f}' for x in means)}; launches {counts}")
        check(len(whole) == 2 * per_epoch and np.isfinite(whole).all(),
              f"7f step2: {len(whole)} losses")
        check(torch.load(path, weights_only=True)["step"] == 2 * per_epoch,
              "7f step2: the checkpoint's step count")
        check(counts["cross_attention"] == TRAIN_LAUNCHES["cross_attention"]
              * (2 * per_epoch + trainer.GRAPH_WARMUP_STEPS),
              f"7f step2: launches {counts}")
        # preempted after the first block of the second epoch, resumed
        calls.clear()
        trip = per_epoch // k + 1
        save = os.path.join(tmp, "preempted")
        path, _ = run(save, trip_at=trip)
        before = [x for c in calls for x in c[2]]
        live, _, _, feats, vgg, store = calls[-1]
        check(path.endswith("step_1.pt") and len(calls) == trip,
              f"7f preemption: {path} after {len(calls)} dispatches")
        d_before = max(abs(a - b) for a, b in zip(before, whole))
        # the live state carried on over the redone epoch's blocks
        fn = real(cfg.train, cfg.crop)
        carried = [x for blk in blocks_whole[per_epoch // k:]
                   for x in fn(live, store, *blk, feats, vgg)["loss"]
                   .tolist()]
        del fn, live
        calls.clear()
        torch.cuda.empty_cache()
        path, resumed = run(save, resume=True)
        check(path.endswith("step_2.pt") and torch.load(
            path, weights_only=True)["step"] == 2 * per_epoch + k,
            f"7f resume: {path}")
        check(all(np.array_equal(c[1], b) for c, b in
                  zip(calls, blocks_whole[per_epoch // k:])),
              "7f resume: the redone epoch drew other batches")
        d_after = max(abs(a - b) for a, b in zip(resumed, carried))
        print(f"7f preempted (SIGTERM) after dispatch {trip}, resumed: "
              f"{len(before)} losses before it against the uninterrupted "
              f"run's, max diff {d_before:.3g}; the redone epoch's "
              f"{len(resumed)} against the live state carried on, max diff "
              f"{d_after:.3g} (7f's bf16 eager spread {spread:.3g})")
        check(len(resumed) == per_epoch and d_before <= spread
              and d_after <= spread,
              "7f: preemption and resume moved the losses")
    calls.clear()
    res["pipeline"] = dict(steps_per_epoch=per_epoch, epoch_mean_loss=means,
                           wall_s=wall, launches=counts,
                           preempted_max_diff=d_before,
                           resumed_max_diff=d_after)
    return {"7f_train_digital_model": counts}


def train_pipeline_phase(torch, tmp, seed, out):
    """(c) train_digital_model on a synthetic step-1 speaker (250 frames
    of 480x480 from --seed), bf16, B=16, the perceptual term on with a
    random VGG19 .pth, warm-started from a random reference-layout .pth,
    resident, two epochs, then a third resumed from the checkpoint; (d)
    the CLI `train` in a subprocess for one epoch, its generator.pth then
    served through the kernels. Returns the launch counts of each."""
    import dataclasses

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.bench_assets import make_synthetic_step1
    from calipsync_tpu_torch.cli import load_generator
    from calipsync_tpu_torch.config import (ModelConfig, PipelineConfig,
                                            TrainConfig, load_config)
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  from_jax_vgg,
                                                  random_jax_generator,
                                                  random_jax_vgg)
    from calipsync_tpu_torch.kernels.measure import generator_inputs
    from calipsync_tpu_torch.pipelines.step2_train import (
        GENERATOR_FILE, train_digital_model)

    t0 = time.perf_counter()
    data = make_synthetic_step1(os.path.join(tmp, "step1"), TRAIN_FRAMES,
                                480, seed)
    base = os.path.join(tmp, "base.pth")
    base_sd = from_jax_generator(random_jax_generator(seed=0))
    torch.save(base_sd, base)
    vgg = os.path.join(tmp, "vgg19.pth")
    torch.save(from_jax_vgg(random_jax_vgg(seed=0)), vgg)
    print(f"synthetic step-1 speaker: {TRAIN_FRAMES} frames of 480x480 in "
          f"{time.perf_counter() - t0:.1f} s")
    train_timing(torch, data, base, vgg, out)
    with phase("7f K steps a dispatch"):
        paths = multi_step_phase(torch, data, base, vgg, out)

    cfg = PipelineConfig(model=ModelConfig(dtype="bfloat16"),
                         train=TrainConfig(batch_size=TRAIN_BATCH,
                                           epochs=TRAIN_EPOCHS))
    save = os.path.join(tmp, "run")
    steps = (TRAIN_FRAMES // TRAIN_BATCH)
    losses = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    train_digital_model(data, save, vgg_path=vgg, unet_checkpoint=base,
                        cfg=cfg, loss_history=losses, log_every=0)
    wall = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=TRAIN_EPOCHS + 1))
    t0 = time.perf_counter()
    path = train_digital_model(data, save, vgg_path=vgg,
                               unet_checkpoint=base, cfg=cfg, resume=True,
                               loss_history=losses, log_every=0)
    torch.cuda.synchronize()
    resumed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_epochs = TRAIN_EPOCHS + 1
    means = [float(np.mean(losses[i * steps:(i + 1) * steps]))
             for i in range(n_epochs)]
    print(f"train_digital_model bf16 B={TRAIN_BATCH}, {steps} steps an "
          f"epoch: {TRAIN_EPOCHS} epochs in {wall:.1f} s, the third "
          f"resumed in {resumed:.1f} s (set-up included); epoch mean "
          f"losses {', '.join(f'{m:.5f}' for m in means)}; launches "
          f"{counts}")
    check(len(losses) == n_epochs * steps and np.isfinite(losses).all(),
          f"train_digital_model: {len(losses)} losses, finite "
          f"{np.isfinite(losses).all()}")
    check(means[-1] < means[0], "train_digital_model: the loss did not "
                                "fall")
    check(path.endswith(f"step_{n_epochs}.pt"), f"checkpoint {path}")
    check(counts == {k: c * n_epochs * steps for k, c in
                     TRAIN_LAUNCHES.items()},
          f"train_digital_model: launches {counts}")
    trained = torch.load(os.path.join(save, GENERATOR_FILE),
                         weights_only=True)
    moved = max((trained[k] - base_sd[k]).abs().max().item()
                for k in trained if ".cross_attention." in k
                and k.endswith("_conv.weight"))
    check(moved > 0, "training did not move the attention projections")
    out["train_pipeline"] = dict(epoch_mean_loss=means, wall_s=wall,
                                 resumed_epoch_s=resumed, launches=counts,
                                 attention_weights_moved=moved)

    save_cli = os.path.join(tmp, "run_cli")
    cmd = [sys.executable, "-m", "calipsync_tpu_torch.cli", "train",
           "--data", data, "--save", save_cli, "--vgg", vgg, "--base", base,
           "--epochs", "1", "--dtype", "bfloat16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"cli train exited {proc.returncode}")
    printed = proc.stdout.strip().splitlines()[-1]
    check(printed == os.path.join(save_cli, GENERATOR_FILE),
          f"cli train printed {printed!r}")
    model = load_generator(printed, load_config(
        overrides={"model": {"dtype": "bfloat16"}})).cuda().eval()
    x, a = generator_inputs(8, seed=7)
    kernels.reset_launches()
    with torch.inference_mode():
        y = model(x, a)
        torch.cuda.synchronize()
    served = kernels.launch_counts()
    lo, hi, std = y.min().item(), y.max().item(), y.std().item()
    print(f"cli train (subprocess, one epoch, {cli_wall:.1f} s with "
          f"start-up): {printed}; served through the kernels: out in "
          f"[{lo:.4f}, {hi:.4f}], std {std:.4g}")
    expect_forwards(served, "cli train's generator.pth served", 1)
    check(bool(torch.isfinite(y).all()) and 0.0 < lo and hi < 1.0
          and std > 1e-3, "cli train's generator: output saturated")
    out["cli_train"] = dict(wall_s=cli_wall, out_min=lo, out_max=hi,
                            out_std=std)
    return {"train_digital_model": counts, "cli_train_served": served,
            **paths}


def training(torch, timer, seed: int, out: dict) -> dict:
    """The training phases (a)-(d); returns the launch counts of each path
    that runs the generator."""
    attention_backward_phase(torch, timer, out)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(train_pipeline_phase(torch, tmp, seed, out))
    paths["train_step"] = train_step_phase(torch, out)
    return paths


# ------------------------------- preprocessing and multi-stream serving

FACE_BATCH = 16
# Face models on the card under PyTorch's default flags against the CPU,
# (atol, atol per rms, rtol) as in kernels/measure.py: their convs run as
# fp32 products (nn/product_conv.py), so only the order of the sums
# differs, and cuDNN's TF32 flag must leave them bit-equal.
FACE_FP32_TOL = (0.0, 1e-4, 1e-4)
# Integer landmarks, card against the CPU: at most this many pixels apart
# on any frame (a truncation flips where a coordinate crosses an integer).
LANDMARK_MAX_PX = 1
# ... and on at most this share of the values (a fault that shifted every
# landmark by one pixel would pass the bound in pixels alone)
LANDMARK_MAX_SHARE = 1e-3
# Multi-stream serving: 16 streams of 25-frame windows over two speakers,
# the bf16 generator at B=128; one warm-up tick, then the timed ones.
MS_STREAMS = 16
MS_WINDOW = 25
MS_TICKS = 6
STEP_FRAMES = 250   # the 10 s synthetic video at 25 fps
# clip lengths (s) through HuBERT-large in one pass, until one runs out;
# the 5-minute clip must run
ONE_PASS_PROBE_S = (60, 120, 180, 240, 300, 360, 480, 540, 600, 720)
ONE_PASS_MIN_S = 300


def read_frames(path: str, n: int = 0) -> list:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while not n or len(frames) < n:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


class _FixedFaces:
    """A face detector stand-in: one box on the synthetic face, one past
    the frame's corner (its crop is border-padded)."""

    def detect(self, images):
        boxes = np.array([[110.0, 190.5, 190.0, 210.0],
                          [-40.0, 380.0, 150.0, 140.0]], np.float32)
        return [(boxes, [0, 1]) for _ in images]


@contextlib.contextmanager
def cudnn_tf32_flag(torch, on: bool):
    """cuDNN's TF32 flag set to ``on`` for the block (this script's
    measurement only; the port sets no flag)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _card_vs_cpu(torch, name, run, cpu_args, card_args, out):
    """``run`` (a callable of its args returning tensors) on the CPU and on
    the card, under the default flags and with cuDNN's TF32 off: the card
    within FACE_FP32_TOL of the CPU, and the flag moving nothing."""
    from calipsync_tpu_torch.kernels.measure import max_err, tol_text

    with torch.inference_mode():
        ref = [t.float() for t in run(*cpu_args)]
        got = [t.float().cpu() for t in run(*card_args)]
        with cudnn_tf32_flag(torch, False):
            off = [t.float().cpu() for t in run(*card_args)]
    errs = [max_err(g, r, FACE_FP32_TOL) for g, r in zip(got, ref)]
    moved = max((a - b).abs().max().item() for a, b in zip(got, off))
    out[name] = dict(max_abs_err=max(e for e, _ in errs), tf32_moves=moved)
    print(f"{name} card vs CPU: max abs err {out[name]['max_abs_err']:.3g} "
          f"over {len(ref)} outputs ({tol_text(FACE_FP32_TOL)}); cuDNN's "
          f"TF32 flag moves them by {moved:.3g}")
    check(all(ok for _, ok in errs), f"{name}: card and CPU disagree")
    check(moved == 0, f"{name}: cuDNN's TF32 flag moves the outputs")


def face_models_phase(torch, timer, seed: int, out: dict) -> None:
    """(8a) S3FD (full-width VGG16 on 480x480 frames at scale 0.25), PFLD-
    GhostOne (width 0.5, 192x192, deploy form) and YOLOv8n-face (640
    letterbox), batch 16, seeded weights, on the card against the CPU:
    raw heads, decoded boxes after NMS, the top-k path against the full
    grid, the integer landmarks (cuDNN's TF32 flag moving nothing, as the
    convs run as fp32 products), and each forward's ms a batch."""
    import cv2

    from calipsync_tpu_torch.bench_assets import (make_synthetic_video,
                                                  mean_face,
                                                  random_pfld_state,
                                                  random_state_dict)
    from calipsync_tpu_torch.nn import pfld, s3fd, yolo
    from calipsync_tpu_torch.vision.lip_detector import LipDetector

    res = out["faces"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        frames = read_frames(make_synthetic_video(
            os.path.join(tmp, "faces.mp4"), FACE_BATCH, 480,
            seed=seed + 20))
    cpu = torch.device("cpu")

    # S3FD: the face logits shifted 3 down, so a few hundred priors a
    # frame score above 0.05 and the top-k path serves every frame
    sd = random_state_dict(s3fd.S3FDBackbone(), seed + 21)
    for k in range(6):
        sd[f"conf.{k}.bias"][-1] -= 3.0
    det = {d: s3fd.S3FDDetector(sd, device=d) for d in ("cpu", "cuda")}
    scaled = np.stack([det["cpu"]._scaled(f) for f in frames])
    mean = torch.from_numpy(s3fd.S3FD_MEAN_BGR)
    x = torch.from_numpy(scaled).float() - mean
    _card_vs_cpu(torch, "s3fd", lambda m, x: m(x),
                 (det["cpu"].model, x), (det["cuda"].model, x.cuda()), res)
    with torch.inference_mode():
        xd = x.cuda()
        res["s3fd"]["ms"] = timer.ms(lambda: det["cuda"].model(xd))
    ref = det["cpu"].detect(frames)
    got = det["cuda"].detect(frames)
    full = s3fd.S3FDDetector(sd, device="cuda", topk_device=0).detect(frames)
    check(not det["cuda"]._topk_sticky_off,
          "s3fd: the top-k path fell back to the full grid")
    n_boxes = 0
    for (rb, ri), (ob, oi), (fb, fi) in zip(ref, got, full):
        check(oi == ri and ob.shape == rb.shape
              and np.allclose(ob, rb, rtol=1e-4, atol=1e-2),
              "s3fd: decoded boxes, card vs CPU")
        check(oi == fi and np.array_equal(ob, fb),
              "s3fd: the top-k path and the full grid disagree")
        n_boxes += len(rb)
    check(n_boxes > 0, "s3fd: no box to compare")
    print(f"s3fd: {n_boxes} boxes after NMS on {len(frames)} frames: card "
          f"= CPU within 0.01 px, top-k = full grid; forward "
          f"{res['s3fd']['ms']:.3f} ms a batch of {FACE_BATCH} "
          f"({scaled.shape[1]}x{scaled.shape[2]})")
    res["s3fd"]["boxes"] = n_boxes
    del det

    # PFLD, deploy form, on the frames' face crops
    folded = pfld.fold_mobileone(random_pfld_state(seed + 22))
    lips = {d: LipDetector(folded, mean_face(seed), _FixedFaces(), device=d)
            for d in ("cpu", "cuda")}
    crops = np.stack([cv2.resize(f[190:400, 110:300], (192, 192))
                      for f in frames])
    xc = torch.from_numpy(crops).float() / 255.0
    _card_vs_cpu(torch, "pfld", lambda m, x: [m(x)],
                 (lips["cpu"].model, xc), (lips["cuda"].model, xc.cuda()),
                 res)
    with torch.inference_mode():
        xcd = xc.cuda()
        res["pfld"]["ms"] = timer.ms(lambda: lips["cuda"].model(xcd))
    ref = lips["cpu"].detect_landmarks(frames)
    moved = {}
    for mode, flag in (("default_flags", None), ("tf32_off", False)):
        with (contextlib.nullcontext() if flag is None
              else cudnn_tf32_flag(torch, flag)):
            got = lips["cuda"].submit(frames).result()
        d = np.concatenate([np.abs(a.astype(np.int64) - b).ravel()
                            for r, g in zip(ref, got) for a, b in zip(r, g)])
        moved[mode] = (int(d.max()), int((d > 0).sum()), d.size)
    for lip in lips.values():
        lip.close()
    print(f"pfld: integer landmarks, card vs CPU over {len(frames)} frames "
          f"(2 faces each): default flags max {moved['default_flags'][0]} "
          f"px on {moved['default_flags'][1]} of "
          f"{moved['default_flags'][2]} values, TF32 off max "
          f"{moved['tf32_off'][0]} px on {moved['tf32_off'][1]}; forward "
          f"{res['pfld']['ms']:.3f} ms a batch of {FACE_BATCH} (limit "
          f"{LANDMARK_MAX_PX} px on {LANDMARK_MAX_SHARE} of the values)")
    check(max(m[0] for m in moved.values()) <= LANDMARK_MAX_PX,
          f"pfld: card and CPU landmarks over {LANDMARK_MAX_PX} px apart")
    check(all(m[1] <= LANDMARK_MAX_SHARE * m[2] for m in moved.values()),
          f"pfld: card and CPU landmarks differ on over "
          f"{LANDMARK_MAX_SHARE} of the values")
    res["pfld"]["landmarks_moved"] = moved

    # YOLOv8n-face: the class logits shifted so that ~20 anchors an image
    # score above the threshold (random weights put thousands there, and
    # NMS over near-equal scores would flip on the last bit)
    sd = random_state_dict(yolo.YoloV8Face(), seed + 23)
    canvases = np.stack([yolo.letterbox(np.ascontiguousarray(f[..., ::-1]),
                                        640)[0] for f in frames])
    xy = torch.from_numpy(canvases).float() / 255.0
    net = yolo.YoloV8Face().eval()
    net.load_state_dict(sd)
    with torch.inference_mode():
        logits = torch.cat([o[1].reshape(-1) for o in net(xy[:2])])
    shift = (torch.quantile(logits, 1 - 20 / (logits.numel() / 2)).item()
             - np.log(0.1 / 0.9))
    for i in range(3):
        sd[f"model.22.cv3.{i}.2.bias"] -= shift
    kw = dict(conf_threshold=0.1, batch_size=FACE_BATCH)
    det = {d: yolo.YoloV8FaceDetector(sd, device=d, **kw)
           for d in ("cpu", "cuda")}

    def heads(m, x):
        return [t for o in m(x) for t in o]

    _card_vs_cpu(torch, "yolo", heads, (det["cpu"].model, xy),
                 (det["cuda"].model, xy.cuda()), res)
    with torch.inference_mode():
        xyd = xy.cuda()
        res["yolo"]["ms"] = timer.ms(lambda: det["cuda"].model(xyd))
    ref = det["cpu"].detect(frames)
    got = det["cuda"].detect(frames)
    n_boxes = 0
    for (rb, ri), (ob, oi) in zip(ref, got):
        check(oi == ri and ob.shape == rb.shape
              and np.allclose(ob, rb, rtol=1e-4, atol=1e-2),
              "yolo: decoded boxes, card vs CPU")
        n_boxes += len(rb)
    check(n_boxes > 0, "yolo: no box to compare")
    print(f"yolo: {n_boxes} boxes after NMS on {len(frames)} frames, card = "
          f"CPU within 0.01 px; forward {res['yolo']['ms']:.3f} ms a batch "
          f"of {FACE_BATCH} (640x640)")
    res["yolo"]["boxes"] = n_boxes


def write_hubert_dir(torch, ex, path: str) -> str:
    """The extractor's HuBERT in the HF layout (config.json and
    pytorch_model.bin)."""
    os.makedirs(path)
    torch.save({k: v.cpu() for k, v in ex.model.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(ex.config), f)
    return path


def _count(path: str, ext: str) -> int:
    return sum(f.endswith(ext) for f in os.listdir(path))


def preprocess_phase(torch, ex, tmp: str, seed: int, out: dict) -> str:
    """(8b) Step 1 and step 3 in-process on the card over a 10 s synthetic
    480x480 video, random HuBERT-large and the seeded face weights of
    bench_assets.write_face_weights (S3FD arranged to fire on every
    frame); the card's step-1 landmarks against a CPU run of the same
    weights; then ``python -m calipsync_tpu_torch.cli clone`` in a
    subprocess. Returns the cloned speaker's infer_data."""
    from calipsync_tpu_torch.bench_assets import (make_synthetic_video,
                                                  write_face_weights)
    from calipsync_tpu_torch.cli import build_lip_detector
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor
    from calipsync_tpu_torch.pipelines.step3_prepare import \
        InferPreprocessor
    from calipsync_tpu_torch.vision.geometry import load_landmarks

    res = out["preprocess"] = {}
    video = make_synthetic_video(os.path.join(tmp, "speaker.mp4"),
                                 STEP_FRAMES, 480, seed=seed + 30)
    weights = write_face_weights(os.path.join(tmp, "weights"), seed=seed)
    hub = write_hubert_dir(torch, ex, os.path.join(tmp, "hubert8"))
    lip = build_lip_detector(weights)
    frames = read_frames(video, 64)
    check(all(r is not None for r in lip.detect_landmarks(frames)),
          "the face detector did not fire on every frame")

    s1 = os.path.join(tmp, "step1")
    t0 = time.perf_counter()
    r1 = TrainPreprocessor(lip, ex).process_video(video, s1)
    res["step1_s"] = time.perf_counter() - t0
    res["step1_fps"] = STEP_FRAMES / res["step1_s"]
    feats = np.load(os.path.join(s1, "aud_hu.npy"))
    counts = {sub: _count(os.path.join(s1, sub), ext) for sub, ext in (
        ("full_body_img", ".jpg"), ("landmarks", ".lms"), ("faces", ".jpg"))}
    check(r1["total_frames"] == STEP_FRAMES
          and set(counts.values()) == {STEP_FRAMES},
          f"step 1: {r1['total_frames']} frames, files {counts}")
    check(os.path.exists(os.path.join(s1, "aud.wav"))
          and feats.shape == (ex.config.num_frames(
              16_000 * STEP_FRAMES // 25) // 2, 2, ex.config.hidden_size)
          and np.isfinite(feats).all(),
          f"step 1: aud.wav, or aud_hu.npy of {feats.shape}")
    print(f"step 1 (card): {STEP_FRAMES} frames in {res['step1_s']:.2f} s = "
          f"{res['step1_fps']:.2f} frames/s; aud_hu {feats.shape}")
    cpu_lip = build_lip_detector(weights, device="cpu")
    ref = cpu_lip.detect_landmarks(frames)
    cpu_lip.close()
    d = np.concatenate([np.abs(load_landmarks(os.path.join(
        s1, "landmarks", f"{i}.lms")).astype(np.int64) - r[0]).ravel()
        for i, r in enumerate(ref)])
    print(f"step 1: landmarks of {len(frames)} frames, card vs CPU: max "
          f"{int(d.max())} px on {int((d > 0).sum())} of {d.size} values "
          f"(limit {LANDMARK_MAX_PX} px on {LANDMARK_MAX_SHARE} of the "
          f"values, from 8a)")
    check(int(d.max()) <= LANDMARK_MAX_PX
          and int((d > 0).sum()) <= LANDMARK_MAX_SHARE * d.size,
          "step 1: card and CPU landmarks disagree")
    res["step1_landmarks_max_px"] = int(d.max())

    s3 = os.path.join(tmp, "step3")
    t0 = time.perf_counter()
    r3 = InferPreprocessor(lip).process_video(video, s3)
    res["step3_s"] = time.perf_counter() - t0
    res["step3_fps"] = STEP_FRAMES / res["step3_s"]
    infer = os.path.join(s3, "infer_data")
    counts = {sub: _count(os.path.join(infer, sub), ext) for sub, ext in (
        ("frames", ".jpg"), ("positions", ".txt"), ("lips_jpg", ".jpg"))}
    check(r3["processed_frames"] == STEP_FRAMES
          and set(counts.values()) == {STEP_FRAMES}
          and os.path.exists(os.path.join(s3, "sample.jpg")),
          f"step 3: {r3['processed_frames']} frames, files {counts}")
    print(f"step 3 (card): {STEP_FRAMES} frames in {res['step3_s']:.2f} s = "
          f"{res['step3_fps']:.2f} frames/s")
    lip.close()

    cfg = os.path.join(tmp, "clone.json")
    with open(cfg, "w") as f:
        json.dump({"train": {"batch_size": 16}}, f)
    models = os.path.join(tmp, "models")
    cmd = [sys.executable, "-m", "calipsync_tpu_torch.cli", "clone",
           "--video", video, "--out", models, "--weights", weights,
           "--hubert", hub, "--epochs", "2", "--config", cfg]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"cli clone exited {proc.returncode}")
    cl = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cli clone (subprocess, {wall:.1f} s with start-up and loading "
          f"HuBERT-large): stage seconds {cl['timings']}")
    Generator().load_state_dict(torch.load(cl["generator"],
                                           weights_only=True), strict=True)
    check(_count(os.path.join(cl["infer_data"], "frames"), ".jpg")
          == STEP_FRAMES and not os.path.exists(os.path.join(
              models, cl["model_id"], "full_body_img")),
          "cli clone: the inference assets are not whole")
    res["clone"] = dict(wall_s=wall, timings=cl["timings"])
    return cl["infer_data"]


def multistream_phase(torch, speakers, seed: int, out: dict) -> dict:
    """(8c) MultiStreamSynthesizer: 16 streams of 25-frame windows over
    two speakers (one cloned in 8b), the bf16 generator at B=128, bgr and
    yuv420: aggregate fps, realtime streams, a tick's wall time and first
    frame, every device batch a whole forward; each stream's frames of
    the first two ticks against a single-stream FrameSynthesizer replay
    of its walk; one tick under torch.profiler."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.kernels.measure import (multistream_ticks,
                                                     random_generator)
    from calipsync_tpu_torch.serve.multi_stream import MultiStreamSynthesizer

    model = random_generator(torch.bfloat16)
    rng = np.random.default_rng(seed + 40)
    ids = [f"s{i}" for i in range(MS_STREAMS)]
    ticks = [{sid: rng.standard_normal((MS_WINDOW, 2, 1024)).astype(
        np.float32) for sid in ids} for _ in range(MS_TICKS + 2)]
    per_tick = -(-MS_STREAMS * MS_WINDOW // BATCH)
    res = out["multistream"] = {}
    paths = {}
    for fmt in ("bgr", "yuv420"):
        ms = MultiStreamSynthesizer(None, speakers, model=model,
                                    batch_size=BATCH, transfer_format=fmt)
        for i, sid in enumerate(ids):
            ms.add_stream(sid, speaker=i % 2)
        outs = [ms.synthesize_windows(ticks[0])]  # warm-up
        kernels.reset_launches()
        timed, walls, firsts = multistream_ticks(ms,
                                                 ticks[1:MS_TICKS + 1])
        outs += timed
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        expect_forwards(counts, f"multistream {fmt}", MS_TICKS * per_tick)
        paths[f"multistream_{fmt}"] = counts
        for o in outs:
            check(all(len(o[sid]) == MS_WINDOW
                      and o[sid][0]["frame"].dtype == np.uint8
                      and o[sid][0]["frame"].shape == (480, 480, 3)
                      for sid in ids), f"multistream {fmt}: frames")
        fps = MS_TICKS * MS_STREAMS * MS_WINDOW / sum(walls)
        prof = device_profile(torch, lambda: ms.synthesize_windows(
            ticks[-1]), f"multistream tick ({fmt}, {MS_STREAMS} streams)")

        worst, changed, total = 0, 0, 0
        solos = [FrameSynthesizer(None, d, model=model, batch_size=BATCH,
                                  transfer_format=fmt) for d in speakers]
        for i, sid in enumerate(ids):
            solo = solos[i % 2]
            solo.sequencer = _ReplaySequence(
                x["physical_index"] for o in outs[:2] for x in o[sid])
            for k, o in enumerate(outs[:2]):
                got = list(solo.iterate_synthesized_frames(
                    ticks[k][sid], k * MS_WINDOW))
                check([g["index"] for g in got]
                      == [x["index"] for x in o[sid]],
                      f"multistream {fmt}: logical indices")
                for g, x in zip(got, o[sid]):
                    dd = np.abs(g["frame"].astype(np.int16)
                                - x["frame"].astype(np.int16))
                    worst = max(worst, int(dd.max()))
                    changed += int((dd > 0).sum())
                    total += dd.size
        for s in solos:
            s.close()
        ms.close()
        share = changed / total
        row = dict(fps=fps, realtime_streams=fps / 25,
                   tick_ms=float(np.median(walls)) * 1e3,
                   first_frame_ms=float(np.median(firsts)) * 1e3,
                   tick_ms_all=[w * 1e3 for w in walls],
                   replay_max_lsb=worst, replay_share=share,
                   device_busy_share=prof.get("device_busy_share"),
                   launches=counts)
        res[fmt] = row
        print(f"multistream {fmt}: {MS_STREAMS} streams x {MS_WINDOW} "
              f"frames, {per_tick} device batches a tick: {fps:.2f} fps = "
              f"{fps / 25:.2f} realtime streams; tick {row['tick_ms']:.2f} "
              f"ms (first frame {row['first_frame_ms']:.2f} ms); against "
              f"single-stream replays max {worst} levels, {share:.3g} of "
              f"values differ (limits {HEAD_BATCH_MAX_LSB}, "
              f"{HEAD_BATCH_MAX_SHARE})")
        check(worst <= HEAD_BATCH_MAX_LSB and share <= HEAD_BATCH_MAX_SHARE,
              f"multistream {fmt}: frames differ from the single-stream "
              "path")
    return paths


def one_pass_limit(torch, ex, seed: int, out: dict) -> None:
    """The longest clip step 1's ``long_audio='one_pass'`` takes: HuBERT-
    large over the whole clip in one forward, its fp32 scores (16, T, T)
    a layer, at ONE_PASS_PROBE_S until the card runs out of memory (the
    default 'auto' chunks beyond 20 s)."""
    rng = np.random.default_rng(seed + 50)
    ok = []
    for seconds in ONE_PASS_PROBE_S:
        wav = rng.standard_normal(16_000 * seconds).astype(np.float32)
        try:
            t0 = time.perf_counter()
            rows = ex.extract(wav)
            ok.append((seconds, time.perf_counter() - t0))
            check(rows.shape[0] == ex.config.num_frames(len(wav)) // 2,
                  "one_pass rows")
        except torch.cuda.OutOfMemoryError:
            break
        finally:
            del wav
            torch.cuda.empty_cache()
    longest = ok[-1][0] if ok else 0
    print(f"one_pass HuBERT-large: clips of {[s for s, _ in ok]} s ran "
          f"({', '.join(f'{t:.2f}' for _, t in ok)} s each); "
          + (f"{ONE_PASS_PROBE_S[len(ok)]} s ran out of memory"
             if len(ok) < len(ONE_PASS_PROBE_S) else "no probe ran out"))
    out["preprocess"]["one_pass_longest_s"] = longest
    out["preprocess"]["one_pass_s"] = ok
    check(longest >= ONE_PASS_MIN_S,
          f"one_pass: a {ONE_PASS_MIN_S} s clip did not run")


def preprocess_and_serve(torch, ex, timer, seed: int, out: dict,
                         tmp: str) -> tuple:
    """Phases (8a)-(8c) in ``tmp``; returns the launch counts of the
    multi-stream paths and 8b's directories (step 1, step 3's lip crops
    and step 1's features) for the evaluation phases."""
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker

    os.makedirs(tmp)
    face_models_phase(torch, timer, seed, out)
    cloned = preprocess_phase(torch, ex, tmp, seed, out)
    one_pass_limit(torch, ex, seed, out)
    other = make_synthetic_speaker(os.path.join(tmp, "speaker2"),
                                   n_frames=40, res=480)
    clone = dict(step1=os.path.join(tmp, "step1"),
                 feats=os.path.join(tmp, "step1", "aud_hu.npy"),
                 lips=os.path.join(tmp, "step3", "infer_data", "lips_jpg"))
    return multistream_phase(torch, [other, cloned], seed, out), clone


# ---------------------------------------------------------- live output

# (width, height, seconds of audio, held to real time): the real-time
# session at the size of the JAX package's RTMP soak, then the serve
# command's default size, where the FSV1 encode (zlib level 1 of 6.2 MB a
# frame on the player's thread) is slower than 25 fps on the card's host:
# 40 frames, enough for its render and period means, are measured and
# its drift reported, not held
LIVE_SESSIONS = ((480, 480, 30.0, True), (1080, 1920, 1.6, False))
# held to real time: the median A/V drift within one frame period, and the
# median frame period within 1% of 40 ms (a render 1% slower than real
# time fails it). The mean period and how far the wav's last frame went
# out behind its media time are reported, not held: one stall of 262-482
# ms with the frame ready (a full garbage collection stopping every
# thread, where attributed) put 3 of 5 H100 runs 236-465 ms behind, and
# the player re-anchors on a stall by design rather than bursting to
# catch up
LIVE_MAX_DRIFT_S = 0.04
LIVE_MAX_PERIOD_MS = 40.0 * 1.01
SERVE_WAV_SECONDS = 1.0
SERVE_IDLE_FRAMES = 3          # captured after the wav's before SIGINT
SERVE_W, SERVE_H = 1080, 1920  # the serve command's defaults


def _ingest(capture: str, conn, n_video) -> None:
    """The child process of :class:`Ingest`."""
    from calipsync_tpu_torch.media.flv import TAG_VIDEO
    from calipsync_tpu_torch.media.rtmp import MiniRTMPServer

    def on_tag(typ, ts, body):
        if typ == TAG_VIDEO:
            with n_video.get_lock():
                n_video.value += 1

    server = MiniRTMPServer(capture, on_tag=on_tag)
    conn.send(server.url)
    server.finished.wait()
    conn.send(repr(server.error) if server.error else None)


class Ingest:
    """MiniRTMPServer (the port's loopback ingest) in a child process, as a
    real ingest runs outside the pusher's process: its Python chunk
    parsing (~100-750 chunks a frame) then takes no GIL time from the
    player's thread. ``n_video`` counts the video tags received so far;
    the capture is written to ``capture_path`` once the publisher
    disconnects."""

    def __init__(self, capture_path: str):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.capture_path = capture_path
        self.n_video = ctx.Value("i", 0)
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_ingest, daemon=True, args=(
            capture_path, child, self.n_video))
        self._proc.start()
        check(self._conn.poll(120), "the ingest process did not start")
        self.url = self._conn.recv()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join()

    def finish(self, timeout: float = 60.0) -> None:
        """Wait for the capture; fails on an ingest error."""
        check(self._conn.poll(timeout), f"ingest: no capture in {timeout} s")
        error = self._conn.recv()
        self._proc.join(10)
        check(error is None, f"ingest error {error}")


def check_capture(path: str, what: str, size, sources=None) -> dict:
    """An RTMP capture (.flv): one audio tag beside each video tag, video
    timestamps 40 ms apart from 0, and every frame decoded by cv2 at
    ``size`` (width, height), equal to its source frame after the
    player's own resize when ``sources`` are given (FSV1 is lossless)."""
    import cv2

    from calipsync_tpu_torch.media.flv import TAG_AUDIO, TAG_VIDEO, \
        read_flv_tags

    tags = list(read_flv_tags(path))
    vts = [ts for t, ts, _ in tags if t == TAG_VIDEO]
    n_audio = sum(t == TAG_AUDIO for t, _, _ in tags)
    check(len(vts) > 0 and n_audio == len(vts),
          f"{what}: {len(vts)} video tags, {n_audio} audio tags")
    check(vts == [40 * i for i in range(len(vts))],
          f"{what}: video timestamps are not 40 ms apart")
    if sources is not None:
        check(len(sources) == len(vts),
              f"{what}: {len(sources)} frames played, {len(vts)} captured")
    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        check(frame.shape == (size[1], size[0], 3),
              f"{what}: decoded frame {frame.shape}")
        if sources is not None:
            check(np.array_equal(frame, cv2.resize(sources[n], size)),
                  f"{what}: frame {n} decodes unlike its source")
        n += 1
    cap.release()
    check(n == len(vts), f"{what}: cv2 decoded {n} of {len(vts)} frames")
    nbytes = os.path.getsize(path)
    print(f"{what}: capture {len(vts)} video + {n_audio} audio tags, "
          f"timestamps 40 ms apart, {n} frames decoded by cv2"
          f"{' equal to the played frames' if sources is not None else ''}"
          f", {nbytes} bytes")
    return {"video_tags": len(vts), "audio_tags": n_audio,
            "decoded": n, "capture_bytes": nbytes}


def live_session(torch, ex, synth, size, seconds, real_time, seed,
                 tmp) -> tuple:
    """One StreamingVideoManager session into RTMPPlayer(backend='native')
    at ``size``, 25 fps, pushing a ``seconds`` wav to MiniRTMPServer on
    127.0.0.1 (in its own process); returns (its numbers, its launch
    counts)."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.config import InferConfig
    from calipsync_tpu_torch.serve.players import RTMPPlayer
    from calipsync_tpu_torch.serve.stream_manager import \
        StreamingVideoManager

    icfg = InferConfig()
    what = f"live RTMP {size[0]}x{size[1]}"
    wav = os.path.join(tmp, f"live_{size[0]}.wav")
    save_wav(wav, tone_wav(seconds, seed + 60), 16_000)
    played, stamps, drifts, render_s, render_errors = [], [], [], [], []
    # per played frame: when its render started, and when the producer
    # had uploaded it; the garbage collector's passes (every thread waits)
    starts, arrived, uploaded = [], [], {}
    gc_passes, gc_start = [], {}
    polls = []  # this thread's drift reads: did the whole process stall?

    def on_gc(event, info):
        if event == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            gc_passes.append((info["generation"], gc_start.pop("t"),
                              time.perf_counter()))

    def on_frame(item):
        stamps.append(time.perf_counter())
        played.append(item["frame"])

    with Ingest(os.path.join(tmp, f"live_{size[0]}.flv")) as server:
        player = RTMPPlayer(server.url, *size, backend="native",
                            fps=icfg.fps, sample_rate=24_000,
                            on_frame=on_frame)
        render, upload = player._render, player.upload_frame

        def timed_upload(item):
            uploaded[id(item)] = time.perf_counter()
            upload(item)

        def timed_render(item):
            t0 = time.perf_counter()
            starts.append(t0)
            arrived.append(uploaded.pop(id(item), float("nan")))
            try:
                render(item)
            except Exception as e:
                render_errors.append(repr(e))
                raise
            render_s.append(time.perf_counter() - t0)

        player._render = timed_render
        player.upload_frame = timed_upload
        mgr = StreamingVideoManager(
            synth, ex, player, output_sample_rate=24_000, fps=icfg.fps,
            buffer_threshold=int(icfg.fps * icfg.buffer_threshold_s))
        mgr.warmup()
        n = mgr.add_audio_to_queue(wav)
        n_objects = len(gc.get_objects())
        gc.callbacks.append(on_gc)
        kernels.reset_launches()
        t0 = time.perf_counter()
        mgr.start_playing()
        # the player's A/V drift read every 50 ms while the wav plays
        while len(played) < n and time.perf_counter() - t0 < 10 * seconds + 60:
            if played:
                drifts.append(player.av_drift())
                polls.append(time.perf_counter())
            time.sleep(0.05)
        drift_end = player.av_drift()
        gc.callbacks.remove(on_gc)
        # one second more of the session (idle frames), under the profiler
        prof = device_profile(torch, lambda: time.sleep(1.0),
                              f"{what} session, one second")
        mgr.stop_playing()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        server.finish()
        mgr.close()
    check(len(played) >= n, f"{what}: {len(played)} of {n} frames played")
    check(mgr.producer_errors == 0 and not render_errors,
          f"{what}: {mgr.producer_errors} producer errors, render errors "
          f"{render_errors[:3]}")
    expect_forwards(counts, what)
    cap = check_capture(server.capture_path, what, size, played)
    periods = np.diff(stamps[:n])
    drift_median = float(np.median(drifts))
    # the largest gap between two renders, and whether the player waited
    # for the frame (it arrived after the render before it ended)
    ends = np.add(starts[:n], render_s[:n])
    late = np.subtract(arrived[1:n], ends[:n - 1])
    k = int(np.argmax(np.diff(starts[:n])))
    full = [e - b for g, b, e in gc_passes if g == 2]
    stall = dict(frame=k + 1, gap_ms=(starts[k + 1] - starts[k]) * 1e3,
                 render_before_ms=render_s[k] * 1e3,
                 arrived_after_render_before_ms=float(late[k]) * 1e3,
                 frames_waited_for=int((late > 0).sum()),
                 render_max_ms=float(np.max(render_s[:n])) * 1e3,
                 gc_ms_inside=sum(
                     (min(e, starts[k + 1]) - max(b, ends[k])) * 1e3
                     for _, b, e in gc_passes
                     if b < starts[k + 1] and e > ends[k]),
                 poll_gap_max_ms=float(np.max(np.diff(polls))) * 1e3,
                 gc_objects=n_objects, gc_passes=len(gc_passes),
                 gc_full_passes=len(full),
                 gc_full_max_ms=max(full, default=0.0) * 1e3)
    res = dict(
        size=list(size), frames=len(played), queued=n,
        first_frame_s=stamps[0] - t0,
        period_mean_ms=float(periods.mean() * 1e3),
        period_median_ms=float(np.median(periods) * 1e3),
        period_p99_ms=float(np.percentile(periods, 99) * 1e3),
        # how far the wav's last frame went out behind its media time
        slip_s=float(stamps[n - 1] - stamps[0] - (n - 1) / icfg.fps),
        render_mean_ms=float(np.mean(render_s) * 1e3),
        render_p99_ms=float(np.percentile(render_s, 99) * 1e3),
        drift_end_s=drift_end, drift_median_s=drift_median,
        drift_max_s=float(np.max(drifts)), drift_samples=len(drifts),
        real_time_held=real_time, largest_gap=stall, launches=counts,
        profile=prof, **cap)
    print(f"{what} (native, {icfg.fps} fps, {seconds:g} s wav): {n} "
          f"frames, first frame {res['first_frame_s']:.3f} s after "
          f"start_playing, period median {res['period_median_ms']:.2f} "
          f"ms / mean {res['period_mean_ms']:.2f} ms / "
          f"p99 {res['period_p99_ms']:.2f} ms, the last "
          f"{res['slip_s']:.3f} s behind its media time; render (resize, "
          f"FSV1 encode, PCM, socket) mean {res['render_mean_ms']:.2f} ms / "
          f"p99 {res['render_p99_ms']:.2f} ms; A/V drift (every 50 ms, "
          f"{len(drifts)} reads) median {drift_median * 1e3:.2f} ms, max "
          f"{res['drift_max_s'] * 1e3:.2f} ms, at the end "
          f"{drift_end * 1e3:.2f} ms; the largest gap between renders "
          f"{stall['gap_ms']:.1f} ms before frame {stall['frame']} (the "
          f"render before it {stall['render_before_ms']:.1f} ms, the frame "
          f"uploaded {stall['arrived_after_render_before_ms']:.1f} ms after "
          f"that render ended), {stall['frames_waited_for']} frames "
          f"uploaded after the render before them ended, render max "
          f"{stall['render_max_ms']:.1f} ms; garbage collection "
          f"{stall['gc_ms_inside']:.1f} ms inside that gap, "
          f"{stall['gc_passes']} passes in the session, "
          f"{stall['gc_full_passes']} of them full (longest "
          f"{stall['gc_full_max_ms']:.1f} ms) over {n_objects} objects; "
          f"this thread's 50 ms drift reads at most "
          f"{stall['poll_gap_max_ms']:.1f} ms apart")
    if real_time:
        check(abs(drift_median) <= LIVE_MAX_DRIFT_S
              and res["period_median_ms"] <= LIVE_MAX_PERIOD_MS,
              f"{what}: not real time (A/V drift median "
              f"{drift_median:.4f} s, period median "
              f"{res['period_median_ms']:.3f} ms)")
    return res, counts


def encode_alone_ms(data: str) -> dict:
    """The FSV1 encode alone (no session beside it) of the speaker's
    frames resized to each LIVE_SESSIONS size, ms a frame."""
    import glob

    import cv2

    from calipsync_tpu_torch.media.flv import ScreenVideoEncoder

    frames = [cv2.imread(p) for p in
              sorted(glob.glob(os.path.join(data, "frames", "*.jpg")))[:8]]
    res = {}
    for w, h, *_ in LIVE_SESSIONS:
        big = [cv2.resize(f, (w, h)) for f in frames]
        enc = ScreenVideoEncoder()
        t0 = time.perf_counter()
        for f in big + big:
            enc.encode(f)
        res[f"{w}x{h}"] = (time.perf_counter() - t0) * 1e3 / (2 * len(big))
    print(f"FSV1 encode alone on this host, ms a frame: {res}")
    return res


def live_phase(torch, ex, assets, seed, out, tmp) -> dict:
    """(9a) StreamingVideoManager over the serving defaults (bf16
    generator, random HuBERT-large) into the native RTMP player, one
    session per LIVE_SESSIONS entry, after the FSV1 encode alone at each
    size; the capture read back, every frame against the frame played;
    first frame, frame period, render ms, A/V drift, and one profiled
    second after the wav."""
    from calipsync_tpu_torch.config import InferConfig
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer

    icfg = InferConfig()
    with phase("9a FSV1 encode alone"):
        out["live"] = {"encode_alone_ms": encode_alone_ms(assets["data"])}
    synth = FrameSynthesizer(None, assets["data"], model=assets["model"],
                             batch_size=icfg.batch_size, seed=0,
                             transfer_format=icfg.transfer_format,
                             first_batch_size=icfg.first_window_batch)
    paths = {}
    for w, h, seconds, real_time in LIVE_SESSIONS:
        with phase(f"9a live RTMP {w}x{h}"):
            res, counts = live_session(torch, ex, synth, (w, h), seconds,
                                       real_time, seed, tmp)
        out["live"][f"{w}x{h}"] = res
        paths[f"live_rtmp_{w}x{h}"] = counts
    synth.close()
    return paths


class _Lines:
    """A subprocess's stdout lines, read on a thread."""

    def __init__(self, stream):
        import queue
        import threading

        self.lines: list = []
        self._q = queue.Queue()
        self._t = threading.Thread(target=self._read, args=(stream,),
                                   daemon=True)
        self._t.start()

    def _read(self, stream):
        for line in stream:
            self.lines.append(line.rstrip("\n"))
            self._q.put(self.lines[-1])

    def join(self) -> None:
        """Wait for the end of the stream (the process has exited)."""
        self._t.join(timeout=30)

    def wait_for(self, text: str, timeout: float) -> str:
        """The next line that holds ``text``."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._q.get(timeout=max(0.0, deadline
                                               - time.monotonic()))
            except queue.Empty:
                raise SmokeFailure(f"no line holding {text!r} in "
                                   f"{timeout} s: {self.lines[-5:]}")
            if text in line:
                return line


def live_cli_phase(torch, assets, seed, out, tmp) -> dict:
    """(9b) ``python -m calipsync_tpu_torch.cli serve --player rtmp`` in a
    subprocess on the checkpoints 6d wrote (bf16, the serving defaults,
    1080x1920): one wav dropped into --watch, its frames captured,
    SIGINT, the capture checked."""
    from calipsync_tpu_torch.audio.io import save_wav

    watch = os.path.join(tmp, "watch")
    os.makedirs(watch)
    cfg = os.path.join(tmp, "serve_live.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"dtype": "bfloat16"}}, f)
    wav = os.path.join(tmp, "clip.wav")
    save_wav(wav, tone_wav(SERVE_WAV_SECONDS, seed + 61), 16_000)
    with Ingest(os.path.join(tmp, "serve.flv")) as server:
        cmd = [sys.executable, "-m", "calipsync_tpu_torch.cli", "serve",
               "--assets", assets["data"], "--ckpt", assets["ckpt"],
               "--hubert", assets["hubert"], "--config", cfg, "--player",
               "rtmp", "--rtmp-url", server.url, "--watch", watch]
        t0 = time.perf_counter()
        # the serve log (stderr, the calipsync.serve logger) and the JSON
        # summary (stdout) in one stream
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            lines = _Lines(proc.stdout)
            lines.wait_for("calipsync.serve INFO serving;", 600)
            ready_s = time.perf_counter() - t0
            # the serve loop polls every 0.2 s: the file appears whole
            os.replace(wav, os.path.join(watch, "clip.wav"))
            queued = lines.wait_for("calipsync.serve INFO queued clip.wav",
                                    60)
            n = int(queued.rsplit("(", 1)[1].split()[0])
            target = server.n_video.value + n + SERVE_IDLE_FRAMES
            deadline = time.monotonic() + SERVE_WAV_SECONDS + 60
            while (server.n_video.value < target
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=120)
            wall = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines.join()
        if proc.returncode:
            print("\n".join(lines.lines[-40:]), file=sys.stderr)
        check(proc.returncode == 0, f"cli serve exited {proc.returncode}")
        server.finish()
    res = _last_json("\n".join(lines.lines))
    stop = next(line for line in lines.lines
                if "calipsync.serve INFO stopping; metrics: " in line)
    snapshot = json.loads(stop.split("metrics: ", 1)[1])
    check(snapshot["counters"].get("serve.frames") == res["frames_uploaded"]
          and "serve.synthesis_window" in snapshot["timings"],
          f"cli serve: metrics {snapshot} against {res}")
    cap = check_capture(server.capture_path, "cli serve --player rtmp",
                        (SERVE_W, SERVE_H))
    check(cap["video_tags"] >= n + SERVE_IDLE_FRAMES,
          f"cli serve: {cap['video_tags']} "
          f"frames captured, the wav alone has {n}")
    check(res["producer_errors"] == 0 and res["device"].startswith("cuda")
          and "player render error" not in "\n".join(lines.lines),
          f"cli serve: {res}")
    expect_forwards(res["kernel_launches"], "cli serve")
    print(f"cli serve --player rtmp (subprocess, {wall:.1f} s; serving "
          f"{ready_s:.1f} s after start, HuBERT-large loaded and warmed "
          f"up): {res}")
    print(f"cli serve metrics on stop: {snapshot['counters']}, synthesis "
          f"window {snapshot['timings']['serve.synthesis_window']}")
    out["live_cli"] = dict(wall_s=wall, ready_s=ready_s, queued=n,
                           result=res, metrics=snapshot, **cap)
    return res["kernel_launches"]


def live_ffmpeg_phase(out, tmp) -> None:
    """(9c) RTMPPlayer(backend='ffmpeg') pushing 3 s of synthetic frames
    to the loopback ingest, where the machine has an ffmpeg binary."""
    import shutil

    import cv2

    from calipsync_tpu_torch.serve.players import RTMPPlayer

    if shutil.which("ffmpeg") is None:
        print("live RTMP, ffmpeg backend: not run (no ffmpeg binary)")
        out["live_ffmpeg"] = None
        return
    with Ingest(os.path.join(tmp, "ffmpeg.flv")) as server:
        player = RTMPPlayer(server.url, 640, 360, backend="ffmpeg", fps=25,
                            sample_rate=24_000)
        rng = np.random.default_rng(0)
        frames = [np.full((360, 640, 3), i * 3 % 256, np.uint8) for i in
                  range(75)]
        player.start_playing()
        for i, f in enumerate(frames):
            player.upload_frame({"frame": f, "index": i, "audio": (
                rng.standard_normal(960) * 0.1).astype(np.float32)})
        deadline = time.monotonic() + 30
        while player.get_queue_length() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        player.stop_playing()
        server.finish()
        n_video = server.n_video.value
        cap = cv2.VideoCapture(server.capture_path)
        decoded = 0
        while cap.read()[0]:
            decoded += 1
        cap.release()
        print(f"live RTMP, ffmpeg backend (x264 + aac): {n_video} video tags "
              f"captured, {decoded} frames decoded of {len(frames)} pushed")
        check(n_video > 0 and decoded > 0, "ffmpeg push: nothing captured")
        out["live_ffmpeg"] = dict(video_tags=n_video, decoded=decoded)


def live_output(torch, ex, assets, seed, out, tmp) -> dict:
    """Phases (9a)-(9c); returns the launch counts of each path that runs
    the generator."""
    os.makedirs(tmp)
    paths = live_phase(torch, ex, assets, seed, out, tmp)
    with phase("9b cli serve --player rtmp"):
        paths["cli_serve"] = live_cli_phase(torch, assets, seed, out, tmp)
    with phase("9c ffmpeg backend"):
        live_ffmpeg_phase(out, tmp)
    return paths


# ----------------------------------------------------------- evaluation

SYNC_ABS_TOL = 1e-3    # sim_best, sim_at_zero, lse_c, lse_d: card vs CPU
# SyncNet's embeddings are unit vectors: their largest element error, card
# against CPU, by cuDNN's TF32 flag. On (PyTorch's default): TF32's unit
# roundoff is 4.9e-4, and an H100 read 1.66e-4; off (fp32): read 3.6e-7.
SYNC_EMB_TOL = {True: 1e-3, False: 1e-5}
SYNC_MIN_LSE_C = 0.1   # the planted clip's scan: its best over its median
LPIPS_REL_TOL = 1e-3   # a frame's LPIPS: card vs CPU
EVAL_FRAMES = 250      # frames of the planted clip and of 6b's mp4 read
PARITY_FP32_MIN_DB = 60.0


def cli_json(torch, argv) -> tuple:
    """``calipsync_tpu_torch.cli`` in this process: (its JSON output,
    seconds)."""
    import io

    from calipsync_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    return json.loads(text[text.index("{"):]), wall


def sync_report_close(a: dict, b: dict, what: str) -> float:
    """Two sync reports of the planted clip agree: both find its planted
    offset with a spread of SYNC_MIN_LSE_C at least, their similarities
    within SYNC_ABS_TOL; returns the largest difference."""
    from calipsync_tpu_torch.bench_assets import SYNC_PLANT_SHIFT

    err = max(abs(a[k] - b[k]) for k in ("sim_best", "sim_at_zero",
                                         "lse_c", "lse_d"))
    check(a["av_offset_frames"] == b["av_offset_frames"] == SYNC_PLANT_SHIFT
          and a["n_frames"] == b["n_frames"] and err <= SYNC_ABS_TOL
          and min(a["lse_c"], b["lse_c"]) >= SYNC_MIN_LSE_C,
          f"{what}: {a} against {b}")
    return err


def read_crops(lips_dir: str) -> np.ndarray:
    import glob

    import cv2

    return np.stack([cv2.resize(cv2.imread(p), (160, 160)) for p in
                     sorted(glob.glob(os.path.join(lips_dir, "*.jpg")))])


def write_planted(torch, sd, crops, feats, tmp: str) -> dict:
    """The planted clip as ``sync-score`` reads it: its weights (.pth), its
    features (.npy), and its crops as a directory of JPEGs and as a
    480x480 mp4."""
    import cv2

    from calipsync_tpu_torch.media.video import open_video_writer

    paths = dict(syncnet=os.path.join(tmp, "syncnet_planted.pth"),
                 feats=os.path.join(tmp, "planted_hubert.npy"),
                 lips=os.path.join(tmp, "planted_lips"),
                 mp4=os.path.join(tmp, "planted.mp4"))
    torch.save(sd, paths["syncnet"])
    np.save(paths["feats"], feats)
    os.makedirs(paths["lips"])
    vw = open_video_writer(paths["mp4"], 25, 480, 480)
    for i, crop in enumerate(crops):
        cv2.imwrite(os.path.join(paths["lips"], f"{i:06d}.jpg"), crop)
        vw.write(cv2.resize(crop, (480, 480)))
    vw.release()
    return paths


def syncnet_phase(torch, w, clone, tmp, out) -> dict:
    """(10a) SyncNet (hubert, avg pool) on the card, under the default
    flags and with cuDNN's TF32 flag off, against the CPU: the seeded
    weights' embeddings of step 3's first 64 lip crops with step 1's
    features (B=64) within SYNC_EMB_TOL; and sync_metrics over a clip of
    EVAL_FRAMES frames with a shift planted in it (bench_assets.
    planted_sync, from the first crop), whose scan has a spread, by
    sync_report_close; then the forward's ms. Returns the planted clip's
    files for 10c."""
    from calipsync_tpu_torch.audio.windows import batched_windows
    from calipsync_tpu_torch.bench_assets import planted_sync
    from calipsync_tpu_torch.core.weights import load_torch_state_dict
    from calipsync_tpu_torch.eval import sync_metrics
    from calipsync_tpu_torch.nn.syncnet import load_syncnet

    crops = read_crops(clone["lips"])
    feats = np.load(clone["feats"])
    sd = load_torch_state_dict(w["syncnet"])
    cpu, card = (load_syncnet(sd, device=d) for d in ("cpu", "cuda"))
    face = torch.from_numpy(crops[:64]).float() / 255.0
    win = batched_windows(torch.from_numpy(feats), torch.arange(len(face)))
    p_sd, p_crops, p_feats = planted_sync(sd, crops[0], EVAL_FRAMES)
    p_cpu, p_card = (load_syncnet(p_sd, device=d) for d in ("cpu", "cuda"))
    res = out["evaluation"]["syncnet"] = {}
    with torch.inference_mode():
        ref_emb = cpu(face, win)
        ref = sync_metrics(p_cpu, p_crops, p_feats)
        for flag in (True, False):
            with cudnn_tf32_flag(torch, flag):
                emb = card(face.cuda(), win.cuda())
                rep = sync_metrics(p_card, p_crops, p_feats)
            e_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(emb, ref_emb))
            err = sync_report_close(rep, ref,
                                    f"SyncNet planted clip, TF32 {flag}")
            res[f"tf32_{flag}"] = dict(embedding_max_abs_err=e_err,
                                       planted_report=rep,
                                       planted_report_max_err=err)
            print(f"SyncNet card (cuDNN TF32 {flag}) vs CPU: embeddings of "
                  f"64 lip crops max abs err {e_err:.3g} of their unit norm "
                  f"(limit {SYNC_EMB_TOL[flag]}); the planted clip's report "
                  f"max err {err:.3g} (limit {SYNC_ABS_TOL}), offset "
                  f"{rep['av_offset_frames']}, spread (lse_c) "
                  f"{rep['lse_c']}")
            check(e_err <= SYNC_EMB_TOL[flag],
                  f"SyncNet embeddings, TF32 {flag}: card vs CPU {e_err:.3g}")
        fc, wc = face.cuda(), win.cuda()
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card(fc, wc)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    res["forward_b64_ms"] = float(np.median(times[1:]))
    res["cpu_planted_report"] = ref
    print(f"SyncNet forward B=64 on the card: {res['forward_b64_ms']:.2f} ms"
          f" (host clock, synchronized); CPU report of the planted clip "
          f"{ref}")
    return write_planted(torch, p_sd, p_crops, p_feats, tmp)


def syncnet_train_phase(clone, out, tmp) -> None:
    """(10b) ``python -m calipsync_tpu_torch.cli syncnet-train`` in a
    subprocess, two epochs over step 1's 250 frames at B=16; beside it, a
    batch's host read (SyncNetDataset.batch: 16 JPEG reads, crops and
    resizes) timed alone, the split behind the samples/s."""
    from calipsync_tpu_torch.train.syncnet_trainer import SyncNetDataset

    save = os.path.join(tmp, "syncnet_run")
    cmd = [sys.executable, "-m", "calipsync_tpu_torch.cli", "syncnet-train",
           "--data", clone["step1"], "--save", save, "--epochs", "2",
           "--log-every", "0"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"cli syncnet-train exited {proc.returncode}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(np.isfinite(res["final_loss"]) and np.isfinite(res["best_loss"])
          and all(os.path.exists(os.path.join(save, d, "step_2.pt"))
                  for d in ("last",))
          and os.path.isdir(os.path.join(save, "best")),
          f"cli syncnet-train: {res}, {os.listdir(save)}")
    ds = SyncNetDataset(clone["step1"])
    order = np.resize(np.random.default_rng(0).permutation(len(ds)), 80)
    reads = []
    for idxs in order.reshape(5, 16):
        t1 = time.perf_counter()
        ds.batch(idxs)
        reads.append((time.perf_counter() - t1) * 1e3)
    read_ms = float(np.median(reads))
    step_ms = 16e3 / res["samples_per_s"]
    print(f"cli syncnet-train (subprocess, {wall:.1f} s with start-up): "
          f"{res['steps']} steps, first step {res['first_step_s']} s, then "
          f"{res['samples_per_s']} samples/s ({step_ms:.1f} ms a step of 16) "
          f"over the steps that end no epoch; the epoch-ending steps with "
          f"their best/ and last/ writes {res['epoch_end_steps_s']} s; a "
          f"batch's host read alone {read_ms:.1f} ms; peak memory "
          f"{res.get('peak_memory_bytes', 0) / 2**30:.2f} GiB, losses "
          f"{res['final_loss']} / best {res['best_loss']}")
    out["evaluation"]["syncnet_train"] = dict(
        wall_s=wall, result=res, step_ms=step_ms, batch_read_ms=read_ms)


def sync_score_phase(torch, planted, out) -> None:
    """(10c) ``sync-score`` on the card and on the CPU over 10a's planted
    clip, as a directory of lip-crop JPEGs and as a 480x480 mp4, each with
    its features and weights: the reports agree (sync_report_close);
    frames/s on the card."""
    res = out["evaluation"]["sync_score"] = {}
    for name, src in (("lips", ["--lips-dir", planted["lips"]]),
                      ("video", ["--video", planted["mp4"]])):
        argv = ["sync-score", *src, "--features", planted["feats"],
                "--syncnet", planted["syncnet"]]
        card, card_s = cli_json(torch, argv)
        cpu, cpu_s = cli_json(torch, argv + ["--device", "cpu"])
        err = sync_report_close(card, cpu, f"sync-score {name}")
        res[name] = dict(card=card, cpu=cpu, card_s=card_s, cpu_s=cpu_s,
                         card_fps=card["n_frames"] / card_s,
                         max_err=err)
        print(f"sync-score {name} (the planted clip): {card['n_frames']} "
              f"frames, card {card_s:.2f} s = "
              f"{card['n_frames'] / card_s:.1f} frames/s (reading the "
              f"frames included), CPU {cpu_s:.2f} s; reports agree within "
              f"{err:.3g}: {card}")


def shifted_copy(src: str, dst: str, n: int) -> str:
    """Frames 1..n of ``src`` written as an mp4 (a video against itself a
    frame later)."""
    from calipsync_tpu_torch.media.video import open_video_writer

    frames = read_frames(src, n + 1)[1:]
    h, w = frames[0].shape[:2]
    vw = open_video_writer(dst, 25, w, h)
    for f in frames:
        vw.write(f)
    vw.release()
    return dst


def eval_phase(torch, w, assets, out, tmp) -> None:
    """(10d) LPIPS (seeded VGG16 and AlexNet trunks and heads in the
    torchvision and lpips layouts) between 6b's offline mp4 and itself a
    frame later: per frame on the card (default flags and TF32 off)
    against the CPU; then ``eval --lpips`` on the card over EVAL_FRAMES
    frames (frames/s) and against the CPU's over 8."""
    from calipsync_tpu_torch.core.weights import load_torch_state_dict
    from calipsync_tpu_torch.eval import lpips_distance
    from calipsync_tpu_torch.nn.lpips import load_lpips

    a_path = assets["offline_mp4"]
    b_path = shifted_copy(a_path, os.path.join(tmp, "shifted.mp4"),
                          EVAL_FRAMES)
    a = np.stack(read_frames(a_path, 8))[..., ::-1]
    b = np.stack(read_frames(b_path, 8))[..., ::-1]
    res = out["evaluation"]["lpips"] = {}
    for net in ("vgg", "alex"):
        trunk = load_torch_state_dict(w[f"{net}_trunk"])
        heads = load_torch_state_dict(w[f"{net}_heads"])
        ref = lpips_distance(load_lpips(trunk, heads, net, "cpu"), a, b)
        card = load_lpips(trunk, heads, net, "cuda")
        r = res[net] = {"cpu": ref.tolist()}
        for flag in (True, False):
            with cudnn_tf32_flag(torch, flag):
                got = lpips_distance(card, a, b)
            rel = float(np.max(np.abs(got - ref) / ref))
            r[f"tf32_{flag}_rel_err"] = rel
            print(f"LPIPS {net} per frame (8 frames of 480x480), card "
                  f"(cuDNN TF32 {flag}) vs CPU: max relative err {rel:.3g} "
                  f"(limit {LPIPS_REL_TOL}); values {np.round(ref, 5)}")
            check(np.all(ref > 0) and rel <= LPIPS_REL_TOL,
                  f"LPIPS {net}: card and CPU disagree")
        argv = ["eval", "--a", a_path, "--b", b_path, "--lpips",
                w[f"{net}_heads"], "--lpips-trunk", w[f"{net}_trunk"],
                "--lpips-net", net]
        full, full_s = cli_json(torch, argv + ["--max-frames",
                                              str(EVAL_FRAMES)])
        eight, _ = cli_json(torch, argv + ["--max-frames", "8"])
        cpu, _ = cli_json(torch, argv + ["--max-frames", "8", "--device",
                                         "cpu"])
        # the command rounds LPIPS to 1e-5
        rel = max(abs(eight[k] - cpu[k]) / cpu[k]
                  for k in ("lpips_mean", "lpips_max"))
        check(full["n_frames"] == EVAL_FRAMES
              and np.isfinite(full["lpips_mean"])
              and all(abs(eight[k] - cpu[k]) <= LPIPS_REL_TOL * cpu[k]
                      + 1e-5 for k in ("lpips_mean", "lpips_max"))
              and eight["psnr_db_mean"] == cpu["psnr_db_mean"],
              f"cli eval {net}: {eight} vs {cpu}")
        r.update(cli=full, cli_s=full_s, cli_fps=EVAL_FRAMES / full_s,
                 cli_8_card=eight, cli_8_cpu=cpu, cli_8_rel_err=rel)
        print(f"cli eval --lpips-net {net}: {EVAL_FRAMES} frames of 480x480"
              f" in {full_s:.2f} s on the card = "
              f"{EVAL_FRAMES / full_s:.1f} frames/s "
              f"(decoding and PSNR included): {full}; 8 frames card vs "
              f"CPU relative err {rel:.3g}")


def parity_phase(torch, out) -> dict:
    """(10e) generator_parity_report: the fp32 plain generator on the CPU
    (random weights, every leaf randomized) as the reference-layout
    module, against the serving generator on the card through the
    kernels, in bf16 and in fp32, B=8."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  random_jax_generator)
    from calipsync_tpu_torch.eval import generator_parity_report
    from calipsync_tpu_torch.nn.unet import Generator

    ref = Generator(mode="hubert", n_blocks=4, ops="plain")
    ref.load_state_dict(from_jax_generator(random_jax_generator(seed=0)),
                        strict=True)
    kernels.reset_launches()
    reports = {name: generator_parity_report(ref, batch=8, dtype=dt,
                                             device="cuda")
               for name, dt in (("bf16", torch.bfloat16),
                                ("fp32", torch.float32))}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    expect_forwards(counts, "generator_parity_report", 2)
    for name, r in reports.items():
        print(f"generator_parity_report {name} (card, kernels) vs fp32 "
              f"plain on the CPU, B=8: PSNR {r['psnr_db']:.2f} dB, max abs "
              f"err {r['max_abs_err']:.3f} / mean {r['mean_abs_err']:.4f} "
              f"(of 255)")
    check(reports["fp32"]["psnr_db"] >= PARITY_FP32_MIN_DB,
          f"fp32 parity {reports['fp32']['psnr_db']:.2f} dB")
    check(np.isfinite(reports["bf16"]["psnr_db"]), "bf16 parity")
    out["evaluation"]["parity"] = reports
    return counts


def evaluation(torch, assets, clone, seed, out, tmp) -> dict:
    """Phases (10a)-(10e); returns the launch counts of the parity
    report."""
    from calipsync_tpu_torch.bench_assets import write_eval_weights

    os.makedirs(tmp)
    out["evaluation"] = {}
    w = write_eval_weights(os.path.join(tmp, "weights"), seed=seed)
    with phase("10a SyncNet card vs CPU"):
        planted = syncnet_phase(torch, w, clone, tmp, out)
    with phase("10b cli syncnet-train"):
        syncnet_train_phase(clone, out, tmp)
    with phase("10c cli sync-score"):
        sync_score_phase(torch, planted, out)
    with phase("10d LPIPS, cli eval"):
        eval_phase(torch, w, assets, out, tmp)
    with phase("10e generator_parity_report"):
        return {"parity": parity_phase(torch, out)}


# ---------------------------------------------------------------- tools

ASR_SECONDS = 30.0       # the recognizer's clip, speech-like bursts
ASR_MARGIN_RATIO = 10.0  # least top-2 margin over the card-CPU difference
EXPORT_FP32_BATCH = 8
LEGACY_FRAMES = 2        # 8b's video frames, ~85 faces each


class _Job:
    """A subprocess from the repo's root, its stdout and stderr to
    ``log_path``; ``seconds`` is its wall time once it has ended (a thread
    waits for it)."""

    def __init__(self, argv, log_path: str, env=None):
        import threading

        self.log_path = log_path
        self.seconds = None
        with open(log_path, "w") as log:
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        threading.Thread(target=self._wait, daemon=True).start()

    def _wait(self):
        self.proc.wait()
        self.seconds = time.perf_counter() - self.t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, what: str, timeout: float) -> str:
        """Wait for the end (killed at ``timeout``), check the exit code
        and return the output."""
        try:
            self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        with open(self.log_path) as f:
            text = f.read()
        if self.proc.returncode:
            print(text[-4000:], file=sys.stderr)
        check(self.proc.returncode == 0,
              f"{what} exited {self.proc.returncode}")
        while self.seconds is None:  # the waiting thread's last step
            time.sleep(0.01)
        return text


def _cli(args) -> list:
    return [sys.executable, "-m", "calipsync_tpu_torch.cli", *args]


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise SmokeFailure(f"no JSON line in: {text[-400:]}")


def start_cpu_costs(tmp) -> dict:
    """``cli cost --device cpu`` at B=1 and B=BATCH in subprocesses on two
    threads each, started first: they run beside 11a-11e and are read by
    :func:`check_costs`."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return {b: _Job(_cli(["cost", "--batch", str(b), "--device", "cpu"]),
                    os.path.join(tmp, f"cost_cpu_{b}.log"), env)
            for b in (1, BATCH)}


def cost_phase(torch, tmp, out) -> dict:
    """(11a) ``cli cost`` at B=1 and BATCH in subprocesses on the card,
    and one count in process on the card for the launch counters (an fp32
    forward: 9/17/4). The CPU subprocesses' counts
    (:func:`start_cpu_costs`) are read at the end of phase 11
    (:func:`check_costs`)."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.profiling import generator_cost

    jobs = {b: _Job(_cli(["cost", "--batch", str(b)]),
                    os.path.join(tmp, f"cost_cuda_{b}.log"))
            for b in (1, BATCH)}
    kernels.reset_launches()
    t0 = time.perf_counter()
    one = generator_cost(batch=1)
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expect_forwards(counts, "cost (in process, fp32 B=1)", 1)
    res = out["cost"] = dict(raw_b1=one["raw"], in_process_s=inproc_s,
                             flops_in_process_b1=one["flops"], cuda={},
                             subprocess_s={})
    for b, job in jobs.items():
        text = job.finish(f"cli cost --batch {b}", 600)
        res["subprocess_s"][f"cuda_{b}"] = job.seconds
        res["cuda"][b] = round(float(_last_json(text)) * 1e9)
    check(one["flops"] == res["cuda"][1],
          f"cost: {one['flops']} in process, {res['cuda'][1]} by the CLI")
    return counts


def check_costs(cpu_jobs: dict, out) -> None:
    """(11a, its end) The CPU subprocesses' counts equal the card's to the
    integer."""
    res = out["cost"]
    cpu = {}
    for b, job in cpu_jobs.items():
        text = job.finish(f"cli cost --batch {b} --device cpu", 900)
        res["subprocess_s"][f"cpu_{b}"] = job.seconds
        cpu[b] = round(float(_last_json(text)) * 1e9)
    check(cpu == res["cuda"], f"cost: card {res['cuda']}, CPU {cpu}")
    print(f"cost: {cpu[1]} FLOP at B=1 ({cpu[1] / 1e9:.6f} GFLOP), "
          f"{cpu[BATCH]} at B={BATCH}, card = CPU to the integer; per op "
          f"at B=1: {res['raw_b1']}; in process "
          f"{res['in_process_s']:.2f} s, subprocess walls "
          f"{ {k: round(v, 1) for k, v in res['subprocess_s'].items()} }")
    res["cpu"] = cpu


def run_exported(directory: str) -> int:
    """The child of 11b (``chip_smoke.py --run-exported DIR``): loads the
    exported programs in a fresh process (the import of the port alone
    registers the ops), runs each on its saved inputs with the launch
    counters read a forward, times it, saves its outputs, and traces one
    bf16 forward with profiling.trace. Prints one JSON line."""
    import torch

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.export import kernel_nodes, load_program
    from calipsync_tpu_torch.kernels.measure import Timer
    from calipsync_tpu_torch.profiling import trace

    timer = Timer()
    # fp32 in fp32, as the parent's eager reference: cuDNN's TF32 off
    torch.backends.cudnn.allow_tf32 = False
    res, progs = {}, {}
    for name in ("bf16", "fp32"):
        t0 = time.perf_counter()
        prog = progs[name] = load_program(os.path.join(directory,
                                                       f"{name}.pt2"))
        load_s = time.perf_counter() - t0
        x, a = torch.load(os.path.join(directory, f"{name}_in.pt"))
        per_forward = []
        with torch.inference_mode():
            for _ in range(2):
                kernels.reset_launches()
                y = prog(x, a)
                torch.cuda.synchronize()
                per_forward.append(kernels.launch_counts())
            ms = timer.ms(lambda: prog(x, a), warmup=1, reps=5)
        torch.save(y.cpu(), os.path.join(directory, f"{name}_out.pt"))
        res[name] = dict(load_s=load_s, launches=per_forward, ms=ms,
                         nodes=kernel_nodes(prog))
    x, a = torch.load(os.path.join(directory, "bf16_in.pt"))
    with torch.inference_mode(), trace(os.path.join(directory,
                                                    "trace")) as prof:
        progs["bf16"](x, a)
        torch.cuda.synchronize()
    res["trace"] = prof.trace_path
    print(json.dumps(res))
    return 0


def _trace_kernels(path: str) -> dict:
    """For each ``calipsync::`` op event of a Chrome trace: the CUDA kernels
    launched inside its span (matched by correlation id); returns
    {op name: [kernel names of each call]}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel" and "args" in e}
    launches = [(e["ts"], e["args"].get("correlation")) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "args" in e]
    calls = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith("calipsync::"):
            inside = [kernels[c] for ts, c in launches
                      if e["ts"] <= ts <= e["ts"] + e["dur"] and c in kernels]
            calls.setdefault(e["name"], []).append(inside)
    return calls


def export_phase(torch, tmp, out) -> dict:
    """(11b) The full-width generator exported on the card, bf16 at B=128
    and fp32 at B=8, saved, then loaded and run in a fresh subprocess:
    9/17/4 launches a forward, fp32 within the repo's bar of eager, bf16
    equal to eager (else held to the bf16 bar against eager), one loaded
    forward traced with its three kernels in it. Eager and loaded run
    with cuDNN's TF32 off, so fp32 is fp32 on both sides."""
    from calipsync_tpu_torch.export import export_generator, kernel_nodes
    from calipsync_tpu_torch.kernels.measure import (EXPECTED_PER_FORWARD,
                                                     Timer,
                                                     generator_inputs,
                                                     random_generator)

    directory = os.path.join(tmp, "export")
    os.makedirs(directory)
    timer = Timer()
    res = out["export"] = {}
    eager = {}
    for name, dtype, batch in (("bf16", torch.bfloat16, BATCH),
                               ("fp32", torch.float32, EXPORT_FP32_BATCH)):
        model = random_generator(dtype)
        x, a = generator_inputs(batch, seed=11)
        # the child runs with cuDNN's TF32 off too: fp32 is compared in fp32
        with torch.inference_mode(), cudnn_tf32_flag(torch, False):
            eager[name] = model(x, a).float().cpu()   # the folds cached
            eager_ms = timer.ms(lambda: model(x, a), warmup=1, reps=5)
        t0 = time.perf_counter()
        path = export_generator(model, os.path.join(directory,
                                                    f"{name}.pt2"), batch)
        export_s = time.perf_counter() - t0
        nodes = kernel_nodes(torch.export.load(path))
        check(nodes == {"fused_ir": 9, "depthwise3x3": 17,
                        "cross_attention": 4},
              f"export {name}: calipsync nodes {nodes}")
        torch.save((x, a), os.path.join(directory, f"{name}_in.pt"))
        res[name] = dict(batch=batch, export_s=export_s, eager_ms=eager_ms,
                         nodes=nodes, bytes=os.path.getsize(path))
        del model
    job = _Job([sys.executable, os.path.abspath(__file__), "--run-exported",
                directory], os.path.join(tmp, "run_exported.log"))
    child = _last_json(job.finish("the exported programs' subprocess", 900))
    res["subprocess_s"] = job.seconds
    for name in ("bf16", "fp32"):
        r = child[name]
        for counts in r["launches"]:
            check(counts == EXPECTED_PER_FORWARD,
                  f"loaded {name} program: launches {counts} a forward")
        got = torch.load(os.path.join(directory, f"{name}_out.pt")).float()
        diff = (got - eager[name]).abs().max().item()
        if name == "fp32":
            ok = torch.allclose(got, eager[name], rtol=GEN_FP32_TOL[2],
                                atol=GEN_FP32_TOL[0])
            check(ok, f"loaded fp32 program vs eager: max {diff}")
        elif diff:
            print(f"loaded bf16 program vs eager: max {diff} (not "
                  "identical); held to the bf16 bar")
            bf16_against_plain(got, eager[name], "loaded bf16 program")
        res[name].update(r, max_abs_vs_eager=diff)
        print(f"export {name} B={res[name]['batch']}: export "
              f"{res[name]['export_s']:.2f} s, load {r['load_s']:.2f} s "
              f"(fresh process), forward {r['ms']:.3f} ms against eager "
              f"{res[name]['eager_ms']:.3f}, max |loaded - eager| {diff}, "
              f"launches {r['launches'][0]}, nodes {r['nodes']}")
    calls = _trace_kernels(child["trace"])
    launches = child["bf16"]["launches"][0]
    for op, n in (("calipsync::fused_ir", 9), ("calipsync::depthwise3x3", 17),
                  ("calipsync::cross_attention", 4)):
        check(len(calls.get(op, [])) == n
              and all(any(k.startswith("void calipsync::")
                          or "calipsync::" in k for k in ks)
                      for ks in calls[op]),
              f"trace: {op} calls {len(calls.get(op, []))}, kernels "
              f"{calls.get(op, [])[:2]}")
    names = {op: sorted({k.replace("(anonymous namespace)::", "")
                         .split("(")[0][:90] for ks in c for k in ks
                         if "calipsync::" in k}) for op, c in calls.items()}
    print(f"trace of a loaded bf16 forward: {names}")
    res["trace_kernels"] = names
    return launches


def asr_phase(torch, tmp, seed, out) -> str:
    """(11c) The CTC recognizer at the width of wav2vec2-base-960h
    (bench_assets.write_ctc_dir) on a 30 s speech-like clip, its head
    planted on the CPU (bench_assets.planted_ctc); the card's logits
    against the CPU's within HUBERT_CPU_TOL, the least top-2 margin at
    least ASR_MARGIN_RATIO times the largest card-CPU difference, the
    spans equal, and ``cli slice --asr`` on the card and with --device cpu
    (subprocesses, side by side) writing the same segments. Returns the
    recognizer's directory."""
    from calipsync_tpu_torch.audio.asr import (greedy_ctc_spans,
                                               load_hf_ctc_checkpoint)
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.audio.slicer import sentences_from_spans
    from calipsync_tpu_torch.bench_assets import (planted_ctc,
                                                  speech_like_wav,
                                                  write_ctc_dir)
    from calipsync_tpu_torch.kernels.measure import max_err

    res = out["asr"] = {}
    path = write_ctc_dir(os.path.join(tmp, "ctc"), seed=seed)
    wav = speech_like_wav(ASR_SECONDS, seed + 71)
    wav_path = os.path.join(tmp, "speech30.wav")
    save_wav(wav_path, wav, 16_000)
    t0 = time.perf_counter()
    plant = planted_ctc(path, wav)
    res["plant_cpu_s"] = time.perf_counter() - t0
    jobs = {dev: _Job(_cli(["slice", "--audio", wav_path, "--out",
                            os.path.join(tmp, f"slice_{dev}"), "--asr", path,
                            "--device", dev]),
                      os.path.join(tmp, f"slice_{dev}.log"))
            for dev in ("cpu", "cuda")}
    rec = load_hf_ctc_checkpoint(path)
    card = rec.logits(wav)
    cpu = plant["logits"]
    err, ok = max_err(torch.from_numpy(card), torch.from_numpy(cpu),
                      HUBERT_CPU_TOL)
    top2 = np.sort(cpu, axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    print(f"ASR logits ({card.shape[0]} frames x {card.shape[1]}): card vs "
          f"CPU max {err:.3g}; least top-2 margin {margin:.4g} = "
          f"{margin / max(err, 1e-30):.3g} x the difference")
    check(ok, f"ASR logits: card vs CPU max {err}")
    check(margin >= ASR_MARGIN_RATIO * err,
          f"ASR: least margin {margin} under {ASR_MARGIN_RATIO} x {err}")
    spans = rec.recognize(wav)
    want = sentences_from_spans(greedy_ctc_spans(
        cpu.argmax(-1), rec.id_to_token, rec.frame_dt, rec.blank_id,
        rec.word_delimiter, max_word_gap_s=None))
    check(spans == want, "ASR spans: card and CPU differ")
    check(len(spans) >= 5 and all(t for _, _, t in spans),
          f"ASR: the planted decode gives {len(spans)} spans")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rec.logits(wav)
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    print(f"ASR: {len(spans)} spans, {ms:.1f} ms a {ASR_SECONDS:.0f} s clip "
          f"(real-time factor {ms / 1e3 / ASR_SECONDS:.4f}); first span "
          f"{spans[0][:2]} {spans[0][2][:40]!r}")
    segs = {}
    for dev, job in jobs.items():
        segs[dev] = _last_json(job.finish(f"cli slice --asr --device {dev}",
                                          600))
        res[f"slice_{dev}_s"] = job.seconds
    n = segs["cuda"]["segments"]
    check(segs["cuda"] == segs["cpu"] and n >= 2, f"cli slice: {segs}")
    for i in range(n + 1):
        for ext in ("wav", "txt"):
            a, b = (os.path.join(tmp, f"slice_{d}", f"{i}.{ext}")
                    for d in ("cuda", "cpu"))
            check(os.path.exists(a) == os.path.exists(b)
                  and (not os.path.exists(a)
                       or open(a, "rb").read() == open(b, "rb").read()),
                  f"cli slice: {i}.{ext} differs between card and CPU")
    print(f"cli slice --asr: {n} segments, card and CPU the same files; "
          f"{res['slice_cuda_s']:.1f} s on the card, "
          f"{res['slice_cpu_s']:.1f} s on the CPU (subprocesses, side by "
          "side)")
    res.update(frames=int(card.shape[0]), max_abs_card_cpu=err,
               min_margin=margin, spans=len(spans), ms_per_clip=ms,
               real_time_factor=ms / 1e3 / ASR_SECONDS, segments=n)
    return path


def verify_phase(tmp, paths: dict, out) -> None:
    """(11d) ``cli verify-weights`` over every seeded file the script wrote,
    on the card and with --device cpu (side by side): every status ok,
    exit 0, the same JSON."""
    argv = []
    for flag, key in (("--weights-dir", "face"), ("--generator", "ckpt"),
                      ("--syncnet", "syncnet"), ("--hubert", "hubert"),
                      ("--lpips-trunk", "vgg_trunk"),
                      ("--lpips-heads", "vgg_heads"), ("--asr", "ctc")):
        argv += [flag, paths[key]]
    jobs = {dev: _Job(_cli(["verify-weights", *argv, "--device", dev]),
                      os.path.join(tmp, f"verify_{dev}.log"))
            for dev in ("cuda", "cpu")}
    reports, walls = {}, {}
    for dev, job in jobs.items():
        text = job.finish(f"cli verify-weights --device {dev}", 600)
        walls[dev] = job.seconds
        reports[dev] = json.loads(text[text.index("["):])
    card = reports["cuda"]
    check(card == reports["cpu"], "verify-weights: card and CPU differ")
    check(len(card) == 9 and all(r["status"] == "ok" for r in card),
          f"verify-weights: {[(r['artifact'], r['status']) for r in card]}")
    print(f"cli verify-weights: {len(card)} artifacts ok, card = CPU; "
          f"{walls['cuda']:.1f} s on the card, {walls['cpu']:.1f} s on the "
          "CPU: " + ", ".join(f"{r['artifact']} {r.get('imported_params')}"
                              for r in card))
    out["verify_weights"] = dict(walls_s=walls, reports=card)


def legacy_phase(torch, tmp, seed, face_dir, out) -> None:
    """(11e) LegacyLandmark on 8b's synthetic video's first frames, the
    seeded YOLOv8n-face (every stride-16 anchor fires; its keypoints from
    random weights) and PFLD, card against CPU: the same faces, roll
    angles within 1e-3 degree, landmarks within 1 px; ms a frame."""
    from calipsync_tpu_torch.bench_assets import make_synthetic_video
    from calipsync_tpu_torch.cli import build_lip_detector
    from calipsync_tpu_torch.core.weights import load_torch_state_dict
    from calipsync_tpu_torch.nn.yolo import YoloV8FaceDetector
    from calipsync_tpu_torch.vision.legacy_landmark import LegacyLandmark

    frames = read_frames(make_synthetic_video(
        os.path.join(tmp, "legacy.mp4"), LEGACY_FRAMES, 480,
        seed=seed + 30), LEGACY_FRAMES)
    yolo_sd = load_torch_state_dict(os.path.join(
        face_dir, "yolov8n_face_state_dict.pth"))
    results, ms = {}, None
    for dev in ("cpu", "cuda"):
        lip = build_lip_detector(face_dir, device=dev)
        try:
            legacy = LegacyLandmark(lip, YoloV8FaceDetector(
                yolo_sd, batch_size=16, device=dev))
            legacy.landmarks(frames[0])  # warm-up
            t0 = time.perf_counter()
            results[dev] = [legacy.landmarks(f) for f in frames]
            if dev == "cuda":
                ms = (time.perf_counter() - t0) / len(frames) * 1e3
        finally:
            lip.close()
    faces = [len(r) for r in results["cuda"]]
    check(faces == [len(r) for r in results["cpu"]] and min(faces) > 0,
          f"legacy landmark: faces {faces} vs "
          f"{[len(r) for r in results['cpu']]}")
    px = angle = 0.0
    for a_frame, b_frame in zip(results["cuda"], results["cpu"]):
        for (pa, aa), (pb, ab) in zip(a_frame, b_frame):
            px = max(px, float(np.abs(pa.astype(int) - pb).max()))
            angle = max(angle, abs(aa - ab))
    check(px <= 1 and angle <= 1e-3,
          f"legacy landmark: card vs CPU {px} px, {angle} degrees")
    print(f"legacy landmark: {sum(faces)} faces over {len(frames)} frames, "
          f"card vs CPU max {px:.0f} px, roll {angle:.2g} deg; "
          f"{ms:.1f} ms a frame on the card ({ms / faces[0]:.2f} ms a "
          "face)")
    out["legacy_landmark"] = dict(faces=faces, max_px=px, max_roll_deg=angle,
                                  ms_per_frame=ms)


def tools(torch, assets, seed, out, tmp) -> dict:
    """Phases (11a)-(11e); returns the launch counts of the cost and
    export paths."""
    from calipsync_tpu_torch.bench_assets import (write_eval_weights,
                                                  write_face_weights)

    os.makedirs(tmp)
    paths = {}
    cpu_costs = start_cpu_costs(tmp)
    try:
        with phase("11a cost"):
            paths["cost"] = cost_phase(torch, tmp, out)
        with phase("11b export"):
            paths["export"] = export_phase(torch, tmp, out)
        with phase("11c ASR, cli slice --asr"):
            ctc = asr_phase(torch, tmp, seed, out)
        face = write_face_weights(os.path.join(tmp, "face"), seed=seed,
                                  yolo=True)
        ev = write_eval_weights(os.path.join(tmp, "eval"), seed=seed)
        with phase("11d cli verify-weights"):
            verify_phase(tmp, dict(face=face, ckpt=assets["ckpt"],
                                   hubert=assets["hubert"], ctc=ctc, **ev),
                         out)
        with phase("11e legacy landmark"):
            legacy_phase(torch, tmp, seed, face, out)
        with phase("11a cost, the CPU's counts"):
            check_costs(cpu_costs, out)
    finally:
        for job in cpu_costs.values():
            job.kill()
    return paths


# ------------------------------------------------------------ 12 many cards

MC_ROWS = 2 * BATCH      # sharded serving: two device batches a request
MC_STREAMS = 8           # one multi-stream tick: 8 streams x 25 rows
MC_CHUNK = 320_000       # HuBERT-large: one 20 s chunk
MC_EXPERTS = 8           # EP at HuBERT-large width: 8 experts of 1024x4096
MC_TOKENS = 1000         # a 20 s chunk's frames
# a rank's result against the one-card run at the repo's bar (atol, rms,
# rtol; kernels/measure.py max_err): TP and PP HuBERT at phase (a)'s
# HUBERT_CPU_TOL, EP at the repo's bar
MC_TOL = (1e-5, 0.0, 1e-3)
MC_LR = 1e-3             # TrainConfig().lr: Adam's first step is ~lr sign(g)
MC_BF16_BN_RTOL = 5e-2   # bf16 BatchNorm statistics, DP against one card
# Two steps that apply the same update math to the same fp32 gradients
# (DP or ZeRO-1 at world size 1 against one card, ZeRO-1 against DP on the
# same ranks) leave all but a few weights within 1e-6 of each other: the
# runs read 0.9995 (H100 80GB HBM3, 700 W), the rest a
# gradient near 0 whose sign the card's nondeterministic backward flips.
# A ZeRO-1 block applied to the wrong parameters moves about half of them.
MC_SAME_UPDATE_NEAR = 0.999


def mc_bf16_zero_atol(one_card: dict, exact: dict) -> float:
    """grad_agreement's bar for the leaves whose fp64 gradient is 0 (biases
    ahead of a train-mode BatchNorm), in a bf16 step: the bf16 rounding the
    one-card bf16 step leaves there, GRAD_LEAF_RATIO times as for every
    other leaf, and at least the fp32 bar (1e-5). A bf16 step leaves
    bf16-sized residues there (2^-16 = 1.53e-5 on the DP step, H100
    80GB HBM3, 700 W)."""
    from calipsync_tpu_torch.kernels.measure import GRAD_LEAF_RATIO

    zeros = [float(one_card[k].abs().max()) for k, g in exact.items()
             if float(g.double().norm()) < 1e-7]
    return max(1e-5, GRAD_LEAF_RATIO * max(zeros, default=0.0))


def mc_frames(model, data, feats, fmt, mesh=None):
    """Every frame of one FrameSynthesizer request (uint8, stacked) and its
    wall seconds."""
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer

    synth = FrameSynthesizer(None, data, model=model, batch_size=BATCH,
                             seed=0, transfer_format=fmt, mesh=mesh)
    t0 = time.perf_counter()
    frames = np.stack([it["frame"] for it in
                       synth.iterate_synthesized_frames(feats)])
    wall = time.perf_counter() - t0
    synth.close()
    return frames, wall


def mc_lsb(a, b, what: str) -> dict:
    """Frames against the one-card frames at the batch-invariance bound."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    worst, share = int(d.max()), float((d > 0).mean())
    print(f"{what}: max {worst} uint8 levels, {share:.3g} of values differ "
          f"(limits {HEAD_BATCH_MAX_LSB}, {HEAD_BATCH_MAX_SHARE})")
    check(a.shape == b.shape and worst <= HEAD_BATCH_MAX_LSB
          and share <= HEAD_BATCH_MAX_SHARE, f"{what}: frames differ")
    return {"max_lsb": worst, "share": share}


def mc_step(torch, sd, batch, feats, dtype, mesh=None, zero1=False,
            ops="kernels", params=None):
    """One host-batch train step (B=16 global, no perceptual term) from
    ``sd``: loss, gradients, state after (CPU fp32), and the second
    step's ms (the first pays the card's warm-up). Under ZeRO-1 a
    parameter's ``.grad`` is the rank's own; the mean gradient is read
    from the gathered first moment, (1 - b1) g after the first step."""
    from calipsync_tpu_torch.config import TrainConfig
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.train import trainer

    pdt = params or torch.float32
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, zero1=zero1)
    model = Generator(dtype=dtype, ops=ops)
    model.load_state_dict(sd, strict=True)
    model.to("cuda", pdt)
    state = (trainer.create_zero1_state(model, tcfg, mesh) if zero1
             else trainer.create_train_state(model, tcfg))
    step = trainer.make_train_step(tcfg, mesh)
    f = torch.from_numpy(feats).to("cuda", pdt)
    m = step(state, batch, f)
    loss = float(m["loss"])
    if zero1:
        moments = state.optimizer.state_dict()["state"]  # every rank
        grads = {n: moments[i]["exp_avg"].float().cpu() / 0.1
                 for i, (n, _) in enumerate(model.named_parameters())}
    else:
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
    after = {k: v.detach().float().cpu()
             for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch, f)
    torch.cuda.synchronize()
    return dict(loss=loss, grads=grads, state=after,
                ms=(time.perf_counter() - t0) * 1e3, step=state)


def mc_same_step(torch, got: dict, ref: dict, what: str, loss_rtol: float,
                 exact=None, bn_rtol: float = 1e-3,
                 min_near: float = 0.0, zero_atol: float = 1e-5) -> dict:
    """A step against the one-card step: the loss, BatchNorm statistics,
    every weight within Adam's first-step envelope (up to 2 lr where the
    gradients' signs differ: fp32 gradients of this random network carry
    percents of rounding noise, and two runs of one step on the card
    differ as much, phase 7b), at least ``min_near`` of the weights within
    1e-6 (MC_SAME_UPDATE_NEAR where both steps apply one update to the same
    gradients), and, with an fp64 yardstick, every gradient leaf
    (grad_agreement: as close to fp64 as the one-card step's; a leaf whose
    fp64 gradient is 0 within ``zero_atol``, mc_bf16_zero_atol in bf16).
    ``bn_rtol``: the statistics' bar, 1e-3 (the repo's) in fp32; in bf16
    rounding flips compound over the blocks (GEN_BF16_*)."""
    from calipsync_tpu_torch.kernels.measure import grad_agreement

    check(abs(got["loss"] - ref["loss"]) <= loss_rtol * abs(ref["loss"]),
          f"{what}: loss {got['loss']} against {ref['loss']}")
    worst_w, near, total, worst_bn = 0.0, 0, 0, 0.0
    for k, r in ref["state"].items():
        d = (got["state"][k] - r).abs()
        if k.endswith(("running_mean", "running_var")):
            # the repo's bar, its absolute part a share of the buffer's rms
            # (running means sit near 0)
            lim = bn_rtol * (r.pow(2).mean().sqrt() + r.abs()) + 1e-7
            worst_bn = max(worst_bn, float((d / lim).max()))
        elif not k.endswith("num_batches_tracked"):
            worst_w = max(worst_w, float(d.max()))
            near += int((d <= 1e-6).sum())
            total += d.numel()
    res = dict(loss=got["loss"], ref_loss=ref["loss"], max_weight_diff=
               worst_w, weights_within_1e6=near / total,
               bn_share_of_bar=worst_bn)
    line = (f"{what}: loss {got['loss']:.6f} vs {ref['loss']:.6f}; weights "
            f"max diff {worst_w:.3g} (envelope {2 * MC_LR:g}), "
            f"{near / total:.5f} within 1e-6; BN statistics at "
            f"{worst_bn:.3g} of the bar")
    if exact is not None:
        agree = grad_agreement(got["grads"], ref["grads"], exact,
                               zero_atol=zero_atol)
        zero = max((v[0] for v in agree["zeros"].values()), default=0.0)
        zero_ref = max((v[1] for v in agree["zeros"].values()), default=0.0)
        res.update(rms=agree["rms"], rms_one_card=agree["rms_plain"],
                   zero_leaves_max=zero, zero_leaves_max_one_card=zero_ref)
        line += (f"; gradients' rms error to fp64 {agree['rms']:.3g} "
                 f"(one card {agree['rms_plain']:.3g}), leaves with a zero "
                 f"fp64 gradient at most {zero:.3g} (one card "
                 f"{zero_ref:.3g}, bar {zero_atol:.3g})")
    print(line)
    check(worst_w <= 2 * MC_LR * (1 + 1e-3) + 1e-5,
          f"{what}: weights outside Adam's envelope")
    check(near / total >= min_near, f"{what}: {near / total:.5f} of the "
                                    f"weights within 1e-6, under {min_near}")
    check(worst_bn <= 1, f"{what}: BatchNorm statistics differ")
    if exact is not None:
        check(agree["ok"], f"{what}: gradients disagree: "
                           + "; ".join(agree["bad"][:5]))
    return res


def mc_multi_step(torch, sd, feats, mesh, what: str, k: int,
                  graphed: bool):
    """K resident DP steps a dispatch over ``mesh`` (fp32, B=16 global,
    no perceptual term, a random store of 64 crops) against K per-step DP
    calls from the same state (with the captured Adam update where the
    dispatch is a graph), under deterministic algorithms
    (within_spread); ``graphed``: whether the
    dispatch must be a CUDA graph replay (NCCL) or eager (gloo).
    Returns the comparison and the dispatch's launch counts."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.config import TrainConfig
    from calipsync_tpu_torch.nn.unet import Generator
    from calipsync_tpu_torch.train import trainer

    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    rng = np.random.default_rng(7)
    store = torch.from_numpy(rng.integers(0, 256, (64, 160 * 160 * 3),
                                          dtype=np.uint8)).cuda()
    block = rng.integers(0, 64, (3, k, TRAIN_BATCH)).astype(np.int32)
    f = torch.from_numpy(feats).cuda()

    def state():
        model = Generator(dtype=torch.float32)
        model.load_state_dict(sd, strict=True)
        return trainer.create_train_state(model.cuda(), tcfg)

    def snapshot(st):
        return {n: v.detach().float().cpu()
                for n, v in st.model.state_dict().items()}

    def per_step():
        st = state()
        if graphed:  # the update a graph captures
            st.optimizer.make_capturable()
        step = trainer.make_resident_train_step(tcfg, mesh=mesh)
        loss = [float(step(st, store, *block[:, i], f)["loss"])
                for i in range(k)]
        return dict(loss=loss, state=snapshot(st))

    with deterministic(torch):
        a, b = per_step(), per_step()
        st = state()
        fn = trainer.make_resident_multi_step(tcfg, mesh=mesh)
        kernels.reset_launches()
        m = fn(st, store, *block, f)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        replayed = kernels.cross_attention.replayed
        got = dict(loss=m["loss"].tolist(), state=snapshot(st))
    print(f"{what}: a K={k} dispatch ran "
          + ("as one CUDA graph replay" if fn.graphed else
             "eagerly (gloo stages collectives through host memory, "
             "which a CUDA graph cannot capture)"))
    check(fn.graphed == graphed and st.step == k,
          f"{what}: graphed {fn.graphed}, step {st.step}")
    steps = k + (trainer.GRAPH_WARMUP_STEPS if graphed else 0)
    check(counts == {n: c * steps for n, c in TRAIN_LAUNCHES.items()},
          f"{what}: launches {counts}")
    res = within_spread(torch, got, a, b, f"{what}, deterministic", k)
    res.update(graphed=fn.graphed, replayed=replayed)
    return res, counts


def mc_rank(data: str, hubert_dir: str, seed: int) -> dict:
    """(12b) One of two gloo ranks sharing the card: every parallel path at
    full width, each held against the one-card run that rank 0 makes
    itself; the kernel launches of the parallel paths only."""
    import torch

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.audio.hubert_pipeline import load_hf_checkpoint
    from calipsync_tpu_torch.core import mesh as meshlib
    from calipsync_tpu_torch.core.ep import (init_moe_params, moe_ffn,
                                             moe_ffn_ep)
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  random_jax_generator)
    from calipsync_tpu_torch.dryrun import run_sections
    from calipsync_tpu_torch.kernels.measure import (max_err,
                                                     random_generator,
                                                     tol_text)
    from calipsync_tpu_torch.serve.multi_stream import MultiStreamSynthesizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshlib.make_mesh(data=2)
    emesh = meshlib.make_named_mesh((2,), ("expert",))
    rank = meshlib.process_index()
    lead = rank == 0
    res: dict = {"seconds": {}, "launches": {}}
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        torch.cuda.synchronize()
        res["seconds"][name] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()

    def counted(name, fn):
        kernels.reset_launches()
        value = fn()
        torch.cuda.synchronize()
        res["launches"][name] = kernels.launch_counts()
        return value

    # sharded serving at B=128 (64 rows a rank), bgr
    model = random_generator(torch.bfloat16)
    rng = np.random.default_rng(seed + 120)
    feats = rng.standard_normal((MC_ROWS, 2, 1024)).astype(np.float32)
    mc_frames(model, data, feats[:BATCH], "bgr", mesh)  # warm-up
    frames, wall = counted("serve", lambda: mc_frames(model, data, feats,
                                                       "bgr", mesh))
    res["serve_fps"] = MC_ROWS / wall
    if lead:
        one, _ = mc_frames(model, data, feats, "bgr")
        res["serve"] = mc_lsb(frames, one, "12b sharded serving (2 ranks)")
    res["serve_hash"] = hashlib.sha1(frames.tobytes()).hexdigest()
    part("serving")

    # one MultiStreamSynthesizer(mesh=) tick
    ids = [f"s{i}" for i in range(MC_STREAMS)]
    tick = {sid: rng.standard_normal((MS_WINDOW, 2, 1024)).astype(
        np.float32) for sid in ids}

    def ms_tick(m):
        ms = MultiStreamSynthesizer(None, [data], model=model,
                                    batch_size=BATCH, mesh=m)
        for sid in ids:
            ms.add_stream(sid)
        got = ms.synthesize_windows(tick)
        ms.close()
        return np.stack([f["frame"] for sid in ids for f in got[sid]])

    ms_frames = counted("multistream", lambda: ms_tick(mesh))
    if lead:
        res["multistream"] = mc_lsb(ms_frames, ms_tick(None),
                                    "12b multi-stream tick (2 ranks)")
    part("multistream")
    del model, frames, ms_frames
    torch.cuda.empty_cache()

    # data-parallel steps, 8 + 8 rows with sync-BN, against one card at 16
    batch, tfeats = train_batch(6)
    sd = from_jax_generator(random_jax_generator(seed=0))
    steps = {}
    if lead:
        steps["one64"] = mc_step(torch, sd, batch, tfeats, torch.float64,
                                 ops="plain", params=torch.float64)
        for dt in (torch.float32, torch.bfloat16):
            steps[f"one_{str(dt)[6:]}"] = mc_step(torch, sd, batch, tfeats,
                                                  dt)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        steps[f"dp_{name}"] = counted(f"dp_{name}", lambda: mc_step(
            torch, sd, batch, tfeats, dt, mesh))
    steps["zero1"] = counted("zero1", lambda: mc_step(
        torch, sd, batch, tfeats, torch.float32, mesh, zero1=True))
    res["multi_step"], res["launches"]["multi_step"] = mc_multi_step(
        torch, sd, tfeats, mesh, f"12b rank {rank} DP (gloo, 2 ranks)", 2,
        graphed=False)
    res["dp_step_ms"] = {k: steps[k]["ms"] for k in
                         ("dp_float32", "dp_bfloat16", "zero1")}
    if lead:
        exact = steps["one64"]["grads"]
        res["dp"] = {
            "float32": mc_same_step(torch, steps["dp_float32"],
                                    steps["one_float32"],
                                    "12b DP fp32 (8+8 rows)", 1e-4, exact),
            "bfloat16": mc_same_step(torch, steps["dp_bfloat16"],
                                     steps["one_bfloat16"],
                                     "12b DP bf16 (8+8 rows)", 1e-2, exact,
                                     bn_rtol=MC_BF16_BN_RTOL,
                                     zero_atol=mc_bf16_zero_atol(
                                         steps["one_bfloat16"]["grads"],
                                         exact)),
            "zero1": mc_same_step(torch, steps["zero1"], steps["dp_float32"],
                                  "12b ZeRO-1 against DP (fp32)", 1e-4,
                                  exact, min_near=MC_SAME_UPDATE_NEAR)}
        kept = steps["zero1"]["step"].optimizer.moment_bytes()
        full = sum(p.numel() * 8 for p in steps["one_float32"][
            "step"].model.parameters())
        res["zero1_moment_bytes"] = [kept, full]
        print(f"12b ZeRO-1: {kept} bytes of Adam moments a rank, the mean "
              f"path {full}")
        check(full / 2 <= kept <= full / 2 + 8, "ZeRO-1 keeps its half")
    del steps
    torch.cuda.empty_cache()
    part("data parallel, zero1")

    # TP and PP HuBERT-large on one 20 s chunk against one card
    wav = np.random.default_rng(seed + 121).standard_normal(
        MC_CHUNK).astype(np.float32) * 0.1
    if lead:
        ref = torch.from_numpy(load_hf_checkpoint(
            hubert_dir).extract_features(wav))
    for mode in ("tp", "pp"):
        ex = load_hf_checkpoint(hubert_dir, mesh=meshlib.make_named_mesh(
            (2,), ("model",)), parallel=mode)
        got = torch.from_numpy(ex.extract_features(wav))
        del ex
        if lead:
            err, ok = max_err(got, ref, HUBERT_CPU_TOL)
            print(f"12b HuBERT-large {mode} (2 ranks), a 20 s chunk "
                  f"{tuple(got.shape)}: max abs err {err:.3g} "
                  f"({tol_text(HUBERT_CPU_TOL)})")
            check(got.shape == ref.shape and ok, f"HuBERT {mode} disagrees")
            res[f"hubert_{mode}_err"] = err
    torch.cuda.empty_cache()
    part("tp, pp hubert")

    # EP at HuBERT-large width against the one-device math
    params = {k: v.cuda() for k, v in init_moe_params(
        1024, 4096, MC_EXPERTS, seed=seed).items()}
    tok = torch.from_numpy(np.random.default_rng(seed + 122).standard_normal(
        (MC_TOKENS, 1024)).astype(np.float32)).cuda()
    got = moe_ffn_ep(params, tok, emesh)
    if lead:
        err, ok = max_err(got, moe_ffn(params, tok, groups=2), MC_TOL)
        print(f"12b EP, {MC_EXPERTS} experts of 1024x4096 over 2 ranks, "
              f"{MC_TOKENS} tokens: max abs err {err:.3g} "
              f"({tol_text(MC_TOL)})")
        check(ok, "EP disagrees with moe_ffn")
        res["ep_err"] = err
    del params
    part("ep")

    res["dryrun"] = counted("dryrun", lambda: run_sections(2, "cuda"))
    part("dryrun_multichip(2)")
    return res


def multi_card(torch, assets, seed: int, out: dict) -> dict:
    """(12) Many cards. (a) NCCL at world size 1 on this card, the
    production backend: build_mesh, FrameSynthesizer(mesh=) bgr and yuv420
    frames equal to the unsharded ones, a DP step with sync-BN and a
    ZeRO-1 step against the one-card step. (b) two gloo ranks spawned on
    this card (NCCL refuses two ranks on one device): mc_rank. Returns
    the launch counts of each parallel path."""
    import torch.distributed as dist

    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.config import MeshConfig
    from calipsync_tpu_torch.core import mesh as meshlib
    from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                                  random_jax_generator)

    res = out["multi_card"] = {"seconds": {}}
    paths = {}
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"compute mode: {mode}")
    res["compute_mode"] = mode
    check(mode.splitlines()[0].strip() == "Default",
          f"the card's compute mode is {mode!r}: 12b runs two processes on "
          "it and needs 'Default'")

    t0 = time.perf_counter()
    model, data = assets["model"], assets["data"]
    feats = np.random.default_rng(seed + 120).standard_normal(
        (MC_ROWS, 2, 1024)).astype(np.float32)
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = meshlib.build_mesh(MeshConfig())
            check(mesh.axis_names == ("data",) and mesh.size == 1
                  and dist.get_backend() == "nccl", f"12a mesh {mesh.shape}")
            for fmt in ("bgr", "yuv420"):
                mc_frames(model, data, feats[:BATCH], fmt, mesh)  # warm-up
                one, one_wall = mc_frames(model, data, feats, fmt)
                kernels.reset_launches()
                got, wall = mc_frames(model, data, feats, fmt, mesh)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                expect_forwards(counts, f"12a sharded serving {fmt}", 2)
                paths[f"12a_serve_{fmt}"] = counts
                check(np.array_equal(got, one),
                      f"12a sharded {fmt} frames differ from unsharded")
                res[f"serve_fps_{fmt}"] = [MC_ROWS / wall, MC_ROWS / one_wall]
                print(f"12a sharded serving {fmt} (NCCL, 1 rank): "
                      f"{MC_ROWS} frames equal to unsharded; "
                      f"{MC_ROWS / wall:.1f} fps (unsharded "
                      f"{MC_ROWS / one_wall:.1f})")
            # fp32 steps against fp64 hold true fp32: TF32 off, as in 7b
            flags = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            batch, tfeats = train_batch(6)
            sd = from_jax_generator(random_jax_generator(seed=0))
            exact = mc_step(torch, sd, batch, tfeats, torch.float64,
                            ops="plain", params=torch.float64)["grads"]
            one = mc_step(torch, sd, batch, tfeats, torch.float32)
            for zero1 in (False, True):
                name = "zero1" if zero1 else "dp"
                kernels.reset_launches()
                got = mc_step(torch, sd, batch, tfeats, torch.float32, mesh,
                              zero1=zero1)
                torch.cuda.synchronize()
                paths[f"12a_{name}"] = kernels.launch_counts()
                res[f"{name}_step_ms"] = [got["ms"], one["ms"]]
                res[name] = mc_same_step(torch, got, one,
                                         f"12a {name} (NCCL, 1 rank, fp32)",
                                         1e-6, exact,
                                         min_near=MC_SAME_UPDATE_NEAR)
            del one, got, exact
            res["multi_step"], paths["12a_multi_step"] = mc_multi_step(
                torch, sd, tfeats, mesh, "12a DP (NCCL, 1 rank, fp32)",
                MULTI_K, graphed=True)
            REPLAYED["12a_multi_step"] = res["multi_step"]["replayed"]
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    res["seconds"]["12a"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    ranks = meshlib.launch(mc_rank, 2, data, assets["hubert"], seed,
                           backend="gloo")
    res["seconds"]["12b"] = round(time.perf_counter() - t0, 1)
    check(ranks[0]["serve_hash"] == ranks[1]["serve_hash"],
          "12b: the ranks returned different frames")
    for r, rr in enumerate(ranks):
        total = {k: sum(c[k] for c in rr["launches"].values())
                 for k in KERNEL_INFO}
        print(f"12b rank {r}: launches {total} ({rr['launches']}), parts "
              f"{rr['seconds']}")
        check(all(total.values()), f"12b rank {r} did not launch every "
                                   f"kernel: {total}")
        paths[f"12b_rank{r}"] = total
    lead = ranks[0]
    res["12b"] = {k: v for k, v in lead.items() if k != "serve_hash"}
    print(f"12b: sharded serving {lead['serve_fps']:.1f} fps a rank's "
          f"request (2 ranks on one card); DP step ms {lead['dp_step_ms']}; "
          f"12a + 12b {res['seconds']}")
    return paths


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


def audio_to_video(torch, seed: int, metrics: dict, tmp: str):
    """Phases (a)-(d) in ``tmp``; returns the launch counts of each path
    that runs the generator, each read from counters set to 0 just before
    it, the HuBERT-large extractor, and what the live and evaluation
    phases reuse (the bf16 generator, the speaker, 6b's sequential mp4,
    6d's checkpoints)."""
    from calipsync_tpu_torch.audio.io import save_wav
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker
    from calipsync_tpu_torch.kernels.measure import random_generator

    os.makedirs(tmp)
    ex, long, feats = hubert_phase(torch, seed, metrics)
    model = random_generator(torch.bfloat16)
    data = make_synthetic_speaker(tmp, n_frames=40, res=480)
    wav = os.path.join(tmp, "speech65.wav")
    save_wav(wav, long, 16_000)
    paths = offline_phase(torch, ex, wav, len(long), model, data, tmp,
                          metrics)
    batch_invariance(model, data, feats, metrics)
    paths["streaming"] = streaming_phase(torch, ex, model, data, tmp,
                                         seed, metrics)
    paths["cli_infer"] = cli_phase(torch, ex, data, tmp, seed, metrics)
    assets = dict(model=model, data=data,
                  offline_mp4=os.path.join(tmp, "sequential.mp4"),
                  ckpt=os.path.join(tmp, "generator.pth"),
                  hubert=os.path.join(tmp, "hubert"))
    return paths, ex, assets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic wavs")
    ap.add_argument("--run-exported", default=None, metavar="DIR",
                    help="(the child process of phase 11b)")
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
    if args.run_exported:
        return run_exported(args.run_exported)
    # the kernels' fp32 checks hold true fp32 plain versions: TF32 off
    # until the audio phases
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    with phase("kernel build"):
        _, build_s = _build.build(force=True)
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources in parallel)")
    print_kernel_resources(_build)

    timer = measure.Timer()
    table = measure.kernel_table()
    with phase("1-3 kernels, generator, launch times"):
        check_errors = check_kernels(torch, table)
        calls, fwd_ms = run_generator(torch, timer)
        totals, per_launch, failures = measure.time_launches(table, calls,
                                                             timer)
    check(not failures, "; ".join(failures))
    del calls
    torch.cuda.empty_cache()
    with phase("4-5 serve, profile"):
        counts, metrics = serve(torch, timer)
    paths = {"serve": counts}
    # the audio phases run under PyTorch's default flags, as the CLI does
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    with tempfile.TemporaryDirectory() as work:
        with phase("6 audio in, video out"):
            audio_paths, ex, assets = audio_to_video(
                torch, args.seed, metrics, os.path.join(work, "audio"))
        paths.update(audio_paths)
        with phase("8 preprocessing, multi-stream"):
            ms_paths, clone = preprocess_and_serve(
                torch, ex, timer, args.seed, metrics,
                os.path.join(work, "clone"))
        paths.update(ms_paths)
        paths.update(live_output(torch, ex, assets, args.seed, metrics,
                                 os.path.join(work, "live")))
        del ex  # off the card before training measures its peak memory
        torch.cuda.empty_cache()
        with phase("7 training"):
            paths.update(training(torch, timer, args.seed, metrics))
        paths.update(evaluation(torch, assets, clone, args.seed, metrics,
                                os.path.join(work, "eval")))
        paths.update(tools(torch, assets, args.seed, metrics,
                           os.path.join(work, "tools")))
        with phase("12 many cards"):
            paths.update(multi_card(torch, assets, args.seed, metrics))

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
    # the training path: forward + backward through the kernel at B=16
    attention = next(k for k in kernels_line
                     if k["name"] == "cross_attention")
    attention["launches_in_graph_replays"] = sum(REPLAYED.values())
    attention["launches_in_graph_replays_by_path"] = REPLAYED
    attention["train_fwd_bwd_ms"] = {
        dt: {"ms": r["ms"], "plain_ms": r["plain_ms"]}
        for dt, r in metrics["attention_backward"].items()}
    detail = {"device": smi, "batch": BATCH, "per_launch": per_launch,
              "kernels": kernels_line, "generator_forward_ms": fwd_ms,
              "serving": metrics, "phase_seconds": PHASE_SECONDS}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump(detail, f, indent=1)
    print(f"phase seconds (wall): {json.dumps(PHASE_SECONDS)}")
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
