"""Command-line interface of the port (counterpart of every command of
calipsync_tpu/cli.py but ``export-torch``):

    python -m calipsync_tpu_torch.cli step1 --video v.mp4 --out data/ \\
        --weights face_weights/ --hubert hubert_dir/ [--audio v.wav]
    python -m calipsync_tpu_torch.cli step3 --video v.mp4 --out assets/ \\
        --weights face_weights/ [--xseg xseg.onnx] [--detect-stride N]
    python -m calipsync_tpu_torch.cli clone --video v.mp4 --out models/ \\
        --weights face_weights/ --hubert hubert_dir/ [--epochs N]
    python -m calipsync_tpu_torch.cli featurize --hubert hubert_dir/ \\
        --audio a.wav --out feats.npy
    python -m calipsync_tpu_torch.cli train --data step1_dir/ \\
        --save run/ [--vgg vgg19-dcbb9e9d.pth] [--base generator.pth]
    python -m calipsync_tpu_torch.cli infer --assets assets/infer_data \\
        --ckpt generator.pth --hubert hubert_dir/ --audio a.wav --out o.mp4
    python -m calipsync_tpu_torch.cli serve --assets assets/infer_data \\
        --ckpt generator.pth --hubert hubert_dir/ \\
        --player window|rtmp|file|virtualcam|null [--rtmp-url URL]
    python -m calipsync_tpu_torch.cli syncnet-train --data step1_dir/ \\
        --save syncnet_run/ [--mode hubert|wenet] [--base syncnet.pth]
    python -m calipsync_tpu_torch.cli eval --a a.mp4 --b b.mp4 \\
        [--lpips lpips_vgg.pth --lpips-trunk vgg16.pth --lpips-net vgg]
    python -m calipsync_tpu_torch.cli sync-score --lips-dir lips_jpg/ \\
        --features aud_hu.npy [--syncnet syncnet.pth]
    python -m calipsync_tpu_torch.cli cost --batch 1
    python -m calipsync_tpu_torch.cli verify-weights --weights-dir w/ \\
        [--generator g.pth] [--syncnet s.pth] [--hubert hubert_dir/] \\
        [--vgg vgg19.pth] [--lpips-trunk t.pth --lpips-heads h.pth] \\
        [--asr ctc_dir/]
    python -m calipsync_tpu_torch.cli slice --audio a.wav --out segs/ \\
        [--asr ctc_dir/] [--min-seconds 5 --max-seconds 12]

``--weights`` is the face-model directory in the reference's layout:
``mean_face.txt``, ``checkpoint_epoch_335.pth.tar`` (PFLD) and
``yolov8n_face_state_dict.pth`` (YOLOv8n-face, used when present) or
``sfd_face.pth`` (S3FD). ``--hubert`` is a local HF checkpoint directory
(``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``);
``--ckpt`` a generator state_dict in the reference torch layout (what the
JAX package's ``export-torch`` and the port's ``train`` write); ``--asr``
a local HF ``Wav2Vec2ForCTC`` directory (read without ``transformers``).
Every command runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_lip_detector(weights_dir: str, detect_stride: int = 1,
                       device=None):
    """A face-model directory -> LipDetector on ``device``. The detector
    follows the reference's priority: YOLOv8n-face when
    ``yolov8n_face_state_dict.pth`` (a plain ultralytics state_dict) is
    there, S3FD (``sfd_face.pth``) otherwise. PFLD comes from the
    landmark tar's ``pfld_backbone`` in the train form and is folded to
    the deploy form."""
    from calipsync_tpu_torch.core.weights import load_torch_state_dict
    from calipsync_tpu_torch.nn.pfld import fold_mobileone
    from calipsync_tpu_torch.nn.s3fd import S3FDDetector
    from calipsync_tpu_torch.nn.yolo import YoloV8FaceDetector
    from calipsync_tpu_torch.vision.lip_detector import (LipDetector,
                                                         load_mean_face)

    mean_face = load_mean_face(os.path.join(weights_dir, "mean_face.txt"))
    yolo_path = os.path.join(weights_dir, "yolov8n_face_state_dict.pth")
    if os.path.exists(yolo_path):
        detector = YoloV8FaceDetector(load_torch_state_dict(yolo_path),
                                      batch_size=16, device=device)
    else:
        detector = S3FDDetector(load_torch_state_dict(
            os.path.join(weights_dir, "sfd_face.pth")), device=device)
    pfld = load_torch_state_dict(
        os.path.join(weights_dir, "checkpoint_epoch_335.pth.tar"),
        key="pfld_backbone")
    # the reference's unused spatial-transformer branch
    pfld = {k: v for k, v in pfld.items()
            if not k.startswith("localization.")}
    return LipDetector(fold_mobileone(pfld), mean_face, detector,
                       detect_stride=detect_stride, device=device)


def build_hubert(hubert_path: str, device=None, mesh_cfg=None):
    """HF checkpoint dir -> extractor on ``device`` (fp32). ``mesh_cfg``
    (config.MeshConfig) with ``model > 1`` shards HuBERT over that many
    ranks, tensor- or pipeline-parallel (``hubert_parallel``): the command
    then runs as that many processes, one a card (torchrun or the
    CALIPSYNC_* variables, README), each with the same arguments."""
    from calipsync_tpu_torch.audio.hubert_pipeline import load_hf_checkpoint

    mesh = None
    if mesh_cfg is not None and mesh_cfg.model > 1:
        from calipsync_tpu_torch.core import mesh as meshlib

        meshlib.maybe_initialize_distributed()
        n = meshlib.world_size()
        if n != mesh_cfg.model:
            raise SystemExit(
                f"mesh.model={mesh_cfg.model} shards HuBERT over that many "
                f"ranks, but the process group has {n}: launch "
                f"{mesh_cfg.model} processes, one a card (torchrun "
                f"--nproc-per-node {mesh_cfg.model}, or the CALIPSYNC_* "
                f"variables)")
        mesh = meshlib.make_named_mesh((n,), (mesh_cfg.model_axis_name,))
    return load_hf_checkpoint(
        hubert_path, device=device, mesh=mesh,
        model_axis=mesh_cfg.model_axis_name if mesh_cfg else "model",
        parallel=mesh_cfg.hubert_parallel if mesh_cfg else "tp",
        pp_microbatches=(mesh_cfg.pp_microbatches or None)
        if mesh_cfg else None)


def load_generator(ckpt_path: str, cfg):
    """A reference-layout generator .pth (a bare state_dict or one wrapped
    as {'state_dict': ...}) -> the port's Generator, loaded strictly."""
    import torch

    from calipsync_tpu_torch.nn.unet import Generator

    if os.path.isdir(ckpt_path):
        raise SystemExit(
            f"{ckpt_path} is a directory (an Orbax checkpoint?): the port "
            "loads a torch .pth; write one with the JAX package's "
            "`python -m calipsync_tpu.cli export-torch --ckpt "
            f"{ckpt_path} --out generator.pth`")
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    model = Generator(cfg.model.n_channels, cfg.model.mode,
                      cfg.model.n_blocks, dtype=getattr(torch,
                                                        cfg.model.dtype))
    model.load_state_dict(sd, strict=True)
    return model


def _synthesizer(args, cfg, first_batch_size: int = 0):
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer

    synth = FrameSynthesizer(None, args.assets,
                             model=load_generator(args.ckpt, cfg),
                             batch_size=cfg.infer.batch_size, crop=cfg.crop,
                             seed=getattr(args, "seed", None),
                             transfer_format=cfg.infer.transfer_format,
                             first_batch_size=first_batch_size,
                             device=args.device)
    synth.sequencer.min_pct = cfg.infer.motion_min_pct
    synth.sequencer.max_pct = cfg.infer.motion_max_pct
    return synth


def _load_cfg(args):
    from calipsync_tpu_torch.config import load_config

    return load_config(args.config)


def cmd_step1(args):
    """Video -> step-1 training data directory."""
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor

    cfg = _load_cfg(args)
    lip = build_lip_detector(args.weights, device=args.device)
    try:
        out = TrainPreprocessor(
            lip, build_hubert(args.hubert, args.device),
            crop=cfg.crop).process_video(args.video, args.out,
                                         audio_path=args.audio)
    finally:
        lip.close()
    print(json.dumps(out))


def cmd_step3(args):
    """Video -> inference assets (``infer_data``)."""
    from calipsync_tpu_torch.pipelines.step3_prepare import \
        InferPreprocessor

    _load_cfg(args)  # raises on settings the port cannot honour
    mask_gen = None
    if args.xseg:
        from calipsync_tpu_torch.vision.xseg import XSegMaskGenerator

        mask_gen = XSegMaskGenerator(model_path=args.xseg)
    lip = build_lip_detector(args.weights, detect_stride=args.detect_stride,
                             device=args.device)
    try:
        out = InferPreprocessor(lip, mask_generator=mask_gen).process_video(
            args.video, args.out)
    finally:
        lip.close()
    print(json.dumps(out))


def cmd_clone(args):
    """Video -> fine-tuned generator and inference assets; prints their
    paths and each stage's seconds."""
    from calipsync_tpu_torch.config import load_config
    from calipsync_tpu_torch.pipelines.all_pipeline import clone_video_local

    train = {} if args.epochs is None else {"epochs": args.epochs}
    cfg = load_config(args.config, overrides={
        "train": train, "model": {"dtype": args.dtype}})
    timings: dict = {}
    lip = build_lip_detector(args.weights, device=args.device)
    try:
        generator, model_id = clone_video_local(
            args.video, args.out, lip, build_hubert(args.hubert, args.device),
            vgg_path=args.vgg, unet_checkpoint=args.base, cfg=cfg,
            timings=timings, device=args.device)
    finally:
        lip.close()
    print(json.dumps({"generator": generator, "model_id": model_id,
                      "infer_data": os.path.join(args.out, model_id,
                                                 "infer_data"),
                      "timings": timings}))


def cmd_featurize(args):
    """Audio file -> HuBERT feature rows .npy."""
    import numpy as np

    cfg = _load_cfg(args)
    ex = build_hubert(args.hubert, device=args.device, mesh_cfg=cfg.mesh)
    feats = ex.extract_from_file(args.audio)
    if ex.mesh is not None and ex.mesh.axis_index(ex.model_axis) != 0:
        return  # every rank holds the features; the first writes them
    np.save(args.out, feats)
    print(json.dumps({"out": args.out, "rows": int(feats.shape[0]),
                      "shape": list(feats.shape),
                      "device": str(ex.device)}))


def cmd_train(args):
    """Fine-tune the generator on a step-1 directory; prints the path of
    the ``generator.pth`` it writes."""
    from calipsync_tpu_torch.config import load_config
    from calipsync_tpu_torch.pipelines.step2_train import (
        GENERATOR_FILE, train_digital_model)

    train = {k: v for k, v in (("grad_accum", args.grad_accum),
                               ("remat", args.remat), ("zero1", args.zero1),
                               ("epochs", args.epochs)) if v is not None}
    cfg = load_config(args.config, overrides={
        "train": train, "model": {"dtype": args.dtype}})
    train_digital_model(args.data, args.save, vgg_path=args.vgg,
                        unet_checkpoint=args.base, cfg=cfg,
                        resume=args.resume, device=args.device)
    print(os.path.join(args.save, GENERATOR_FILE))


def cmd_infer(args):
    """Audio file -> lip-synced mp4 with the audio muxed in."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.pipelines.inference import VideoStreamManager

    cfg = _load_cfg(args)
    synth = _synthesizer(args, cfg)
    mgr = VideoStreamManager(synth, build_hubert(args.hubert, args.device),
                             fps=cfg.infer.fps, pipelined=args.pipelined)
    kernels.reset_launches()
    try:
        out = mgr.process_single_file(args.audio, args.out)
    finally:
        synth.close()
    out["kernel_launches"] = kernels.launch_counts()
    out["device"] = str(synth.device)
    print(json.dumps(out))


def build_player(args, fps: int):
    """The ``--player`` of ``serve``, clocked at the stream manager's
    24 kHz output."""
    from calipsync_tpu_torch.serve.players import (FilePlayer, NullPlayer,
                                                   RTMPPlayer,
                                                   VirtualCamPlayer,
                                                   WindowPlayer)

    kw = dict(fps=fps, sample_rate=24_000)
    if args.player == "window":
        return WindowPlayer(**kw)
    if args.player == "rtmp":
        if not args.rtmp_url:
            raise SystemExit("--player rtmp needs --rtmp-url")
        return RTMPPlayer(args.rtmp_url, args.width, args.height, **kw)
    if args.player == "file":
        return FilePlayer(args.out or "stream.mp4", realtime=True, **kw)
    if args.player == "virtualcam":
        return VirtualCamPlayer(device=args.cam_device, width=args.width,
                                height=args.height, **kw)
    return NullPlayer(**kw)


def cmd_serve(args):
    """Real-time streaming: watches a directory for audio files.

    Drop ``<name>.wav`` into --watch to queue it (prefix ``danmu_`` for
    the high-priority queue); the avatar idles on silence otherwise.
    Logs through ``calipsync.serve`` (stderr), the process metrics on
    stop. Stops on Ctrl-C (SIGINT); the file player then writes its mp4,
    and the last line of stdout is a JSON summary (frames, producer
    errors, kernel launches).
    """
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.metrics import get_logger, global_metrics
    from calipsync_tpu_torch.serve.players import FilePlayer
    from calipsync_tpu_torch.serve.stream_manager import \
        StreamingVideoManager

    log = get_logger("calipsync.serve")
    cfg = _load_cfg(args)
    player = build_player(args, cfg.infer.fps)
    synth = _synthesizer(args, cfg, cfg.infer.first_window_batch)
    sample_rate = player.SAMPLE_RATE
    mgr = StreamingVideoManager(
        synth, build_hubert(args.hubert, args.device), player,
        buffer_threshold=int(cfg.infer.fps * cfg.infer.buffer_threshold_s),
        output_sample_rate=sample_rate, fps=cfg.infer.fps,
        is_interrupt=args.interrupt)
    log.info("warming up...")
    mgr.warmup()
    kernels.reset_launches()
    mgr.start_playing()
    log.info("serving; drop .wav files into %s (danmu_* = priority)",
             args.watch)
    os.makedirs(args.watch, exist_ok=True)
    seen = set()
    try:
        while True:
            for f in sorted(os.listdir(args.watch)):
                if not f.endswith(".wav") or f in seen:
                    continue
                seen.add(f)
                queue = "danmu" if f.startswith("danmu_") else "normal"
                n = mgr.add_audio_to_queue(os.path.join(args.watch, f),
                                           queue_name=queue)
                log.info("queued %s -> %s (%d frames)", f, queue, n)
            time.sleep(0.2)
    except KeyboardInterrupt:
        log.info("stopping; metrics: %s",
                 json.dumps(global_metrics().snapshot()))
    finally:
        mgr.close()
        synth.close()
        if isinstance(player, FilePlayer) and player.frames:
            log.info("wrote %s", player.finalize())
    print(json.dumps({"frames_uploaded": mgr.frames_uploaded,
                      "producer_errors": mgr.producer_errors,
                      "kernel_launches": kernels.launch_counts(),
                      "device": str(synth.device)}), flush=True)


def cmd_cost(args):
    """The generator's FLOP count (GFLOP, one eval forward at --batch),
    through the kernels' registered formulas on the card."""
    from calipsync_tpu_torch.profiling import generator_cost

    print(json.dumps(generator_cost(batch=args.batch,
                                    device=args.device)["gflops"]))


def cmd_verify_weights(args):
    """Load every given checkpoint into the port's modules on the device
    and report key coverage + parameter counts (verify_weights.py); exits
    1 on a loader error or unconsumed keys."""
    from calipsync_tpu_torch.verify_weights import verify_weights

    reports = verify_weights(
        weights_dir=args.weights_dir, generator=args.generator,
        generator_mode=args.mode, syncnet=args.syncnet,
        hubert=args.hubert, vgg=args.vgg,
        lpips_trunk=args.lpips_trunk, lpips_heads=args.lpips_heads,
        asr=args.asr, device=args.device)
    print(json.dumps(reports, indent=2))
    bad = [r for r in reports if r["status"] in ("error",
                                                 "unconsumed-keys")]
    raise SystemExit(1 if bad else 0)


def cmd_slice(args):
    """Slice an audio file into speech segments ({i}.wav + {i}.txt): the
    energy VAD, or with --asr the CTC recognizer on the device."""
    from calipsync_tpu_torch.audio.slicer import process_and_split_audio

    asr_fn = None
    if args.asr:
        from calipsync_tpu_torch.audio.asr import load_hf_ctc_checkpoint

        asr_fn = load_hf_ctc_checkpoint(args.asr,
                                        device=args.device).as_asr_fn()
    segs = process_and_split_audio(args.audio, args.out,
                                   min_seconds=args.min_seconds,
                                   max_seconds=args.max_seconds,
                                   asr_fn=asr_fn)
    print(json.dumps({"segments": len(segs)}))


def cmd_syncnet_train(args):
    """Train the SyncNet evaluator on a step-1 directory; the last line is
    a JSON summary: the losses, the first step's seconds, samples/s over
    the later steps that end no epoch, the seconds of each step that ends
    one (its ``best/`` and ``last/`` checkpoint writes included), and on
    the card the peak memory."""
    import torch

    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.train.syncnet_trainer import (SyncNetDataset,
                                                           train_sync_net)

    dev = resolve_device(args.device)
    per_epoch = len(SyncNetDataset(args.data, args.mode))
    last = None
    steps = 0
    steady_s, steady_samples, epoch_end_s = 0.0, 0, []
    t0 = t_prev = time.perf_counter()
    for (batch_idx, total, epoch, epochs, loss, best,
         elapsed) in train_sync_net(
            args.save, args.data, mode=args.mode,
            batch_size=args.batch_size, lr=args.lr, epochs=args.epochs,
            base_last_model=args.base, seed=args.seed, device=dev):
        now = time.perf_counter()
        if steps == 0:
            first_step_s = now - t0
        elif batch_idx == total - 1:
            epoch_end_s.append(round(now - t_prev, 3))
        else:
            steady_s += now - t_prev
            steady_samples += args.batch_size
        t_prev = now
        steps += 1
        last = (epoch, epochs, loss, best)
        if args.log_every and batch_idx % args.log_every == 0:
            print(f"epoch {epoch + 1}/{epochs} batch {batch_idx}/{total} "
                  f"loss {loss:.4f} best {best:.4f} ({elapsed:.0f}s)",
                  flush=True)
    if last is None:
        raise SystemExit("empty dataset")
    out = {"save_dir": args.save, "epochs": last[1],
           "final_loss": round(float(last[2]), 6),
           "best_loss": round(float(last[3]), 6), "steps": steps,
           "samples_per_epoch": per_epoch,
           "first_step_s": round(first_step_s, 3),
           "samples_per_s": (round(steady_samples / steady_s, 2)
                             if steady_samples else None),
           "epoch_end_steps_s": epoch_end_s}
    if dev.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(out))


def _read_frames(path: str, limit: int, size=None) -> list:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < limit:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f if size is None else cv2.resize(f, size))
    cap.release()
    return frames


def cmd_sync_score(args):
    """LSE-style lip-sync scoring of a generated video against its audio
    features (SyncNet offset scan, eval.sync_metrics)."""
    import glob

    import cv2
    import numpy as np

    from calipsync_tpu_torch.eval import sync_metrics
    from calipsync_tpu_torch.nn.syncnet import load_syncnet, random_syncnet

    if not args.lips_dir and not args.video:
        raise SystemExit("pass --video or --lips-dir")
    if args.lips_dir:
        paths = sorted(glob.glob(os.path.join(args.lips_dir, "*.jpg")))
        if args.max_frames:
            paths = paths[:args.max_frames]
        if not paths:
            raise SystemExit(f"no *.jpg crops in {args.lips_dir}")
        imgs = []
        for p in paths:
            img = cv2.imread(p)
            if img is None:
                raise SystemExit(f"unreadable image: {p}")
            imgs.append(cv2.resize(img, (160, 160)))
        crops = np.stack(imgs)
    else:
        frames = _read_frames(args.video, args.max_frames, (160, 160))
        if not frames:
            raise SystemExit(f"no frames in {args.video}")
        crops = np.stack(frames)

    feats = np.load(args.features)
    if args.syncnet:
        model = load_syncnet(args.syncnet, mode=args.mode,
                             device=args.device)
    else:
        model = random_syncnet(mode=args.mode, device=args.device)
    report = sync_metrics(model, crops, feats, mode=args.mode,
                          max_offset=args.max_offset)
    report["weights"] = args.syncnet or "random-init (relative scores only)"
    print(json.dumps(report, indent=2))


def cmd_eval(args):
    """Frame-wise PSNR (and LPIPS with --lpips) between two videos."""
    import numpy as np

    from calipsync_tpu_torch.eval import batch_psnr

    fa = _read_frames(args.a, args.max_frames)
    fb = _read_frames(args.b, args.max_frames)
    n = min(len(fa), len(fb))
    if n == 0:
        raise SystemExit("no comparable frames")
    a = np.stack(fa[:n])
    b = np.stack(fb[:n])
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    scores = batch_psnr(a, b)

    def fin(x):  # bit-identical frames -> infinite PSNR -> null
        return round(float(x), 3) if np.isfinite(x) else None

    out = {"n_frames": n,
           "psnr_db_mean": fin(np.mean(scores)),
           "psnr_db_min": fin(np.min(scores))}
    if args.lpips:
        if not args.lpips_trunk:
            raise SystemExit("--lpips also needs --lpips-trunk "
                             "(torchvision vgg16/alexnet checkpoint)")
        from calipsync_tpu_torch.core.weights import load_torch_state_dict
        from calipsync_tpu_torch.eval import lpips_distance
        from calipsync_tpu_torch.nn.lpips import load_lpips

        model = load_lpips(load_torch_state_dict(args.lpips_trunk),
                           load_torch_state_dict(args.lpips),
                           net=args.lpips_net, device=args.device)
        # LPIPS weights are RGB-trained; cv2 frames are BGR
        ra, rb = a[..., ::-1], b[..., ::-1]
        chunk = 32
        d = np.concatenate([lpips_distance(model, ra[s:s + chunk],
                                           rb[s:s + chunk])
                            for s in range(0, n, chunk)])
        out["lpips_mean"] = round(float(np.mean(d)), 5)
        out["lpips_max"] = round(float(np.max(d)), 5)
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="calipsync_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="'cuda' (default; fails without a GPU) or "
                             "'cpu'")

    def common(sp):
        sp.add_argument("--hubert", required=True,
                        help="HF hubert checkpoint dir")
        sp.add_argument("--config", default=None, help="JSON config file")
        device(sp)

    def face_weights(sp):
        sp.add_argument("--weights", required=True,
                        help="face-model directory (mean_face.txt, "
                             "checkpoint_epoch_335.pth.tar, "
                             "yolov8n_face_state_dict.pth or sfd_face.pth)")

    sp = sub.add_parser("step1", help="video -> training data")
    sp.add_argument("--video", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--audio", default=None, help="side-car wav")
    face_weights(sp)
    common(sp)
    sp.set_defaults(fn=cmd_step1)

    sp = sub.add_parser("step3", help="video -> inference assets")
    sp.add_argument("--video", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--xseg", default=None,
                    help="xseg.onnx: write per-frame compositing masks")
    sp.add_argument("--detect-stride", type=int, default=1,
                    help="detect faces every Nth frame, reusing the boxes "
                         "in between (PFLD still runs on every frame)")
    face_weights(sp)
    sp.add_argument("--config", default=None, help="JSON config file")
    device(sp)
    sp.set_defaults(fn=cmd_step3)

    sp = sub.add_parser("clone", help="video -> fine-tuned speaker (step 1, "
                                      "train, step 3)")
    sp.add_argument("--video", required=True)
    sp.add_argument("--out", required=True, help="models directory")
    sp.add_argument("--vgg", default=None,
                    help="vgg19 .pth for the perceptual term (none: L1 "
                         "only)")
    sp.add_argument("--base", default=None,
                    help="generator .pth to start from")
    sp.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="training compute dtype, over the config's "
                         "(bfloat16: the clone recipe)")
    sp.add_argument("--epochs", type=int, default=None)
    face_weights(sp)
    common(sp)
    sp.set_defaults(fn=cmd_clone)

    sp = sub.add_parser("featurize",
                        help="audio file -> HuBERT feature rows .npy")
    sp.add_argument("--audio", required=True)
    sp.add_argument("--out", required=True, help=".npy output path")
    common(sp)
    sp.set_defaults(fn=cmd_featurize)

    sp = sub.add_parser("train", help="fine-tune the generator")
    sp.add_argument("--data", required=True, help="step-1 directory")
    sp.add_argument("--save", required=True, help="checkpoint directory")
    sp.add_argument("--vgg", default=None,
                    help="vgg19 .pth for the perceptual term (none: L1 "
                         "only)")
    sp.add_argument("--base", default=None,
                    help="generator .pth to start from")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--grad-accum", type=int, default=None,
                    help="microbatches per Adam update")
    # --remat / --no-remat: a switch a --config file turned on can be
    # turned off here (None: the config's value)
    sp.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="recompute the generator's activations in the "
                         "backward pass")
    sp.add_argument("--zero1", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="ZeRO-1: shard the Adam moments over the "
                         "data-parallel ranks (mesh.data)")
    sp.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="compute dtype, over the config's; parameters "
                         "stay fp32. bfloat16 is the clone recipe of the "
                         "JAX package's `clone`; float32 on request")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--config", default=None, help="JSON config file")
    device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("infer", help="audio -> lip-synced video")
    sp.add_argument("--assets", required=True, help="infer_data dir")
    sp.add_argument("--ckpt", required=True, help="generator .pth")
    sp.add_argument("--audio", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--pipelined", action="store_true",
                    help="overlap featurize/synthesize/encode (default: "
                         "featurize the whole clip first; the encode "
                         "bounds both)")
    common(sp)
    sp.set_defaults(fn=cmd_infer)

    sp = sub.add_parser("serve", help="real-time streaming avatar")
    sp.add_argument("--assets", required=True, help="infer_data dir")
    sp.add_argument("--ckpt", required=True, help="generator .pth")
    sp.add_argument("--watch", default="serve_queue",
                    help="directory watched for .wav files")
    sp.add_argument("--player", default="window",
                    choices=["window", "rtmp", "file", "virtualcam",
                             "null"])
    sp.add_argument("--rtmp-url", default=None,
                    help="rtmp://host[:port]/app/stream for --player rtmp")
    sp.add_argument("--cam-device", default="/dev/video0",
                    help="v4l2loopback device for --player virtualcam")
    sp.add_argument("--out", default=None, help="file player output")
    sp.add_argument("--width", type=int, default=1080,
                    help="rtmp/virtualcam output width")
    sp.add_argument("--height", type=int, default=1920,
                    help="rtmp/virtualcam output height")
    sp.add_argument("--interrupt", action="store_true",
                    help="priority audio preempts mid-file")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("syncnet-train",
                        help="train the SyncNet evaluator on a step-1 "
                             "directory (reference module/syncnet.py main)")
    sp.add_argument("--data", required=True, help="step-1 directory")
    sp.add_argument("--save", required=True, help="checkpoint directory")
    sp.add_argument("--mode", default="hubert", choices=["hubert", "wenet"])
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--epochs", type=int, default=40)
    sp.add_argument("--base", default=None,
                    help="warm start: a port checkpoint directory or a "
                         "SyncNet .pth in the reference layout")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--log-every", type=int, default=10)
    device(sp)
    sp.set_defaults(fn=cmd_syncnet_train)

    sp = sub.add_parser("eval",
                        help="frame-wise PSNR/LPIPS between two videos")
    sp.add_argument("--a", required=True)
    sp.add_argument("--b", required=True)
    sp.add_argument("--max-frames", type=int, default=250)
    sp.add_argument("--lpips", default=None,
                    help="lpips heads checkpoint (.pth) to add LPIPS")
    sp.add_argument("--lpips-trunk", default=None,
                    help="torchvision trunk checkpoint for LPIPS")
    sp.add_argument("--lpips-net", default="vgg", choices=["vgg", "alex"])
    device(sp)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser(
        "sync-score",
        help="LSE-style lip-sync score of a generated video vs its audio "
             "features (SyncNet offset scan)")
    sp.add_argument("--video", default=None,
                    help="generated mp4 (frames resized to 160x160)")
    sp.add_argument("--lips-dir", default=None,
                    help="directory of pre-cropped mouth jpgs (step 3's "
                         "infer_data/lips_jpg) - preferred")
    sp.add_argument("--features", required=True,
                    help="aud_hu.npy HuBERT rows for the same audio")
    sp.add_argument("--syncnet", default=None,
                    help="trained SyncNet .pth (absent = random init, "
                         "relative scores only)")
    sp.add_argument("--mode", default="hubert", choices=["hubert", "wenet"])
    sp.add_argument("--max-offset", type=int, default=15)
    sp.add_argument("--max-frames", type=int, default=500)
    device(sp)
    sp.set_defaults(fn=cmd_sync_score)

    sp = sub.add_parser("cost", help="the generator's FLOP count (GFLOP)")
    sp.add_argument("--batch", type=int, default=1)
    device(sp)
    sp.set_defaults(fn=cmd_cost)

    sp = sub.add_parser(
        "verify-weights",
        help="check checkpoint files against the port's loaders (key "
             "coverage, param counts)")
    sp.add_argument("--weights-dir", default=None,
                    help="reference weight-dir layout: mean_face.txt, "
                         "sfd_face.pth, checkpoint_epoch_335.pth.tar "
                         "[, yolov8n_face_state_dict.pth]")
    sp.add_argument("--generator", default=None, help="UNet .pth")
    sp.add_argument("--mode", default="hubert", choices=["hubert", "wenet"])
    sp.add_argument("--syncnet", default=None, help="SyncNet .pth")
    sp.add_argument("--hubert", default=None, help="HF checkpoint dir")
    sp.add_argument("--vgg", default=None, help="torchvision vgg19 .pth")
    sp.add_argument("--lpips-trunk", default=None)
    sp.add_argument("--lpips-heads", default=None)
    sp.add_argument("--asr", default=None,
                    help="HF Wav2Vec2ForCTC dir (the slicer's recognizer)")
    device(sp)
    sp.set_defaults(fn=cmd_verify_weights)

    sp = sub.add_parser(
        "slice", help="slice audio into 5-12 s speech segments (reference "
                      "get_srt stack; funasr -> CTC ASR)")
    sp.add_argument("--audio", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--asr", default=None,
                    help="local HF Wav2Vec2ForCTC dir: transcribing "
                         "slicer; energy-VAD otherwise")
    sp.add_argument("--min-seconds", type=float, default=5.0)
    sp.add_argument("--max-seconds", type=float, default=12.0)
    device(sp)
    sp.set_defaults(fn=cmd_slice)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
