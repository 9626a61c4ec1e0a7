"""Command-line interface of the port (counterpart of the step1, step3,
clone, featurize, train, infer and serve commands of calipsync_tpu/cli.py):

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
        --ckpt generator.pth --hubert hubert_dir/ --player null|file

``--weights`` is the face-model directory in the reference's layout:
``mean_face.txt``, ``checkpoint_epoch_335.pth.tar`` (PFLD) and
``yolov8n_face_state_dict.pth`` (YOLOv8n-face, used when present) or
``sfd_face.pth`` (S3FD). ``--hubert`` is a local HF checkpoint directory
(``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``);
``--ckpt`` a generator state_dict in the reference torch layout (what the
JAX package's ``export-torch`` and the port's ``train`` write). Every
command runs on the card unless given ``--device cpu``.
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


def build_hubert(hubert_path: str, device=None):
    """HF checkpoint dir -> extractor on ``device`` (fp32, one card)."""
    from calipsync_tpu_torch.audio.hubert_pipeline import load_hf_checkpoint

    return load_hf_checkpoint(hubert_path, device=device)


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

    _load_cfg(args)  # raises on settings the port cannot honour
    ex = build_hubert(args.hubert, device=args.device)
    feats = ex.extract_from_file(args.audio)
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


def cmd_serve(args):
    """Real-time streaming: watches a directory for audio files.

    Drop ``<name>.wav`` into --watch to queue it (prefix ``danmu_`` for
    the high-priority queue); the avatar idles on silence otherwise.
    Stops on Ctrl-C; the file player then writes its mp4.
    """
    from calipsync_tpu_torch.serve.players import FilePlayer, NullPlayer
    from calipsync_tpu_torch.serve.stream_manager import \
        StreamingVideoManager

    cfg = _load_cfg(args)
    synth = _synthesizer(args, cfg, cfg.infer.first_window_batch)
    sample_rate = 24_000  # manager output rate; pegs the player clock
    kw = dict(fps=cfg.infer.fps, sample_rate=sample_rate)
    if args.player == "file":
        player = FilePlayer(args.out or "stream.mp4", realtime=True, **kw)
    else:
        player = NullPlayer(**kw)
    mgr = StreamingVideoManager(
        synth, build_hubert(args.hubert, args.device), player,
        buffer_threshold=int(cfg.infer.fps * cfg.infer.buffer_threshold_s),
        output_sample_rate=sample_rate, fps=cfg.infer.fps,
        is_interrupt=args.interrupt)
    print("warming up...", flush=True)
    mgr.warmup()
    mgr.start_playing()
    print(f"serving; drop .wav files into {args.watch} (danmu_* = "
          "priority)", flush=True)
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
                print(f"queued {f} -> {queue} ({n} frames)", flush=True)
            time.sleep(0.2)
    except KeyboardInterrupt:
        print(f"stopping after {mgr.frames_uploaded} frames, "
              f"{mgr.producer_errors} producer errors", flush=True)
    finally:
        mgr.close()
        synth.close()
        if isinstance(player, FilePlayer) and player.frames:
            print(f"wrote {player.finalize()}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="calipsync_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--hubert", required=True,
                        help="HF hubert checkpoint dir")
        sp.add_argument("--config", default=None, help="JSON config file")
        sp.add_argument("--device", default=None,
                        help="'cuda' (default; fails without a GPU) or "
                             "'cpu'")

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
    sp.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
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
                    default=None, help="not ported: raises")
    sp.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="compute dtype, over the config's; parameters "
                         "stay fp32. bfloat16 is the clone recipe of the "
                         "JAX package's `clone`; float32 on request")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--config", default=None, help="JSON config file")
    sp.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
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
    sp.add_argument("--player", default="null", choices=["null", "file"])
    sp.add_argument("--out", default=None, help="file player output")
    sp.add_argument("--interrupt", action="store_true",
                    help="priority audio preempts mid-file")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
