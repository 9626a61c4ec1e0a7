"""Command-line interface of the port (counterpart of the featurize, infer
and serve commands of calipsync_tpu/cli.py):

    python -m calipsync_tpu_torch.cli featurize --hubert hubert_dir/ \\
        --audio a.wav --out feats.npy
    python -m calipsync_tpu_torch.cli infer --assets assets/infer_data \\
        --ckpt generator.pth --hubert hubert_dir/ --audio a.wav --out o.mp4
    python -m calipsync_tpu_torch.cli serve --assets assets/infer_data \\
        --ckpt generator.pth --hubert hubert_dir/ --player null|file

``--hubert`` is a local HF checkpoint directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``); ``--ckpt`` a generator
state_dict in the reference torch layout (what the JAX package's
``export-torch`` writes). Every command runs on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


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

    sp = sub.add_parser("featurize",
                        help="audio file -> HuBERT feature rows .npy")
    sp.add_argument("--audio", required=True)
    sp.add_argument("--out", required=True, help=".npy output path")
    common(sp)
    sp.set_defaults(fn=cmd_featurize)

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
