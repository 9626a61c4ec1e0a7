"""Clone quality curve (counterpart of tools/clone_curve.py): held-out
quality against training length and precision on the clone pipeline's
own data.

Step 1 and step 3 run once on the synthetic talking head of
tools/clone_proof.py; each sweep point (``dtype:epochs``) trains from the
same step-1 output through ``pipelines.step2_train.train_digital_model``
and serves the held-out audio; one SyncNet, trained once on the shared
step-1 data, scores every point's video (a fixed scorer keeps points
comparable). Held-out PSNR is read by an fp32 generator for every point
(the parameters are fp32 whatever the training's compute dtype). The gap
diagnosis reads whether the bf16 points' sync similarity still rises
with epochs. Last, the recommended recipe runs the product flow
(``clone_video_local``, fresh steps 1 and 3) for a cold-start-to-avatar
number. ``--curve-points ""`` skips the sweep, ``--curve-recommend ""``
the product flow.

    python -m calipsync_tpu_torch.tools.clone_curve [--device cpu]
        [--curve-seconds 60] [--curve-hold-seconds 8] [--curve-res 480]
        [--curve-batch 16] [--curve-sync-epochs 5]
        [--curve-points
         bfloat16:5,bfloat16:10,bfloat16:20,bfloat16:40,float32:20]
        [--curve-recommend bfloat16:20] [--hubert real|toy]
        [--out chiprun_out/clone_curve.json]
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEFAULT_POINTS = ("bfloat16:5,bfloat16:10,bfloat16:20,bfloat16:40,"
                  "float32:20")


def _points(text: str) -> list:
    return [(d, int(e)) for d, e in (p.split(":") for p in text.split(",")
                                     if p)]


def main(argv=None) -> dict:
    import torch

    from calipsync_tpu_torch.cli import load_generator
    from calipsync_tpu_torch.config import (CropConfig, ModelConfig,
                                            PipelineConfig, TrainConfig)
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.eval import sync_metrics
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
    from calipsync_tpu_torch.pipelines.all_pipeline import clone_video_local
    from calipsync_tpu_torch.pipelines.inference import VideoStreamManager
    from calipsync_tpu_torch.pipelines.step1_preprocess import \
        TrainPreprocessor
    from calipsync_tpu_torch.pipelines.step2_train import (
        GENERATOR_FILE, train_digital_model)
    from calipsync_tpu_torch.pipelines.step3_prepare import \
        InferPreprocessor
    from calipsync_tpu_torch.tools import (device_report, make_hubert,
                                           parser, write_report)
    from calipsync_tpu_torch.tools.clone_proof import (
        FPS, FixedLipDetector, best_syncnet, holdout_evaluator,
        make_talking_video, video_crops)
    from calipsync_tpu_torch.train.syncnet_trainer import train_sync_net
    from calipsync_tpu_torch.train.trainer import build_model

    ap = parser("clone_curve", __doc__)
    ap.add_argument("--curve-seconds", type=float, default=60.0)
    ap.add_argument("--curve-hold-seconds", type=float, default=8.0)
    ap.add_argument("--curve-res", type=int, default=480)
    ap.add_argument("--curve-batch", type=int, default=16)
    ap.add_argument("--curve-sync-epochs", type=int, default=5)
    ap.add_argument("--curve-points", default=DEFAULT_POINTS,
                    help="dtype:epochs,... ('' skips the sweep)")
    ap.add_argument("--curve-recommend", default="bfloat16:20",
                    help="dtype:epochs of the product-flow run ('' skips "
                         "it)")
    ap.add_argument("--hubert", choices=("real", "toy"), default="real")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res, batch = args.curve_res, args.curve_batch

    crop = CropConfig()
    out = {"seconds": args.curve_seconds,
           "hold_seconds": args.curve_hold_seconds, "res": res,
           "batch": batch, "hubert": args.hubert, "points": [],
           **device_report(device)}
    extractor = make_hubert(args.hubert, torch.bfloat16, device, seed=1)
    lip = FixedLipDetector(res)
    # every point's held-out PSNR and video come from fp32 parameters
    eval_cfg = PipelineConfig(model=ModelConfig(dtype="float32"))

    def cfg_of(dtype: str, epochs: int) -> PipelineConfig:
        return PipelineConfig(model=ModelConfig(dtype=dtype),
                              train=TrainConfig(batch_size=batch,
                                                epochs=epochs))

    with tempfile.TemporaryDirectory() as tmp:
        train_video = os.path.join(tmp, "train.mp4")
        make_talking_video(train_video, res, args.curve_seconds, seed=0)
        hold_video = os.path.join(tmp, "hold.mp4")
        hold_wav = make_talking_video(hold_video, res,
                                      args.curve_hold_seconds, seed=99)

        # the shared step 1 (training data) and step 3 (serving assets)
        data_dir = os.path.join(tmp, "speaker")
        t0 = time.perf_counter()
        TrainPreprocessor(lip, extractor, crop=crop).process_video(
            train_video, data_dir)
        out["step1_s"] = time.perf_counter() - t0
        infer_root = os.path.join(tmp, "infer_assets")
        t0 = time.perf_counter()
        InferPreprocessor(lip).process_video(train_video, infer_root)
        out["step3_s"] = time.perf_counter() - t0
        hold_dir = os.path.join(tmp, "holdout_data")
        TrainPreprocessor(lip, extractor, crop=crop).process_video(
            hold_video, hold_dir)

        # the fixed scorer: one SyncNet trained on the speaker
        sync_dir = os.path.join(tmp, "syncnet")
        t0 = time.perf_counter()
        for _ in train_sync_net(sync_dir, data_dir, mode="hubert",
                                batch_size=batch,
                                epochs=args.curve_sync_epochs,
                                device=device):
            pass
        out["syncnet_train_s"] = time.perf_counter() - t0
        snet = best_syncnet(sync_dir, device)
        hold_feats = extractor.extract_from_file(hold_wav)

        def sync_of(mp4: str) -> dict:
            crops = video_crops(mp4, lip.lms)
            n = min(len(crops), len(hold_feats))
            return sync_metrics(snet, crops[:n], hold_feats[:n])

        out["sync_original_ceiling"] = sync_of(hold_video)
        evaluate = holdout_evaluator(hold_dir, device, crop)
        out["holdout_before"] = evaluate(
            build_model(eval_cfg.model, seed=0).to(device))

        def serve(weights_path: str, infer_dir: str, tag: str) -> tuple:
            """The held-out audio through the trained generator: (its
            held-out PSNR, the serving wall seconds, the sync report)."""
            trained = load_generator(weights_path, eval_cfg).to(device)
            synth = FrameSynthesizer(None, infer_dir, model=trained,
                                     batch_size=eval_cfg.infer.batch_size,
                                     crop=crop, seed=0,
                                     transfer_format="yuv420",
                                     device=device)
            mgr = VideoStreamManager(synth, extractor, fps=FPS)
            out_mp4 = os.path.join(tmp, f"avatar_{tag}.mp4")
            t0 = time.perf_counter()
            mgr.process_single_file(hold_wav, out_mp4)
            infer_s = time.perf_counter() - t0
            return evaluate(trained), infer_s, sync_of(out_mp4)

        rect_before = out["holdout_before"]["psnr_mouth_rect"]
        infer_dir = os.path.join(infer_root, "infer_data")
        for dtype, epochs in _points(args.curve_points):
            tag = f"{dtype}_{epochs}ep"
            t0 = time.perf_counter()
            save_dir = os.path.join(tmp, f"ckpt_{tag}")
            train_digital_model(data_dir, save_dir, cfg=cfg_of(dtype, epochs),
                                log_every=0, device=device)
            train_s = time.perf_counter() - t0
            holdout, infer_s, sync = serve(
                os.path.join(save_dir, GENERATOR_FILE), infer_dir, tag)
            point = {"dtype": dtype, "epochs": epochs,
                     "train_wall_s": train_s, "infer_wall_s": infer_s,
                     "holdout": holdout, "sync_produced": sync,
                     "mouth_rect_gain_db": (holdout["psnr_mouth_rect"]
                                            - rect_before)}
            out["points"].append(point)
            print(json.dumps(point), flush=True)

        # the gap diagnosis: bf16 sync similarity against epochs
        sims = sorted((p["epochs"], p["sync_produced"]["sim_best"])
                      for p in out["points"] if p["dtype"] == "bfloat16")
        if len(sims) >= 2:
            rising = sims[-1][1] - sims[0][1]
            out["sync_gap_diagnosis"] = {
                "bf16_similarity_by_epochs": sims,
                "delta_first_to_last": rising,
                "verdict": ("undertraining: similarity still rising"
                            if rising > 0.01 else
                            "generation/fixture ceiling: similarity "
                            "saturates below the original-video "
                            "ceiling while mouth PSNR rises")}

        # the recommended recipe through the product flow
        if args.curve_recommend:
            (rec_dtype, rec_epochs), = _points(args.curve_recommend)
            timings: dict = {}
            weights_path, model_id = clone_video_local(
                train_video, tmp, lip, extractor,
                cfg=cfg_of(rec_dtype, rec_epochs), cleanup=False,
                timings=timings, device=device)
            holdout, infer_s, sync = serve(
                weights_path, os.path.join(tmp, model_id, "infer_data"),
                "product")
            out["recommended"] = {
                "dtype": rec_dtype, "epochs": rec_epochs,
                "clone_timings": timings,
                "cold_start_to_avatar_s": timings["total_s"] + infer_s,
                "holdout": holdout, "sync_produced": sync,
                "mouth_rect_gain_db": (holdout["psnr_mouth_rect"]
                                       - rect_before)}

    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
