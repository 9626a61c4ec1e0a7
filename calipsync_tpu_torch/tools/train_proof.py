"""Learning proof (counterpart of tools/train_proof.py): overfit a
synthetic speaker on the resident path, K train steps a dispatch, and
read PSNR on a fixed eval set before and after.

The masked input hands the generator every pixel outside the mouth
rectangle, so the number that shows learning is PSNR inside it; full-crop
and outside-rect PSNR are recorded beside it, with the losses,
samples/s over the dispatches after the first, and what the first
dispatch costs (on the card it captures the K steps as one CUDA graph,
``train/trainer.py::make_resident_multi_step``) and the peak device
memory. The perceptual term is on, with a seeded random VGG19 trunk.

    python -m calipsync_tpu_torch.tools.train_proof [--device cpu]
        [--train-steps 500] [--train-batch 32] [--train-frames 250]
        [--train-res 720] [--train-eval 64] [--train-dtype float32]
        [--out chiprun_out/train_proof.json]
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np


def make_step1_assets(root: str, n_frames: int, res: int) -> str:
    """The JAX tools' synthetic step-1 speaker (tools/bench_train.py):
    ``make_synthetic_speaker``'s frames re-laid as step-1 data, with
    ``n_frames`` rows of N(0, 1) features from seed 0."""
    from calipsync_tpu_torch.bench_assets import make_synthetic_speaker

    infer = make_synthetic_speaker(root, n_frames=n_frames, res=res)
    out = os.path.join(root, "step1")
    os.makedirs(os.path.join(out, "full_body_img"), exist_ok=True)
    os.makedirs(os.path.join(out, "landmarks"), exist_ok=True)
    for i in range(n_frames):
        n = str(i).zfill(6)
        os.replace(os.path.join(infer, "frames", f"{n}.jpg"),
                   os.path.join(out, "full_body_img", f"{i}.jpg"))
        lms = np.loadtxt(os.path.join(infer, "positions", f"{n}.txt"))
        np.savetxt(os.path.join(out, "landmarks", f"{i}.lms"), lms)
    feats = np.random.default_rng(0).standard_normal(
        (n_frames, 2, 1024)).astype(np.float32)
    np.save(os.path.join(out, "aud_hu.npy"), feats)
    return out


def main(argv=None) -> dict:
    import torch

    from calipsync_tpu_torch.config import (CropConfig, ModelConfig,
                                            TrainConfig)
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.core.weights import from_jax_vgg, random_jax_vgg
    from calipsync_tpu_torch.data.dataset import ResidentLipSyncDataset
    from calipsync_tpu_torch.nn.vgg import VGG19Features
    from calipsync_tpu_torch.tools import (HoldoutEvaluator, device_report,
                                           parser, write_report)
    from calipsync_tpu_torch.train.trainer import (DTYPES, build_model,
                                                   create_train_state,
                                                   make_resident_multi_step)

    ap = parser("train_proof", __doc__)
    ap.add_argument("--train-steps", type=int, default=500)
    ap.add_argument("--train-batch", type=int, default=32)
    ap.add_argument("--train-frames", type=int, default=250)
    ap.add_argument("--train-res", type=int, default=720)
    ap.add_argument("--train-eval", type=int, default=64)
    ap.add_argument("--train-dtype", choices=tuple(DTYPES),
                    default="float32")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch, dtype = args.train_batch, args.train_dtype
    on_card = device.type == "cuda"

    crop = CropConfig()
    train_cfg = TrainConfig(batch_size=batch)
    vgg = VGG19Features(DTYPES[dtype])
    vgg.load_state_dict(from_jax_vgg(random_jax_vgg(seed=1)), strict=True)
    vgg = vgg.to(device).eval().requires_grad_(False)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = make_step1_assets(tmp, args.train_frames, args.train_res)
        ds = ResidentLipSyncDataset(data_dir, crop=crop, device=device)
        feats = torch.from_numpy(ds.audio_feats).to(device)
    state = create_train_state(
        build_model(ModelConfig(dtype=dtype), seed=0).to(device), train_cfg)
    fn = make_resident_multi_step(train_cfg, crop)
    evaluate = HoldoutEvaluator(ds.store, feats, len(ds), ds.n_frames,
                                args.train_eval, 7, crop)
    before = evaluate(state.model)

    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield from ds.epoch_indices(batch, rng)

    it = batches()
    k = min(25, args.train_steps)  # steps a dispatch, as the JAX tool's
    n_blocks = max(args.train_steps // k, 1)
    steps = n_blocks * k
    # (n_blocks, 3, K, B): a block's index, frame and reference rows
    blocks = np.stack([np.stack(next(it)) for _ in range(steps)]).reshape(
        n_blocks, k, 3, batch).transpose(0, 2, 1, 3)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    # the first dispatch captures the graph (on the card) and runs
    t0 = time.perf_counter()
    m = fn(state, ds.store, *blocks[0], feats, vgg)
    losses = m["loss"].cpu()
    first_s = time.perf_counter() - t0
    loss_first = float(losses[0])
    t0 = time.perf_counter()
    for b in range(1, n_blocks):
        m = fn(state, ds.store, *blocks[b], feats, vgg)
    loss_last = float(m["loss"][-1])  # waits for the last dispatch
    dt = time.perf_counter() - t0
    after = evaluate(state.model)

    out = {
        "steps": steps, "batch": batch, "n_frames": args.train_frames,
        "res": args.train_res, "n_eval": args.train_eval, "dtype": dtype,
        "k": k, "graphed": fn.graphed,
        "loss_first": loss_first, "loss_last": loss_last,
        "before": before, "after": after,
        "mouth_rect_gain_db": (after["psnr_mouth_rect"]
                               - before["psnr_mouth_rect"]),
        "first_dispatch_s": first_s,
        "samples_per_s": ((n_blocks - 1) * k * batch / dt
                          if n_blocks > 1 else None),
        **device_report(device)}
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
