"""What the ranks of the port's multi-card tests run
(tests/test_torch_mesh.py, tests/test_torch_parallel.py).

Spawned ranks import this module, so it imports torch, numpy and the port
only, never JAX or the JAX package. Each function runs on every rank of a
4-rank gloo group on the CPU and returns numpy arrays that the test
module compares against the JAX package in the parent process; a case
that needs fewer ranks runs on a sub-mesh while the other ranks do work
of their own (one-rank yardsticks), so the whole file costs one group.
Every rank builds every mesh, in the same order: building one is a
collective of the whole group.
"""

from __future__ import annotations

import numpy as np
import torch

from calipsync_tpu_torch.config import CropConfig, MeshConfig, TrainConfig
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.train import trainer

N_BLOCKS = 1
# Bounds on the ranks' waits (core.mesh.launch), so that a hang fails one
# test in minutes instead of holding the suite: the whole group's (the
# mesh file's ranks run ~60 s alone, ~120 s under the tier-1 command's
# load), and a collective's for a peer (the longest a rank waits at a
# collective for the others' work is ~13 s alone).
LAUNCH_TIMEOUT_S = 360
COLLECTIVE_TIMEOUT_S = 120


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sd(model) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


def _generator(state_dict, dtype=torch.float32) -> Generator:
    model = Generator(n_blocks=N_BLOCKS, dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dtype)


def digest(arrays: dict) -> dict:
    """name -> (sum, sum of squares) in fp64: equal arrays give equal
    digests, so a rank can prove it holds what another returned without
    shipping it."""
    return {k: (float(np.sum(v, dtype=np.float64)),
                float(np.sum(np.square(v, dtype=np.float64))))
            for k, v in arrays.items()}


def allclose_ratio(ours: dict, ref: dict, rtol: float, atol: float
                   ) -> dict:
    """name -> the largest |ours - ref| / (atol + rtol |ref|) over the
    elements: ``np.allclose(ours, ref, rtol, atol)`` holds where it is at
    most 1. Lets a rank compare two results of its own and ship numbers."""
    return {k: float(np.max(np.abs(np.asarray(ours[k], np.float64) - r)
                            / (atol + rtol * np.abs(r)), initial=0.0))
            for k, r in ((k, np.asarray(v, np.float64))
                         for k, v in ref.items())}


def _step(state_dict, batch, feats, mesh=None, zero1=False,
          dtype=torch.float32) -> dict:
    """One host-batch train step from ``state_dict`` on the global
    ``batch`` (no VGG term): metrics, the state after, the gradients, the
    Adam state (replicated layout) and the moment bytes this rank keeps."""
    model = _generator(state_dict, dtype)
    tcfg = TrainConfig(batch_size=len(batch["index"]), zero1=zero1)
    state = (trainer.create_zero1_state(model, tcfg, mesh) if zero1
             else trainer.create_train_state(model, tcfg))
    metrics = trainer.make_train_step(tcfg, mesh)(
        state, batch, torch.from_numpy(feats).to(dtype))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "state": _sd(model), "step": state.step,
           "grads": {n: _np(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None}}
    if zero1:
        out["moment_bytes"] = state.optimizer.moment_bytes()
        out["opt"] = state.optimizer.state_dict()
    else:
        out["moment_bytes"] = sum(
            st[k].numel() * st[k].element_size()
            for st in state.optimizer.state.values()
            for k in ("exp_avg", "exp_avg_sq"))
        out["opt"] = state.optimizer.state_dict()
    return out


def _multi_step(state_dict, a: dict, mesh) -> dict:
    """K resident DP steps in one make_resident_multi_step dispatch over
    ``mesh`` (eager over gloo) against K per-step DP calls from the same
    weights: both runs' losses, step counts and state digests."""
    store, blocks, feats = (torch.from_numpy(a[k]) for k in
                            ("store", "blocks", "feats"))
    tcfg = TrainConfig(batch_size=blocks.shape[-1])
    runs = {}
    for name in ("multi", "per_step"):
        model = _generator(state_dict)
        state = trainer.create_train_state(model, tcfg)
        if name == "multi":
            fn = trainer.make_resident_multi_step(tcfg, mesh=mesh)
            loss = fn(state, store, *blocks, feats)["loss"].tolist()
            graphed = fn.graphed
        else:
            fn = trainer.make_resident_train_step(tcfg, mesh=mesh)
            loss = [float(fn(state, store, *blocks[:, i], feats)["loss"])
                    for i in range(blocks.shape[1])]
        runs[name] = {"loss": loss, "step": state.step,
                      "state": digest(_sd(model))}
    runs["graphed"] = graphed
    return runs


def _serve_frames(state_dict, speaker_dir, features, fmt, mesh=None):
    from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer

    synth = FrameSynthesizer(state_dict, speaker_dir,
                             model=Generator(n_blocks=N_BLOCKS),
                             batch_size=4, seed=7, transfer_format=fmt,
                             device="cpu", mesh=mesh)
    frames = [f["frame"] for f in synth.iterate_synthesized_frames(features)]
    synth.close()
    return np.stack(frames)


def _multistream(state_dict, speaker_dirs, ticks, mesh=None):
    from calipsync_tpu_torch.serve.multi_stream import MultiStreamSynthesizer

    ms = MultiStreamSynthesizer(state_dict, speaker_dirs,
                                model=Generator(n_blocks=N_BLOCKS),
                                batch_size=4, device="cpu", mesh=mesh,
                                transfer_format="yuv420")
    ms.add_stream("a", speaker=0)
    ms.add_stream("b", speaker=1)
    out = []
    for tick in ticks:
        got = ms.synthesize_windows(tick)
        out.append({sid: np.stack([f["frame"] for f in frames])
                    for sid, frames in got.items()})
    ms.close()
    return out


def mesh_cases(a: dict) -> dict:
    """Serving, data-parallel training, ZeRO-1, K steps a dispatch, the
    hybrid mesh and a 2-rank checkpoint (tests/test_torch_mesh.py). Ranks
    0-1 train on a 2-rank mesh (fp32, ZeRO-1, fp64, a K=2 dispatch), while
    ranks 2-3 serve on theirs and then run the one-rank yardsticks: the
    fp64 step (rank 2), the unsharded serving and multi-stream (rank 3);
    the two pairs take about as long. Ranks 0-1 then write the
    checkpoint, and all four run the hybrid and the flat mesh.
    Comparisons of two port results on one rank ship as
    :func:`allclose_ratio` at the repo's bar (rtol 1e-3 / atol 1e-5)."""
    from calipsync_tpu_torch import cli
    from calipsync_tpu_torch.infer.synthesizer import (
        FrameSynthesizer, make_generate_resident_fn,
        make_generate_resident_sharded_fn)

    rank = meshlib.process_index()
    out: dict = {"rank": rank}
    sd = torch.load(a["base"], weights_only=True)
    batch, feats = a["batch"], a["feats"]
    flat = meshlib.build_mesh(MeshConfig())
    hybrid = meshlib.build_mesh(MeshConfig(dcn=2))
    two = meshlib.make_mesh(data=2)
    serve = meshlib.make_named_mesh((2,), ("data",), first=2)
    out["built"] = {
        "flat": (flat.axis_names, flat.shape,
                 flat.axis_index(meshlib.batch_axes(flat))),
        "hybrid": (hybrid.axis_names, hybrid.shape,
                   hybrid.axis_index(meshlib.batch_axes(hybrid)),
                   hybrid.axis_index("host"), hybrid.axis_index("data")),
        "two": (two.axis_names, two.shape, two.is_member())}

    if two.is_member():
        # training: DP with sync-BN, and ZeRO-1 from the same weights
        dp = _step(sd, batch, feats, two)
        zero1 = _step(sd, batch, feats, two, zero1=True)
        out["zero1"] = {k: zero1[k] for k in ("step", "moment_bytes")}
        out["dp_moment_bytes"] = dp["moment_bytes"]
        out["dp_state"] = digest(dp["state"])
        out["zero1_state"] = digest(zero1["state"])
        # the mean path's (replicated) Adam state loaded into ZeRO-1 blocks
        # and gathered back: a one-rank checkpoint resumed on two ranks
        back = trainer.create_zero1_state(
            _generator(sd), TrainConfig(batch_size=2, zero1=True), two)
        back.optimizer.load_state_dict(dp["opt"])
        reload = _opt_compare(back.optimizer.state_dict(), dp["opt"])
        dp64 = _step(sd, batch, feats, two, dtype=torch.float64)
        out["multi"] = _multi_step(sd, a["multi"], two)
        if rank == 0:
            out["dp"] = {k: dp[k] for k in ("metrics", "state", "grads",
                                            "step")}
            out["dp64"] = {k: dp64[k] for k in ("metrics", "state",
                                                "grads")}
            out["zero1"]["state"] = allclose_ratio(
                zero1["state"], dp["state"], 1e-3, 1e-5)
            out["zero1"]["opt"] = _opt_compare(zero1["opt"], dp["opt"])
            out["zero1"]["reload"] = reload
    else:
        # serving on ranks 2-3: the sharded step's rows, the
        # synthesizers' frames, two multi-stream ticks, the refusals
        rows = {}
        for fmt in ("bgr", "yuv420"):
            fn = make_generate_resident_sharded_fn(
                _generator(sd).eval(), CropConfig(), serve, "data", fmt,
                "cpu")
            rows[fmt] = _np(fn(*(torch.from_numpy(a["serve"][k]) for k in
                                 ("store", "phys", "feats", "fidx"))))
        out["rows"] = rows
        out["frames"] = {fmt: _serve_frames(sd, a["speakers"][0],
                                            a["features"], fmt, serve)
                         for fmt in ("bgr", "yuv420")}
        out["ticks"] = _multistream(sd, a["speakers"], a["ticks"], serve)
        errors = {}
        try:
            FrameSynthesizer(sd, a["speakers"][0],
                             model=Generator(n_blocks=N_BLOCKS),
                             batch_size=4, device="cpu", mesh=serve,
                             preload_max_bytes=1)
        except ValueError as e:
            errors["budget"] = str(e)
        synth = FrameSynthesizer(sd, a["speakers"][0],
                                 model=Generator(n_blocks=N_BLOCKS),
                                 batch_size=4, device="cpu", mesh=serve,
                                 first_batch_size=3)
        errors["head3"] = synth.first_batch_size
        errors["head2"] = synth.set_first_batch_size(2)
        synth.close()
        out["errors"] = errors
        # the eval-mode forward over the mesh (make_eval_step(mesh))
        rng = np.random.default_rng(4)
        imgs = torch.from_numpy(rng.random((2, 160, 160, 6),
                                           dtype=np.float32))
        audio = torch.from_numpy(rng.standard_normal(
            (2, 32, 32, 32)).astype(np.float32))
        model = _generator(sd)
        got = trainer.make_eval_step(serve)(model, imgs, audio)
        out["eval"] = digest({"out": _np(got)})
        if rank == 3:
            one = trainer.make_eval_step()(model, imgs, audio)
            out["eval_ratio"] = allclose_ratio({"out": _np(got)},
                                               {"out": _np(one)}, 1e-3,
                                               1e-5)["out"]
            out["eval_shape"] = tuple(got.shape)
        if rank == 3:  # the unsharded serving and multi-stream
            out["one_frames"] = {fmt: _serve_frames(sd, a["speakers"][0],
                                                    a["features"], fmt)
                                 for fmt in ("bgr", "yuv420")}
            out["one_ticks"] = _multistream(sd, a["speakers"], a["ticks"])
        if rank == 3:  # what rank 2 returns, as digests
            out["one_rows"] = _np(make_generate_resident_fn(
                _generator(sd).eval(), CropConfig(), "yuv420", "cpu")(
                *(torch.from_numpy(a["serve"][k]) for k in
                  ("store", "phys", "feats", "fidx"))))
            out["rows"] = digest(out["rows"])
            out["frames"] = digest(out["frames"])
            out["ticks"] = [digest(t) for t in out["ticks"]]
        if rank == 2:  # the one-rank step on the global batch, in fp64
            one = _step(sd, batch, feats, dtype=torch.float64)
            out["one64"] = {k: one[k] for k in ("metrics", "state",
                                                "grads", "step")}

    # a checkpoint written by ranks 0-1 with ZeRO-1, through the CLI's
    # train --zero1 and a config's mesh.data (ranks 2-3 only join the
    # construction of its mesh)
    cli.main(["train", "--data", a["step1"], "--save", a["save"],
              "--base", a["base"], "--epochs", "1", "--dtype", "float32",
              "--config", a["train_config"], "--zero1", "--device", "cpu"])

    # the hybrid (host=2, data=2) mesh against flat DP, one row a rank
    h = _step(sd, a["batch4"], feats, hybrid)
    f = _step(sd, a["batch4"], feats, flat)
    out["hybrid"] = {part: allclose_ratio(h[part], f[part], 1e-3, 1e-5)
                     for part in ("metrics", "state", "grads")}
    out["flat_state"] = digest(f["state"])
    out["hybrid_state"] = digest(h["state"])
    return out


def _opt_compare(z: dict, ref: dict) -> dict:
    """ZeRO-1's gathered Adam state against the mean path's: the layout
    (group entries, parameter indices, shapes, steps) and each moment's
    :func:`allclose_ratio`."""
    layout = (z["param_groups"][0]["params"] == ref["param_groups"][0][
        "params"] and z["state"].keys() == ref["state"].keys()
        and all(z["state"][i][k].shape == st[k].shape
                and float(z["state"][i]["step"]) == float(st["step"])
                for i, st in ref["state"].items()
                for k in ("exp_avg", "exp_avg_sq")))
    worst = 0.0
    for i, st in ref["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            worst = max(worst, allclose_ratio({0: z["state"][i][k]},
                                              {0: st[k]}, 1e-3, 1e-5)[0])
    return {"layout": layout, "moments": worst,
            "steps": sorted({float(st["step"])
                             for st in z["state"].values()})}


def _hubert(state_dict, config):
    from calipsync_tpu_torch.nn.hubert import HubertModel

    model = HubertModel(config).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def _extractor(state_dict, config, chunking, mesh=None, parallel="tp",
               pp_microbatches=None):
    from calipsync_tpu_torch.audio.hubert_pipeline import \
        HubertFeatureExtractor

    return HubertFeatureExtractor(state_dict, config, device="cpu",
                                  mesh=mesh, parallel=parallel,
                                  pp_microbatches=pp_microbatches,
                                  **chunking)


def parallel_cases(a: dict) -> dict:
    """Tensor- and pipeline-parallel HuBERT, the extractor in both modes,
    expert parallelism and the dry run (tests/test_torch_parallel.py)."""
    from calipsync_tpu_torch import cli
    from calipsync_tpu_torch.core.ep import moe_ffn_ep
    from calipsync_tpu_torch.core.pp import hubert_pp_apply
    from calipsync_tpu_torch.core.tp import shard_hubert
    from calipsync_tpu_torch.dryrun import run_sections

    rank = meshlib.process_index()
    out: dict = {"rank": rank}
    model2 = meshlib.make_named_mesh((2,), ("model",))
    grid = meshlib.make_named_mesh((2, 2), ("data", "model"))
    expert2 = meshlib.make_named_mesh((2,), ("expert",))
    expert4 = meshlib.make_named_mesh((4,), ("expert",))
    sd, cfg = a["hubert"], a["config"]
    wav, n_valid = (torch.from_numpy(a["wav"]),
                    torch.from_numpy(a["n_valid"]))

    with torch.inference_mode():
        if model2.is_member():
            pp = {}
            model = _hubert(sd, cfg)
            pp["sequential"] = _np(hubert_pp_apply(model, wav[:2], model2))
            pp["masked"] = _np(hubert_pp_apply(model, wav[:2], model2,
                                               num_valid_samples=n_valid[:2]))
            pp["m4"] = _np(hubert_pp_apply(model, wav, model2,
                                           num_microbatches=4,
                                           num_valid_samples=n_valid))
            out["pp"] = pp
            out["tp"] = _np(shard_hubert(_hubert(sd, cfg), model2)(
                wav, num_valid_samples=n_valid))
            feats = {}
            for mode in ("tp", "pp"):
                ex = _extractor(sd, cfg, a["chunking"], model2, mode)
                feats[mode] = [ex.extract_features(a["long"]),
                               ex.extract(a["short"])]
            out["extract"] = feats
            out["ep2"] = _np(moe_ffn_ep(
                {k: torch.from_numpy(v) for k, v in a["moe"].items()},
                torch.from_numpy(a["tokens"]), expert2))
        else:  # the unsharded yardsticks
            model = _hubert(sd, cfg)
            out["one"] = _np(model(wav, num_valid_samples=n_valid))
            out["one_unmasked"] = _np(model(wav[:2]))
            ex = _extractor(sd, cfg, a["chunking"])
            out["one_extract"] = [ex.extract_features(a["long"]),
                                  ex.extract(a["short"])]
        # data x pipeline and data x tensor over all four ranks
        out["pp_grid"] = _np(hubert_pp_apply(
            _hubert(sd, cfg), wav, grid, num_microbatches=2,
            num_valid_samples=n_valid, data_axis="data"))
        tp = shard_hubert(_hubert(sd, cfg), grid)
        local = tp(meshlib.shard_rows(wav, grid, "data"),
                   num_valid_samples=meshlib.shard_rows(n_valid, grid,
                                                        "data"))
        out["tp_grid"] = _np(meshlib.all_gather(local, grid, "data"))
        out["ep4"] = _np(moe_ffn_ep(
            {k: torch.from_numpy(v) for k, v in a["moe"].items()},
            torch.from_numpy(a["tokens"]), expert4))
    out["dryrun"] = run_sections(2, "cpu")
    # the CLI's featurize with mesh.model = 4 (tensor parallel); the first
    # rank writes the features
    cli.main(["featurize", "--hubert", a["hubert_dir"], "--audio",
              a["wav_path"], "--out", a["feats_out"], "--config",
              a["tp_config"], "--device", "cpu"])
    return out
