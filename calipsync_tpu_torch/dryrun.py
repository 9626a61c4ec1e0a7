"""Multi-card dry run: one short pass through every parallel path of the
port (counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m calipsync_tpu_torch.dryrun 4             # 4 NCCL ranks, a card each
    python -m calipsync_tpu_torch.dryrun 2 --device cpu  # 2 gloo ranks, CPU

The ranks run on the cards unless the caller asks for the CPU: without
CUDA and without ``--device cpu`` the run raises. The backend follows the
device: NCCL on the cards, one rank a card, and gloo on the CPU.

Sections, each timed and each held as the JAX dry run holds it:

  resident DP step ... the full-width generator, one row a rank, sync-BN,
                       gradients averaged over ``data``; a finite loss and
                       the same weights on every rank after the update
  zero1 step ......... the host-batch step with ZeRO-1 (reduce-scatter,
                       all-gather); a finite loss, step 1, equal replicas
  sharded serve ...... ``make_generate_resident_sharded_fn``, yuv420; the
                       (B, S*S*3/2) rows, within one level of the one-rank
                       step
  pp hubert .......... a tiny HuBERT (4 layers, 4 heads) pipelined over
                       ``model``; equal to the sequential forward
  tp hubert .......... the same model over a ``(data, model)`` mesh, heads
                       and MLP sharded, rows over ``data``; equal to the
                       unsharded forward
  ep moe ............. 4 experts over ``expert``; equal to ``moe_ffn``
                       with one group a rank

PP and EP compare at the JAX dry run's rtol 2e-5 / atol 2e-6. The JAX dry
run's "SP" section (GSPMD placing a frame-axis input sharding) has no
counterpart: no module of the JAX package implements sequence
parallelism, so there is nothing to port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from calipsync_tpu_torch.config import CropConfig, ModelConfig, TrainConfig
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.core.device import resolve_device

TOL = dict(rtol=2e-5, atol=2e-6)
TINY_HUBERT = dict(hidden_size=32, num_hidden_layers=4,
                   num_attention_heads=4, intermediate_size=64,
                   conv_dim=(16, 16), conv_kernel=(10, 3),
                   conv_stride=(5, 2))


def _replicas_equal(model, mesh) -> bool:
    """The parameters are the same on every rank of ``mesh`` (by their
    fp64 sums and sums of squares)."""
    flat = torch.cat([p.detach().reshape(-1).double()
                      for p in model.parameters()])
    sums = torch.stack([flat.sum(), flat.square().sum()])[None]
    every = meshlib.all_gather(sums, mesh, meshlib.batch_axes(mesh))
    return bool((every == every[:1]).all())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def _close(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(), **TOL)


def run_sections(n: int, device=None) -> dict:
    """The dry run's body, on every rank of a process group of at least
    ``n`` ranks (the sections use the first ``n``; the others only join
    the mesh constructions), on the rank's card unless ``device`` says
    otherwise. Returns {section: seconds} on a member rank and the kernel
    launches it made, {} elsewhere."""
    from calipsync_tpu_torch import kernels
    from calipsync_tpu_torch.core.ep import (init_moe_params, moe_ffn,
                                             moe_ffn_ep)
    from calipsync_tpu_torch.core.pp import hubert_pp_apply
    from calipsync_tpu_torch.core.tp import shard_hubert
    from calipsync_tpu_torch.infer.synthesizer import (
        make_generate_resident_fn, make_generate_resident_sharded_fn)
    from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel
    from calipsync_tpu_torch.train.trainer import (build_model,
                                                   create_train_state,
                                                   create_zero1_state,
                                                   make_resident_train_step,
                                                   make_train_step)

    dev = resolve_device(device)
    times: dict = {}
    t0 = time.perf_counter()

    def mark(section):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        times[section] = now - t0
        if meshlib.process_index() == 0:
            print(f"dryrun section {section}: {now - t0:.1f}s", flush=True)
        t0 = now

    # every rank builds every mesh, in the same order (collective)
    mesh = meshlib.make_mesh(data=n)
    s = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    pmesh = meshlib.make_named_mesh((s,), ("model",))
    tmesh = meshlib.make_named_mesh((n // s, s), ("data", "model"))
    emesh = meshlib.make_named_mesh((s,), ("expert",))
    if not mesh.is_member():
        return {}
    kernels.reset_launches()

    rng = np.random.default_rng(0)
    b = n
    batch = {k: rng.integers(0, 255, (b, 160, 160, 3)).astype(np.uint8)
             for k in ("ref", "masked", "target")}
    batch["index"] = np.arange(b, dtype=np.int64)
    feats = torch.from_numpy(
        rng.standard_normal((32, 2, 1024)).astype(np.float32)).to(dev)
    store = torch.from_numpy(rng.integers(
        0, 255, (8, 160 * 160 * 3)).astype(np.uint8)).to(dev)
    cfg = TrainConfig(batch_size=b)
    model = build_model(ModelConfig()).to(dev)
    state = create_train_state(meshlib.replicate(model, mesh), cfg)
    mark("init")

    idx = torch.arange(b)
    metrics = make_resident_train_step(cfg, mesh=mesh)(
        state, store, idx, idx % 8, (idx + 3) % 8, feats)
    loss = float(metrics["loss"])
    _check(np.isfinite(loss), f"DP loss {loss}")
    _check(_replicas_equal(state.model, mesh), "DP replicas differ")
    mark("resident_dp_step")

    zcfg = TrainConfig(batch_size=b, zero1=True)
    zmodel = build_model(ModelConfig()).to(dev)
    zstate = create_zero1_state(meshlib.replicate(zmodel, mesh), zcfg, mesh)
    zmetrics = make_train_step(zcfg, mesh)(zstate, batch, feats)
    zero1_loss = float(zmetrics["loss"])
    _check(np.isfinite(zero1_loss), f"ZeRO-1 loss {zero1_loss}")
    _check(zstate.step == 1 and _replicas_equal(zstate.model, mesh),
           "ZeRO-1 replicas differ")
    mark("zero1_step")

    crop = CropConfig()
    gen = make_generate_resident_sharded_fn(state.model.eval(), crop, mesh,
                                            transfer_format="yuv420",
                                            device=dev)
    preds = gen(store, (idx % 8).to(dev), feats, idx.to(dev))
    _check(preds.shape == (b, 160 * 160 * 3 // 2), f"rows {preds.shape}")
    one = make_generate_resident_fn(state.model, crop, "yuv420", dev)(
        store, (idx % 8).to(dev), feats, idx.to(dev))
    _check((preds.int() - one.int()).abs().max() <= 1,
           "sharded rows differ from one rank's")
    mark("sharded_serve")

    tiny = HubertConfig(**TINY_HUBERT)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        hubert = HubertModel(tiny).to(dev).eval()
    wav = torch.from_numpy(
        rng.standard_normal((4, 400)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        if pmesh.is_member():
            _close(hubert_pp_apply(hubert, wav, pmesh, num_microbatches=4),
                   hubert(wav))
        mark("pp_hubert")

        dp = n // s
        twav = torch.from_numpy(
            rng.standard_normal((dp * 2, 400)).astype(np.float32)).to(dev)
        ref = hubert(twav)
        shard_hubert(hubert, tmesh)
        local = hubert(meshlib.shard_rows(twav, tmesh, "data"))
        _close(meshlib.all_gather(local, tmesh, "data"), ref)
        mark("tp_hubert")

        if emesh.is_member():
            params = {k: v.to(dev) for k, v in
                      init_moe_params(32, 64, 4, seed=3).items()}
            tok = torch.from_numpy(
                rng.standard_normal((16, 32)).astype(np.float32)).to(dev)
            _close(moe_ffn_ep(params, tok, emesh, capacity_factor=1.25),
                   moe_ffn(params, tok, capacity_factor=1.25, groups=s))
        mark("ep_moe")

    return {"times": times, "loss": loss, "zero1_loss": zero1_loss,
            "launches": kernels.launch_counts()}


def dryrun_multichip(n: int, device=None) -> dict:
    """Run :func:`run_sections` on ``n`` new ranks (``launch``) and print
    the summary; returns rank 0's result. The ranks run on the cards
    (``device=None`` raises without CUDA), rank r on card r over NCCL, or
    on the CPU over gloo with ``device="cpu"``."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} cards, "
                         f"{torch.cuda.device_count()} visible: NCCL refuses "
                         "two ranks a card")
    t0 = time.perf_counter()
    results = meshlib.launch(run_sections, n, n, dev.type, backend=backend)
    r = results[0]
    print(f"dryrun_multichip({n}): ok, loss={r['loss']:.4f}, "
          f"zero1_loss={r['zero1_loss']:.4f}, pp/tp hubert and ep moe "
          f"equal, sections {sum(r['times'].values()):.1f}s, wall "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
