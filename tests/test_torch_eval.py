"""The port's evaluation path (calipsync_tpu_torch nn/syncnet.py,
train/syncnet_trainer.py, nn/lpips.py, eval.py and the syncnet-train,
eval and sync-score commands) against the JAX package on the CPU, fp32.

Weights are the JAX modules' own (``init`` from a key, or the JAX
importer's; every BatchNorm statistic and conv bias randomized so the
conversion shows), carried across with ``core/weights.py``'s
``from_jax_syncnet`` and ``from_jax_lpips``; inputs come from numpy
seeds. Tolerance: the repo's
bar, rtol 1e-3 / atol 1e-5, unless a test states another and why. Each
JAX function is traced once in the module.
"""

import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu import cli as jax_cli
from calipsync_tpu import eval as jeval
from calipsync_tpu.nn import lpips as jlpips
from calipsync_tpu.nn import syncnet as jsync
from calipsync_tpu.train import syncnet_trainer as jtrainer
from calipsync_tpu_torch import cli, eval as peval
from calipsync_tpu_torch.bench_assets import (SYNC_PLANT_SHIFT,
                                               planted_sync,
                                               random_state_dict,
                                               write_eval_weights)
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core.weights import (from_jax_lpips,
                                              from_jax_syncnet, from_jax_vgg,
                                              random_jax_vgg)
from calipsync_tpu_torch.kernels.measure import grad_agreement
from calipsync_tpu_torch.nn import lpips, syncnet
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.nn.vgg import VGG19Features
from calipsync_tpu_torch.train import syncnet_trainer
from calipsync_tpu_torch.train.trainer import TrainState

RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _audio_shape(mode, b=1):
    return (b, 32, 32, 32) if mode == "hubert" else (b, 16, 32, 256)


_INITS: dict = {}


def _jax_init(mode):
    """hubert: JAX SyncNet variables from key 0, what JAX's train_sync_net
    starts from; wenet: a port SyncNet's default init through the JAX
    importer (``import_syncnet``), which saves a JAX init."""
    if mode not in _INITS:
        if mode == "hubert":
            v = jax.jit(jsync.SyncNet(mode=mode).init)(
                jax.random.key(0), jnp.zeros((1, 160, 160, 3)),
                jnp.zeros(_audio_shape(mode)))
        else:
            torch.manual_seed(0)
            sd = syncnet.SyncNet(mode=mode).state_dict()
            v = jsync.import_syncnet({k: t.numpy() for k, t in sd.items()},
                                     mode=mode)
        _INITS[mode] = jax.tree_util.tree_map(np.asarray, v)
    return _INITS[mode]


def _jax_forward(mode, pool, train):
    """A jitted JAX SyncNet forward; in train mode it also returns the
    moved batch_stats."""
    net = jsync.SyncNet(mode=mode, pool=pool)
    if train:
        return jax.jit(lambda v, f, a: net.apply(v, f, a, train=True,
                                                 mutable=["batch_stats"]))
    return jax.jit(lambda v, f, a: net.apply(v, f, a))


# one eval forward, shared by the forward test and sync_metrics
_jax_eval = _jax_forward("hubert", "avg", False)


def _randomized(mode):
    """The init with every BN leaf and conv bias randomized."""
    rng = np.random.default_rng(7)

    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if key in ("mean", "bias") or (key == "scale"):
            return (a + rng.standard_normal(a.shape) * 0.1).astype(
                np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, _jax_init(mode))


def _port_syncnet(variables, mode, pool="avg"):
    model = syncnet.SyncNet(mode=mode, pool=pool)
    model.load_state_dict(from_jax_syncnet(variables, mode), strict=True)
    return model


def _inputs(mode, b=2, seed=0):
    rng = np.random.default_rng(seed)
    face = rng.random((b, 160, 160, 3), dtype=np.float32)
    audio = rng.standard_normal(_audio_shape(mode, b)).astype(np.float32)
    return face, audio


# --------------------------------------------------------------- SyncNet

@pytest.mark.parametrize("mode,pool,train", [
    ("hubert", "avg", False), ("hubert", "flatten", True),
    ("wenet", "avg", True), ("wenet", "flatten", False)])
def test_syncnet_forward_matches_jax(mode, pool, train):
    """Embeddings in eval and train mode, and in train mode the running
    statistics each BatchNorm moves (flax: momentum 0.9, biased
    variance)."""
    variables = _randomized(mode)
    face, audio = _inputs(mode)
    if (mode, pool, train) == ("hubert", "avg", False):
        ra, rf = _jax_eval(variables, face, audio)
    elif train:
        (ra, rf), upd = _jax_forward(mode, pool, True)(variables, face, audio)
    else:
        ra, rf = _jax_forward(mode, pool, False)(variables, face, audio)
    model = _port_syncnet(variables, mode, pool).train(train)
    a, f = model(torch.from_numpy(face), torch.from_numpy(audio))
    assert a.shape == ra.shape and f.shape == rf.shape
    _close(a.detach(), ra, msg="audio embedding")
    _close(f.detach(), rf, msg="face embedding")
    if train:
        moved = from_jax_syncnet({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]}, mode)
        n = 0
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                _close(buf, moved[name], msg=name)
                n += 1
        assert n == 2 * (len(syncnet._FACE_PLAN)
                         + len(syncnet._audio_plan(mode)))


def test_syncnet_state_dict_is_the_reference_layout(tmp_path):
    """217 reference keys (hubert), 26.3M parameters as in JAX; a .pth
    loads strictly through load_syncnet, wrapped or bare."""
    model = syncnet.SyncNet()
    sd = model.state_dict()
    assert len(sd) == 217 and "face_encoder.16.conv_block.1.running_var" in sd
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(
            _jax_init("hubert")["params"]))
    ref = from_jax_syncnet(_randomized("hubert"))
    torch.save({"state_dict": ref}, tmp_path / "s.pth")
    loaded = syncnet.load_syncnet(str(tmp_path / "s.pth"), device="cpu")
    assert not loaded.training
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref[k]), k
    with pytest.raises(RuntimeError, match="Missing"):
        syncnet.load_syncnet({k: v for k, v in ref.items()
                              if "audio_encoder.13" not in k}, device="cpu")


def test_cosine_bce_loss_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 16)).astype(np.float32)
    v = rng.standard_normal((5, 16)).astype(np.float32)
    v[0] = a[0]  # similarity 1: clipped at 1 - 1e-7
    y = np.array([1, 0, 1, 1, 0], np.float32)
    ref = jsync.cosine_bce_loss(jnp.asarray(a), jnp.asarray(v),
                                jnp.asarray(y))
    out = syncnet.cosine_bce_loss(*(torch.from_numpy(x) for x in (a, v, y)))
    _close(out, ref)


def test_syncnet_train_step_matches_jax():
    """One Adam update at B=2 (hubert, avg) through the trainer's step:
    the loss and the moved running statistics at the repo's bar.
    Gradients: per element, 19 of the 62 leaves miss the bar against JAX's
    (on up to 28% of a leaf's elements, by up to 4e-4 where the leaf
    reaches 0.06): the train-mode BatchNorms of the encoders' 1x1 maps
    normalize two values each at B=2, and the backward through them
    magnifies fp32 rounding. The yardstick is the port's fp64 gradient, as
    for the generator (tests/test_torch_train.py): JAX's fp32 gradient
    must be as close to it as the port's fp32 gradient is
    (kernels/measure.py grad_agreement)."""
    from calipsync_tpu_torch.audio.windows import batched_windows

    mode = "hubert"
    variables = _randomized(mode)
    rng = np.random.default_rng(1)
    face_u8 = rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)
    feats = rng.standard_normal((20, 2, 1024)).astype(np.float32)
    idx = np.array([5, 12])
    windows = batched_windows(torch.from_numpy(feats),
                              torch.from_numpy(idx)).numpy()
    jmodel = jsync.SyncNet(mode=mode)

    def loss_fn(p):
        (a, f), upd = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            face_u8.astype(np.float32) / 255.0, windows, train=True,
            mutable=["batch_stats"])
        return (jsync.cosine_bce_loss(a, f, jnp.ones((2,), jnp.float32)),
                upd["batch_stats"])

    grads, losses = {}, {}
    # JAX compiles and steps on a thread of its own while the port steps
    # here (XLA and torch release the GIL while they compute)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True)), variables["params"])
        for dt in (torch.float32, torch.float64):
            model = _port_syncnet(variables, mode).train().to(dt)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            step = syncnet_trainer.make_step(
                model, opt, torch.from_numpy(feats).to(dt), mode)
            losses[dt] = float(step(torch.from_numpy(face_u8),
                                    torch.from_numpy(idx)))
            grads[dt] = {n: p.grad for n, p in model.named_parameters()}
            if dt == torch.float32:
                stats = {name: buf for name, buf in model.named_buffers()
                         if name.endswith(("running_mean", "running_var"))}
        (ref_loss, ref_stats), ref_grads = pending.result()
    ref = from_jax_syncnet({"params": ref_grads, "batch_stats": ref_stats})
    for name, buf in stats.items():
        _close(buf, ref[name], msg=name)
    _close(losses[torch.float32], ref_loss)
    _close(losses[torch.float64], ref_loss)
    theirs = {n: torch.from_numpy(np.array(ref[n]))
              for n in grads[torch.float32]}
    agree = grad_agreement(theirs, grads[torch.float32],
                           grads[torch.float64])
    assert agree["ok"], (agree["bad"], agree["rms"], agree["rms_plain"])
    assert len(agree["errors"]) > 0.5 * len(theirs)


# --------------------------------------------------------------- trainer

def test_train_sync_net_matches_jax(synthetic_step1_dir, tmp_path):
    """JAX's train_sync_net and the port's from the same init (JAX's key-0
    init carried in as a reference-layout .pth), B=4 in the same data
    order: the first two yielded epoch losses agree (the second after one
    Adam update). A port checkpoint directory warm-starts a model; an
    Orbax one raises."""
    pth = tmp_path / "init.pth"
    torch.save(from_jax_syncnet(_jax_init("hubert")), pth)
    kw = dict(mode="hubert", batch_size=4, epochs=1, seed=0)
    # JAX trains on a thread of its own while the port trains here (XLA
    # and torch release the GIL while they compute)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(lambda: list(itertools.islice(
            jtrainer.train_sync_net(str(tmp_path / "jax"),
                                    str(synthetic_step1_dir), **kw), 2)))
        ours = list(itertools.islice(syncnet_trainer.train_sync_net(
            str(tmp_path / "port"), str(synthetic_step1_dir),
            base_last_model=str(pth), device="cpu", **kw), 2))
        ref = pending.result()
    assert [r[:4] for r in ours] == [r[:4] for r in ref] == [
        (0, 7, 0, 1), (1, 7, 0, 1)]
    _close([r[4] for r in ours], [r[4] for r in ref])

    model = syncnet.SyncNet()
    state = TrainState(model, torch.optim.Adam(model.parameters()))
    ckpt.save_checkpoint(tmp_path / "run", 3, state)
    syncnet_trainer.load_base(syncnet.SyncNet(), str(tmp_path / "run"))
    (tmp_path / "orbax" / "3").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        syncnet_trainer.load_base(model, str(tmp_path / "orbax"))


def test_three_strikes_swap(synthetic_step1_dir, tmp_path, monkeypatch):
    """The reference's bookkeeping on a stubbed loss sequence: best is
    saved when an epoch's loss does not rise; after three epochs above
    the best, the current weights become the best; last every epoch."""
    losses = iter([5.0, 4.0, 6.0, 7.0, 8.0, 9.0, 3.0])
    monkeypatch.setattr(syncnet_trainer, "make_step",
                        lambda *a: lambda face, idx: torch.tensor(
                            next(losses)))
    saved = []
    monkeypatch.setattr(ckpt, "save_checkpoint", lambda d, step, state:
                        saved.append((os.path.basename(d), step)))
    out = list(syncnet_trainer.train_sync_net(
        str(tmp_path), str(synthetic_step1_dir), batch_size=25, epochs=7,
        device="cpu"))
    assert [round(r[5], 1) for r in out] == [5.0, 4.0, 4.0, 4.0, 8.0, 8.0,
                                             3.0]
    assert [s for d, s in saved if d == "best"] == [1, 2, 5, 7]
    assert [s for d, s in saved if d == "last"] == list(range(1, 8))


# ----------------------------------------------------------------- LPIPS

_LPIPS_VARS: dict = {}


def _jax_lpips(net):
    """JAX LPIPS variables: init from key 1, heads made non-negative as in
    the released checkpoints."""
    if net not in _LPIPS_VARS:
        x = jnp.zeros((1, 64, 64, 3))
        v = jax.jit(jlpips.LPIPS(net=net).init)(jax.random.key(1), x, x)
        params = dict(v["params"])
        for k in range(5):
            params[f"lin{k}"] = {"kernel": jnp.abs(
                params[f"lin{k}"]["kernel"]) + 0.01}
        _LPIPS_VARS[net] = {"params": params}
    return _LPIPS_VARS[net]


@pytest.mark.parametrize("net", ["vgg", "alex"])
@pytest.mark.parametrize("size", [64, 80])
def test_lpips_matches_jax(net, size):
    """JAX variables -> torchvision trunk and lpips heads state_dicts
    (from_jax_lpips) -> the port's import_lpips and a strict load; the
    distances of uint8 frames (and of a frame with itself) as JAX's."""
    variables = _jax_lpips(net)
    trunk, heads = from_jax_lpips(variables, net)
    model = lpips.load_lpips(trunk, heads, net=net, device="cpu")
    rng = np.random.default_rng(size)
    a = rng.integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-40, 40, a.shape), 0,
                255).astype(np.uint8)
    b[2] = a[2]
    ref = jeval.lpips_distance(variables, a, b, net=net)
    out = peval.lpips_distance(model, a, b)
    assert out.shape == (3,) and out[2] == 0 and (out[:2] > 0).all()
    _close(out, ref)


def test_import_lpips_checks_every_key():
    trunk, heads = from_jax_lpips(_jax_lpips("alex"), "alex")
    lpips.load_lpips(dict(trunk, **{"classifier.1.weight": torch.zeros(1)}),
                     heads, net="alex", device="cpu")  # non-features: ok
    with pytest.raises(KeyError):
        lpips.import_lpips({k: v for k, v in trunk.items()
                            if k != "features.3.bias"}, heads, net="alex")
    with pytest.raises(KeyError):
        lpips.import_lpips(trunk, {k: v for k, v in heads.items()
                                   if not k.startswith("lin4")}, net="alex")
    with pytest.raises(ValueError, match="unused trunk keys"):
        lpips.import_lpips(dict(trunk, **{"features.12.weight":
                                          torch.zeros(1)}), heads, net="alex")
    with pytest.raises(ValueError, match="unused head keys"):
        lpips.import_lpips(trunk, dict(heads, **{"lin5.model.1.weight":
                                                 torch.zeros(1)}), net="alex")
    with pytest.raises(ValueError, match="unknown LPIPS net"):
        lpips.LPIPS("squeeze")


def test_make_default_lpips_heads_are_uniform():
    model = peval.make_default_lpips("alex", device="cpu")
    for k, c in enumerate((64, 192, 384, 256, 256)):
        w = getattr(model, f"lin{k}").model[1].weight
        assert w.shape == (1, c, 1, 1) and torch.all(w == 1.0 / c)
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    assert np.all(peval.lpips_distance(model, x, x) == 0)


# ------------------------------------------------------------ sync scores

def _planted(n=40, shift=3):
    """Face i carries signal s[i]; feature row i carries s[i - shift]
    (audio leads video by ``shift`` frames)."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal(n + 20).astype(np.float32)
    crops = np.zeros((n, 160, 160, 3), np.float32)
    crops[:, 0, 0, 0] = s[:n]
    feats = np.zeros((n, 2, 1024), np.float32)
    feats[shift:, 0, 0] = s[:n - shift]
    return crops, feats


class _Toy(torch.nn.Module):
    """2-D embeddings (signal, 1): the window's centre row (frame i) packs
    its (0, 0) value at NHWC (0, 0, 16) (audio/windows.py)."""

    def forward(self, faces, windows):
        one = torch.ones(faces.shape[0])
        return (torch.stack([windows[:, 0, 0, 16], one], 1),
                torch.stack([faces[:, 0, 0, 0], one], 1))


def test_sync_metrics_recovers_planted_offset_as_jax():
    crops, feats = _planted()

    def toy_apply(_variables, faces, windows):
        one = jnp.ones(faces.shape[0])
        return (jnp.stack([windows[:, 0, 0, 16], one], 1),
                jnp.stack([faces[:, 0, 0, 0], one], 1))

    ref = jeval.sync_metrics({}, crops, feats, apply_fn=toy_apply,
                             max_offset=8, batch=16)
    ours = peval.sync_metrics(_Toy(), crops, feats, max_offset=8, batch=16)
    assert ours["av_offset_frames"] == ref["av_offset_frames"] == 3
    assert ours["lse_c"] > 0.1 and ours["sim_best"] > ours["sim_at_zero"]
    for k in ("sim_best", "sim_at_zero", "lse_c", "lse_d"):
        _close(ours[k], ref[k], atol=2e-6, msg=k)


def test_sync_metrics_real_syncnet_matches_jax():
    """The same report from JAX's and the port's SyncNet with the same
    carried weights, on uint8 crops: the same offset, the similarities
    within 1e-5 (the reports round to 1e-6)."""
    variables = _randomized("hubert")
    rng = np.random.default_rng(1)
    crops = rng.integers(0, 256, (10, 160, 160, 3), dtype=np.uint8)
    feats = rng.standard_normal((10, 2, 1024)).astype(np.float32)
    ref = jeval.sync_metrics(variables, crops, feats, max_offset=2, batch=2,
                             apply_fn=_jax_eval)
    ours = peval.sync_metrics(_port_syncnet(variables, "hubert").eval(),
                              crops, feats, max_offset=2, batch=4)
    assert ours["n_frames"] == ref["n_frames"] == 10
    assert ours["av_offset_frames"] == ref["av_offset_frames"]
    for k in ("sim_best", "sim_at_zero", "lse_c", "lse_d"):
        _close(ours[k], ref[k], rtol=0, atol=1e-5, msg=k)


def test_planted_sync_clip_shows_its_shift_as_jax():
    """bench_assets.planted_sync, the clip and arranged weights that
    chip_smoke.py scores on the card: the port's and JAX's sync_metrics
    (JAX's SyncNet taking the arranged state_dict through its own
    importer) both find the planted offset with a spread; the
    similarities within 1e-5 (the reports round to 1e-6)."""
    face = np.random.default_rng(2).integers(0, 256, (160, 160, 3),
                                             dtype=np.uint8)
    sd, crops, feats = planted_sync(
        random_state_dict(syncnet.SyncNet(), seed=0), face, 16)
    assert crops.shape == (16, 160, 160, 3) and crops.dtype == np.uint8
    assert feats.shape == (16, 2, 1024)
    ours = peval.sync_metrics(syncnet.load_syncnet(sd, device="cpu"), crops,
                              feats, max_offset=4)
    ref = jeval.sync_metrics(
        jsync.import_syncnet({k: v.numpy() for k, v in sd.items()}), crops,
        feats, max_offset=4, batch=2, apply_fn=_jax_eval)
    assert ours["av_offset_frames"] == ref["av_offset_frames"] \
        == SYNC_PLANT_SHIFT
    assert ours["lse_c"] > 0.1 and ours["sim_best"] > 0.99
    for k in ("sim_best", "sim_at_zero", "lse_c", "lse_d"):
        _close(ours[k], ref[k], rtol=0, atol=1e-5, msg=k)


# --------------------------------------------------- PSNR, VGG and parity

def test_psnr_and_vgg_distance_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    b = a.copy()
    b[0, 0, 0, 0] ^= 8
    b[1] = 255 - b[1]
    assert peval.psnr(a[2], b[2]) == jeval.psnr(a[2], b[2]) == float("inf")
    assert peval.psnr(a, b) == jeval.psnr(a, b)
    np.testing.assert_array_equal(peval.batch_psnr(a, b),
                                  jeval.batch_psnr(a, b))
    variables = random_jax_vgg(seed=0)
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_vgg(variables), strict=True)
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    near = np.clip(x + rng.normal(0, 0.01, x.shape), 0, 1).astype(np.float32)
    far = rng.random((1, 32, 32, 3), dtype=np.float32)
    for y in (x, near, far):
        _close(peval.vgg_distance(vgg, x, y),
               jeval.vgg_distance(variables, x, y))
    assert peval.vgg_distance(vgg, x, near) < peval.vgg_distance(vgg, x, far)


def test_generator_parity_report_on_a_port_generator():
    """A one-block port generator stands in for the reference module: the
    port's fp32 generator loaded from its state_dict is the same function
    (infinite PSNR, error 0); bf16 costs precision, finite PSNR."""
    torch.manual_seed(0)
    ref = Generator(n_blocks=1)
    rep = peval.generator_parity_report(ref, batch=1, device="cpu")
    assert rep == {"psnr_db": float("inf"), "max_abs_err": 0.0,
                   "mean_abs_err": 0.0}
    bf16 = peval.generator_parity_report(ref, batch=1, dtype=torch.bfloat16,
                                         device="cpu")
    assert 20 < bf16["psnr_db"] < float("inf") and bf16["max_abs_err"] > 0


# -------------------------------------------------------------------- CLI

def _cli_json(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out.strip()
    return json.loads(out[out.index("{"):] if out.startswith("{")
                      else out.splitlines()[-1])


def _videos(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (4, 64, 64, 3)).astype(np.uint8)
    noisy = np.clip(base.astype(np.int16)
                    + rng.integers(-3, 4, base.shape), 0, 255
                    ).astype(np.uint8)
    paths = []
    for name, frames in (("a.mp4", base), ("b.mp4", noisy)):
        p = str(tmp_path / name)
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (64, 64))
        for f in frames:
            vw.write(f)
        vw.release()
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def eval_weights(tmp_path_factory):
    return write_eval_weights(str(tmp_path_factory.mktemp("eval_weights")))


def test_cli_eval_matches_jax(tmp_path, capsys, eval_weights):
    """``eval`` with --lpips on seeded alex weights in the torchvision and
    lpips layouts: the JAX command's PSNR and LPIPS on the same files."""
    a, b = _videos(tmp_path)
    w = eval_weights
    argv = ["eval", "--a", a, "--b", b, "--lpips", w["alex_heads"],
            "--lpips-trunk", w["alex_trunk"], "--lpips-net", "alex"]
    ours = _cli_json(cli.main, argv + ["--device", "cpu"], capsys)
    ref = _cli_json(jax_cli.main, argv, capsys)
    assert ours.keys() == ref.keys()
    assert ours["n_frames"] == ref["n_frames"] == 4
    assert ours["psnr_db_mean"] == ref["psnr_db_mean"]
    _close(ours["lpips_mean"], ref["lpips_mean"], atol=1e-5)
    _close(ours["lpips_max"], ref["lpips_max"], atol=1e-5)
    same = _cli_json(cli.main, ["eval", "--a", a, "--b", a, "--device",
                                "cpu"], capsys)
    assert same["psnr_db_mean"] is None
    with pytest.raises(SystemExit, match="lpips-trunk"):
        cli.main(["eval", "--a", a, "--b", b, "--lpips", w["alex_heads"],
                  "--device", "cpu"])


def test_cli_sync_score_and_syncnet_train(synthetic_step1_dir, tmp_path,
                                          capsys, eval_weights):
    """``sync-score`` over a lips directory and over a video, with a
    reference-layout .pth (the report of eval.sync_metrics on the same
    crops), and ``syncnet-train`` for one epoch, then warm-started from
    its checkpoint directory."""
    w = eval_weights
    lips = tmp_path / "lips"
    lips.mkdir()
    imgs = []
    for i in range(6):
        img = cv2.imread(str(synthetic_step1_dir / "full_body_img"
                             / f"{i}.jpg"))[200:360, 120:280]
        cv2.imwrite(str(lips / f"{i:06d}.jpg"), img)
        imgs.append(cv2.imread(str(lips / f"{i:06d}.jpg")))
    feats = str(synthetic_step1_dir / "aud_hu.npy")
    rep = _cli_json(cli.main, [
        "sync-score", "--lips-dir", str(lips), "--features", feats,
        "--syncnet", w["syncnet"], "--max-offset", "2", "--device", "cpu"],
        capsys)
    expect = peval.sync_metrics(
        syncnet.load_syncnet(w["syncnet"], device="cpu"), np.stack(imgs),
        np.load(feats), max_offset=2)
    assert rep.pop("weights") == w["syncnet"]
    assert rep == expect
    video = _videos(tmp_path)[0]
    rep = _cli_json(cli.main, [
        "sync-score", "--video", video, "--features", feats,
        "--max-offset", "1", "--device", "cpu"], capsys)
    assert rep["n_frames"] == 4 and rep["weights"].startswith("random")
    with pytest.raises(SystemExit, match="--video or --lips-dir"):
        cli.main(["sync-score", "--features", feats, "--device", "cpu"])

    # four samples of the step-1 directory: an epoch is one step
    data = tmp_path / "step1"
    for sub in ("full_body_img", "landmarks"):
        (data / sub).mkdir(parents=True)
        for i in range(4):
            name = f"{i}.jpg" if sub == "full_body_img" else f"{i}.lms"
            os.symlink(synthetic_step1_dir / sub / name, data / sub / name)
    np.save(data / "aud_hu.npy", np.load(feats)[:5])
    save = tmp_path / "run"
    out = _cli_json(cli.main, [
        "syncnet-train", "--data", str(data), "--save", str(save),
        "--epochs", "1", "--batch-size", "4", "--log-every", "0",
        "--device", "cpu"], capsys)
    assert out["epochs"] == 1 and np.isfinite(out["final_loss"])
    # the JAX trainer's layout (tests/test_aux_components.py), port files
    assert sorted(os.listdir(save)) == ["best", "last"]
    assert ckpt.latest_step(save / "best") == ckpt.latest_step(
        save / "last") == 1
    out2 = _cli_json(cli.main, [
        "syncnet-train", "--data", str(data), "--save",
        str(tmp_path / "run2"), "--epochs", "1", "--batch-size", "4",
        "--log-every", "0", "--base", str(save / "last"), "--device",
        "cpu"], capsys)
    # warm-started from the updated weights: the same batch, another loss
    assert np.isfinite(out2["final_loss"])
    assert out2["final_loss"] != out["final_loss"]
