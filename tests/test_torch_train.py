"""The port's training (calipsync_tpu_torch.train, pipelines/step2_train,
core/checkpoint, the cross-attention backward, VGG19 and the losses)
against the JAX package, on the CPU in fp32.

Inputs and weights come from numpy seeds and cross into both packages
(``from_jax_generator``, ``from_jax_vgg``). Tolerance: the repo's bar, rtol
1e-3 / atol 1e-5, unless a test states another and why. One full-width
generator step (4 attention blocks, B=2, perceptual term on) is held
against JAX ``make_train_step`` on a 1-device CPU mesh; the mechanics tests
run one attention block.
"""

import copy
import dataclasses
import json
import signal
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu import config as jax_config
from calipsync_tpu.core.mesh import make_mesh, replicate, shard_batch
from calipsync_tpu.core.weights import import_generator
from calipsync_tpu.core.weights_export import export_generator
from calipsync_tpu.kernels import cross_attention as jax_attn
from calipsync_tpu.nn import blocks as jax_blocks
from calipsync_tpu.nn import unet as jax_unet
from calipsync_tpu.nn.vgg import VGG19Features as JaxVGG
from calipsync_tpu.train import loss as jax_loss
from calipsync_tpu.train import trainer as jax_trainer
from calipsync_tpu_torch import cli, config
from calipsync_tpu_torch.bench_assets import make_synthetic_step1
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              from_jax_vgg, random_jax_vgg,
                                              random_jax_generator)
from calipsync_tpu_torch.data.dataset import ResidentLipSyncDataset
from calipsync_tpu_torch.kernels.cross_attention import (
    cross_attention, cross_attention_backward_plain)
from calipsync_tpu_torch.kernels.measure import grad_agreement
from calipsync_tpu_torch.nn.blocks import BatchNorm1d, BatchNorm2d
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.nn.vgg import VGG19Features, vgg19_state_dict
from calipsync_tpu_torch.pipelines import step2_train
from calipsync_tpu_torch.pipelines.step2_train import (GENERATOR_FILE,
                                                       train_digital_model)
from calipsync_tpu_torch.train import loss as port_loss
from calipsync_tpu_torch.train import trainer

RTOL, ATOL = 1e-3, 1e-5
# A block in fp64 against JAX's in float64 (test_train_mode_block_...),
# (rtol, atol per scale): the JAX CrossAttention computes its scores with
# preferred_element_type float32, which rounds them to fp32 (2^-24 of the
# value) even in float64.
BLOCK_TOL_FP64 = (1e-6, 1e-6)
LR = config.TrainConfig().lr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Full-width steps on two intra-op threads: the suite runs beside
    other workers, and more threads spend more CPU for about the same
    wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------- the cross-attention backward

@pytest.mark.parametrize("b,n,d,c", [(2, 100, 16, 32), (3, 77, 24, 40)])
def test_attention_backward_matches_jax_vjp(b, n, d, c):
    """cross_attention_backward_plain, and .backward() through the port's
    differentiable cross_attention, against jax.vjp of the Pallas kernel
    (interpret mode) with its custom_vjp backward."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(b * n + d)
    q = (rng.standard_normal((b, n, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, n, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, n, c)).astype(np.float32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jax_attn.cross_attention, q, k, v)
        ref = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = cross_attention(qt, kt, vt)
    assert got.grad_fn is not None
    got.backward(torch.from_numpy(g))
    _close(got.detach(), out)
    plain = cross_attention_backward_plain(*(torch.from_numpy(a)
                                             for a in (q, k, v, g)))
    for name, t, p, r in zip("qkv", (qt, kt, vt), plain, ref):
        _close(t.grad, r, msg=f"d{name} through backward()")
        _close(p, r, msg=f"d{name} of the plain backward")


def test_attention_backward_casts_to_input_dtype():
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((1, 5, 4)).astype(
        np.float32)).bfloat16() for _ in range(2))
    v = torch.ones(1, 5, 3, dtype=torch.bfloat16)
    dq, dk, dv = cross_attention_backward_plain(q, k, v, torch.ones_like(v))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


# ------------------------------------------------------ BatchNorm in train

@pytest.mark.parametrize("shape", [(2, 3, 3, 4), (2, 5, 6)])
def test_batchnorm_running_stats_match_flax(shape):
    """flax moves the running variance toward the biased batch variance,
    torch's module toward the unbiased one (n/(n-1) apart: n = 18 and 10
    here); the port's BatchNorm follows flax. Channels last in both."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    fbn = jax_blocks.BatchNorm(use_running_average=False)
    variables = fbn.init(jax.random.key(0), jnp.asarray(x))
    y_ref, upd = fbn.apply(variables, jnp.asarray(x),
                           mutable=["batch_stats"])
    stats = upd["batch_stats"]

    xt = torch.from_numpy(x).movedim(-1, 1)
    bn = (BatchNorm2d if len(shape) == 4 else BatchNorm1d)(c).train()
    y = bn(xt).movedim(1, -1)
    _close(y.detach(), y_ref)
    _close(bn.running_mean, stats["mean"], rtol=1e-6, atol=1e-7)
    _close(bn.running_var, stats["var"], rtol=1e-6, atol=1e-7)
    stock = (torch.nn.BatchNorm2d if len(shape) == 4
             else torch.nn.BatchNorm1d)(c).train()
    stock(xt)
    n = x.size // c
    gap = np.abs(stock.running_var.numpy() - np.asarray(stats["var"]))
    assert (gap > 0.1 * np.asarray(stats["var"]) / (n - 1) * 0.5).all()


# ------------------------------------------------------------ VGG and loss

@pytest.fixture(scope="module")
def vgg_pair():
    variables = random_jax_vgg(seed=1)
    vgg = VGG19Features().eval()
    vgg.load_state_dict(from_jax_vgg(variables), strict=True)
    return variables, vgg


def test_vgg_matches_jax(vgg_pair):
    variables, vgg = vgg_pair
    x = np.random.default_rng(2).random((2, 32, 40, 3), dtype=np.float32)
    ref = JaxVGG().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = vgg(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 8, 10, 256)
    assert float(np.asarray(ref).std()) > 1e-2
    _close(out, ref)


def test_vgg_loads_torchvision_keys(tmp_path, vgg_pair):
    """A full torchvision vgg19 state_dict (38 keys) gives the trunk its
    14 by name."""
    from calipsync_tpu_torch.nn.vgg import load_vgg19

    _, vgg = vgg_pair
    sd = {}
    for i in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34):
        sd[f"features.{i}.weight"] = torch.zeros(1)
        sd[f"features.{i}.bias"] = torch.zeros(1)
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = torch.zeros(1)
        sd[f"classifier.{i}.bias"] = torch.zeros(1)
    sd.update(vgg.state_dict())
    assert len(sd) == 38
    assert set(vgg19_state_dict(sd)) == set(vgg.state_dict())
    torch.save(sd, tmp_path / "vgg19.pth")
    loaded = load_vgg19(str(tmp_path / "vgg19.pth"), device="cpu")
    for k, v in vgg.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v)
    del sd["features.14.bias"]
    with pytest.raises(KeyError, match="features.14.bias"):
        vgg19_state_dict(sd)


@pytest.mark.parametrize("perceptual", [True, False])
def test_generator_loss_matches_jax(vgg_pair, perceptual):
    variables, vgg = vgg_pair
    rng = np.random.default_rng(3)
    pred = rng.random((2, 32, 32, 3), dtype=np.float32)
    target = rng.random((2, 32, 32, 3), dtype=np.float32)
    _, ref = jax_loss.generator_loss(jnp.asarray(pred), jnp.asarray(target),
                                     variables if perceptual else None)
    predt = torch.from_numpy(pred).requires_grad_()
    total, metrics = port_loss.generator_loss(
        predt, torch.from_numpy(target), vgg if perceptual else None)
    assert set(metrics) == set(ref)
    for k in ref:
        _close(metrics[k].detach(), ref[k], msg=k)
    # the target's features are detached: the gradient reaches pred only
    total.backward()
    assert predt.grad is not None
    _, zero = port_loss.generator_loss(predt, torch.from_numpy(target), vgg,
                                       perceptual_weight=0.0)
    assert set(zero) == {"loss", "loss_pixel"}


# ------------------------------------------------- the full-width train step

def _batch(seed, b=2, n_rows=12):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, 256, (b, 160, 160, 3), dtype=np.uint8)
             for k in ("ref", "masked", "target")}
    batch["index"] = rng.integers(0, n_rows, b).astype(np.int32)
    feats = rng.standard_normal((n_rows, 2, 1024)).astype(np.float32)
    return batch, feats


def _jax_stepper(n_blocks, batch_size, vgg_variables=None, dtype=None):
    """JAX make_train_step on a 1-device CPU mesh, compiled on the first
    call: fn(variables, batch, feats) -> (metrics, the new state's params,
    batch_stats, and gradients from Adam's first moment, mu = (1 - b1) g
    after the first update), numpy trees. ``dtype`` (e.g. jnp.float64,
    under jax.enable_x64) overrides the config's compute dtype."""
    mesh = make_mesh(data=1)
    tcfg = jax_config.TrainConfig(batch_size=batch_size)
    model = (jax_unet.Generator(n_blocks=n_blocks, dtype=dtype,
                                axis_name="data") if dtype is not None
             else jax_trainer.build_model(jax_config.ModelConfig(
                 n_blocks=n_blocks), axis_name="data"))
    tx = jax_trainer.adam(tcfg)
    step = jax_trainer.make_train_step(
        model, tx, mesh, tcfg, use_perceptual=vgg_variables is not None)
    vgg = replicate(vgg_variables or {}, mesh)

    def run(variables, batch, feats):
        state = jax_trainer.create_train_state(
            model, tx, jax.random.key(0),
            jax.tree_util.tree_map(jnp.asarray, variables))
        state, metrics = step(replicate(state, mesh),
                              shard_batch(batch, mesh),
                              replicate(jnp.asarray(feats), mesh), vgg)
        mu = state.opt_state[0].mu
        grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu)
        return (_np_tree(metrics), _np_tree(state.params),
                _np_tree(state.batch_stats), grads)

    return run


def _port_step(variables, batch, feats, n_blocks, vgg_variables=None,
               dtype=torch.float32, **train_kw):
    """One port step from the JAX variables; ``dtype`` float64 casts the
    parameters too (the yardstick of _check_grads)."""
    model = Generator(n_blocks=n_blocks, dtype=dtype)
    model.load_state_dict(from_jax_generator(variables, n_blocks=n_blocks),
                          strict=True)
    vgg = None
    if vgg_variables is not None:
        vgg = VGG19Features(dtype).eval()
        vgg.load_state_dict(from_jax_vgg(vgg_variables), strict=True)
        vgg.to(dtype)
    tcfg = config.TrainConfig(batch_size=len(batch["index"]), **train_kw)
    state = trainer.create_train_state(model.to(dtype), tcfg)
    metrics = trainer.make_train_step(tcfg)(
        state, batch, torch.from_numpy(feats).to(dtype), vgg)
    return state, {k: float(v) for k, v in metrics.items()}


def _exported(params, stats, n_blocks):
    """A JAX (params, batch_stats) pair under the port's keys."""
    return export_generator({"params": params, "batch_stats": stats},
                            mode="hubert", n_blocks=n_blocks)


# audio_model.conv3/conv5 carry a bias in the reference layout that the
# JAX model folds into the BN's running mean: there is no JAX parameter, and
# ahead of a train-mode BN its gradient is zero (rounding noise here).
FOLDED_BIASES = ("audio_model.conv3.bias", "audio_model.conv5.bias")


@pytest.fixture(scope="module")
def full_width():
    """The full-width generator's and VGG's weights, a batch, and the JAX
    step compiled for them (n_blocks=4, B=2, perceptual on)."""
    vgg_variables = random_jax_vgg(seed=1)
    variables = random_jax_generator(n_blocks=4, seed=5)
    batch, feats = _batch(6)
    return (variables, vgg_variables, batch, feats,
            _jax_stepper(4, 2, vgg_variables))


@pytest.fixture(scope="module")
def full_width_step(full_width):
    variables, vgg_variables, batch, feats, jax_step = full_width
    # JAX compiles and steps on a thread of its own while the port steps
    # here (XLA and torch release the GIL while they compute)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(jax_step, variables, batch, feats)
        state, metrics = _port_step(variables, batch, feats, 4,
                                    vgg_variables)
        exact, _ = _port_step(variables, batch, feats, 4, vgg_variables,
                              dtype=torch.float64)
        ref = pending.result()
    return ref, state, metrics, exact


# One block of the generator in train mode, JAX module name -> (the JAX
# module, the port's submodule, input shapes NHWC at the generator's widths
# and B=2): the blocks of this slice's trouble, the attention's backward
# and BatchNorm1d's running variance over B*100 tokens.
BLOCKS = {
    "mlp_fusion": (lambda: jax_unet.MLPFusion(1024, 1024), "mlp_fusion",
                   [(2, 10, 10, 512)] * 2),
    "attention_blocks_0": (lambda: jax_unet.AttentionBlock(512, 1024),
                           "attention_blocks.0",
                           [(2, 10, 10, 1024), (2, 10, 10, 512),
                            (2, 10, 10, 1024)]),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_train_mode_block_gradients_match_jax(name):
    """Per element, one block at full width in train mode against the JAX
    module in float64 (jax.enable_x64): the output, the gradients of every
    parameter and input (jax.vjp, one output gradient) and the BN running
    statistics; the port in fp64 to BLOCK_TOL_FP64, the port in fp32 to
    the repo's bar. The absolute part scales with the largest element of
    the reference's output, of its statistics, or of all the block's
    gradients: these reach O(100), and a bias ahead of a train-mode
    BatchNorm (or the key's, under the softmax) has an exact gradient of
    zero, computed as the rounding of sums of that size. A block is
    well-conditioned: the whole step's gradient is not (see _check_grads),
    and a whole JAX step in float64 takes minutes on the CPU (n_blocks=1,
    B=2: 19 s to trace and compile, 168 s to run)."""
    make, path, shapes = BLOCKS[name]
    variables = random_jax_generator(n_blocks=1, seed=19)
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal(sh) for sh in shapes]
    with jax.enable_x64(True):
        params, stats = (jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables[k][name])
            for k in ("params", "batch_stats"))

        def f(p, *x):
            y, upd = make().apply({"params": p, "batch_stats": stats}, *x,
                                  train=True, mutable=["batch_stats"])
            return y, upd["batch_stats"]

        y, vjp, new_stats = jax.vjp(f, params, *map(jnp.asarray, xs),
                                    has_aux=True)
        cot = rng.standard_normal(y.shape)
        grads, *dxs = _np_tree(vjp(jnp.asarray(cot)))
        y, new_stats = np.asarray(y), _np_tree(new_stats)
    assert y.dtype == np.float64
    # the block's gradients and statistics under the port's keys, through
    # export_generator with the rest of the generator's tree around them
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    ref_grads = _exported(dict(zeros, **{name: grads}),
                          variables["batch_stats"], 1)
    ref_stats = _exported(variables["params"], dict(
        variables["batch_stats"], **{name: new_stats}), 1)

    gscale = max(np.abs(g).max() for g in
                 jax.tree_util.tree_leaves((grads, dxs)))
    for dtype, (rtol, atol) in ((torch.float64, BLOCK_TOL_FP64),
                                (torch.float32, (RTOL, ATOL))):
        model = Generator(n_blocks=1, dtype=dtype)
        model.load_state_dict(from_jax_generator(variables, n_blocks=1))
        block = model.get_submodule(path).to(dtype).train()
        xt = [torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
              .requires_grad_() for x in xs]
        out = block(*xt)
        out.backward(torch.from_numpy(cot).to(dtype).permute(0, 3, 1, 2))

        def close(got, ref, msg, scale=None):
            ref = np.asarray(ref, np.float64)
            scale = np.abs(ref).max() if scale is None else scale
            _close(got.double(), ref, rtol=rtol, atol=atol * scale,
                   msg=f"{dtype} {msg}")

        close(out.detach().permute(0, 2, 3, 1), y, "output")
        for i, (t, d) in enumerate(zip(xt, dxs)):
            close(t.grad.permute(0, 2, 3, 1), d, f"input {i} gradient",
                  gscale)
        names = [k for k, _ in block.named_parameters()]
        assert len(names) == len(jax.tree_util.tree_leaves(grads))
        for k, p in block.named_parameters():
            close(p.grad, ref_grads[f"{path}.{k}"], k, gscale)
        for k, b in block.named_buffers():
            if k.endswith(("running_mean", "running_var")):
                close(b, ref_stats[f"{path}.{k}"], k)


def test_train_step_loss_matches_jax(full_width_step):
    (ref_metrics, *_), _, metrics, _ = full_width_step
    assert set(metrics) == set(ref_metrics) == {"loss", "loss_pixel",
                                                "loss_perceptual"}
    for k, v in ref_metrics.items():
        _close(metrics[k], v, msg=k)


def _check_grads(state, exact, ref_stats, grads, n_blocks):
    """Every gradient leaf of JAX's step against the port's.

    In train mode this random network is ill-conditioned in fp32: a
    perturbation at a block's input about doubles through the block, so
    the forwards agree to 5e-4 at the output but the port's own fp32
    gradient differs from its fp64 gradient by a median 6% a leaf (up to
    tens of % on leaves whose gradient nearly cancels), and JAX's fp32
    gradient by as much; two XLA programs of the same JAX step differ as
    much too. No per-element tolerance can hold. The yardstick is the
    port's fp64 gradient (``exact``, the same math without the rounding):
    JAX's fp32 gradient must be as close to it as the port's fp32 gradient
    is (kernels/measure.py grad_agreement: within 5x plus 1% of the leaf's
    norm on every leaf, where the ratio's tail over the 300 leaves reaches
    3.4 and a wrong layout or formula gives O(1) errors, and within 1.5x in
    rms, where its median is 1.1). Leaves whose exact gradient is zero (a bias ahead of a train-mode
    BatchNorm, the key's bias under the softmax, the folded conv biases)
    must be zero to rounding on both sides."""
    ref = _exported(grads, ref_stats, n_blocks)
    ours = {n: p.grad for n, p in state.model.named_parameters()}
    theirs = {n: torch.zeros_like(g) if n in FOLDED_BIASES
              else torch.from_numpy(np.array(ref[n]))
              for n, g in ours.items()}
    agree = grad_agreement(
        theirs, ours, {n: p.grad for n, p in
                       exact.model.named_parameters()})
    assert agree["ok"], (agree["bad"], agree["rms"], agree["rms_plain"])
    assert len(agree["errors"]) > 0.9 * len(ours)
    for i in range(n_blocks):
        for proj in ("query", "key", "value"):
            g = ours[f"attention_blocks.{i}.cross_attention.{proj}_conv."
                     "weight"]
            assert g.abs().max() > 1e-6, f"block {i} {proj}: no gradient"


def test_train_step_gradients_match_jax(full_width_step):
    (_, _, ref_stats, grads), state, _, exact = full_width_step
    _check_grads(state, exact, ref_stats, grads, 4)


def _check_bn_stats(model, ref_params, ref_stats, n_blocks):
    ref = _exported(ref_params, ref_stats, n_blocks)
    n = 0
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _close(b, ref[name], msg=name)
            n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                        for m in model.modules())


def test_train_step_bn_statistics_match_jax(full_width_step):
    (_, ref_params, ref_stats, _), state, _, _ = full_width_step
    _check_bn_stats(state.model, ref_params, ref_stats, 4)


def test_train_step_params_within_adam_envelope(full_width_step):
    """The first Adam update is lr * g / (|g| + eps), about lr * sign(g):
    where the gradients' signs differ between the frameworks (fp32 noise,
    see _check_grads) a parameter may differ by up to 2 lr
    (calipsync_tpu/train/trainer.py:512-521); where they share a sign and
    |g| > 1e-4 on both sides, the parameters agree to 1e-6."""
    (_, ref_params, ref_stats, grads), state, _, _ = full_width_step
    ref = _exported(ref_params, ref_stats, 4)
    ref_grads = _exported(grads, ref_stats, 4)
    assert state.step == 1
    for name, p in state.model.named_parameters():
        d = np.abs(p.detach().numpy() - ref[name])
        assert d.max() <= 2 * LR * (1 + RTOL) + ATOL, name
        g, gj = p.grad.numpy(), ref_grads[name]
        # lr g / (|g| + 1e-8) is within lr * 1e-4 of lr sign(g) there
        same = (np.sign(g) == np.sign(gj)) & (np.minimum(
            np.abs(g), np.abs(gj)) > 1e-4)
        if same.any():
            assert d[same].max() <= 1e-6, name


# --------------------------------------------------- options and mechanics

def test_grad_accum_matches_jax(full_width, full_width_step):
    """grad_accum=2 at full width: a batch of 4 in two microbatches of 2,
    the BN statistics carried from the first to the second, gradients and
    metrics averaged, one Adam update. JAX's accumulation
    (calipsync_tpu/train/trainer.py _local_grads) is rebuilt from the
    module's compiled make_train_step: the first microbatch is
    full_width_step's, the second runs from the initial parameters and the
    first one's BN statistics. The port's metrics and BN statistics are
    held against it at the repo's bar; its gradient against the mean of
    its own single steps on the two microbatches (a train-mode forward
    reads no running statistics), to rounding: the single step's gradient
    is held against JAX's in test_train_step_gradients_match_jax."""
    variables, vgg_variables, first, feats, jax_step = full_width
    (m1, _, stats1, _), single1, _, _ = full_width_step
    second, _ = _batch(20)
    with ThreadPoolExecutor(1) as pool:  # as full_width_step
        pending = pool.submit(jax_step, dict(variables, batch_stats=stats1),
                              second, feats)
        both = {k: np.concatenate([first[k], second[k]]) for k in first}
        state, metrics = _port_step(variables, both, feats, 4,
                                    vgg_variables, grad_accum=2)
        single2, _ = _port_step(variables, second, feats, 4, vgg_variables)
        m2, _, stats2, _ = pending.result()
    assert state.step == 1
    for k in m1:
        _close(metrics[k], (m1[k] + m2[k]) / 2, msg=k)
    _check_bn_stats(state.model, variables["params"], stats2, 4)
    g1, g2 = (dict(s.model.named_parameters()) for s in (single1, single2))
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.grad, (g1[name].grad + g2[name].grad)
                                   / 2, rtol=1e-6, atol=1e-7, msg=name)


def _small_state(seed=9, dtype=torch.float32, **train_kw):
    model = Generator(n_blocks=1, dtype=dtype)
    model.load_state_dict(from_jax_generator(
        random_jax_generator(n_blocks=1, seed=seed), n_blocks=1))
    tcfg = config.TrainConfig(batch_size=2, **train_kw)
    return trainer.create_train_state(model, tcfg), tcfg


def _snapshot(state):
    return {**{k: v.detach().clone() for k, v in
               state.model.state_dict().items()},
            **{f"grad:{k}": p.grad.clone() for k, p in
               state.model.named_parameters() if p.grad is not None}}


def test_remat_equals_no_remat():
    """Recomputing the activations in the backward pass changes nothing:
    loss, gradients, parameters and the BN buffers, which the recompute
    would otherwise move a second time."""
    batch, feats = _batch(10)
    runs = []
    for remat in (False, True):
        state, tcfg = _small_state(remat=remat)
        m = trainer.make_train_step(tcfg)(state, batch,
                                          torch.from_numpy(feats))
        runs.append((float(m["loss"]), _snapshot(state)))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    assert s0.keys() == s1.keys()
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


def test_attention_projection_check_fails_wrong_gradients():
    """kernels/measure.py attention_grad_errors, which chip_smoke.py holds
    the card's train steps to: a step's own projection gradients pass
    TOL_PROJ_GRAD (on the CPU the step and the re-run run the same plain
    ops), and a zero gradient, a flipped sign or a scale of 3 fail it."""
    from calipsync_tpu_torch.kernels import measure
    from calipsync_tpu_torch.nn.blocks import PLAIN_OPS

    batch, feats = _batch(13)
    state, tcfg = _small_state()
    records, hooks = measure.record_attention(state.model)
    trainer.make_train_step(tcfg)(state, batch, torch.from_numpy(feats))
    for h in hooks:
        h.remove()
    assert list(records) == ["attention_blocks.0.cross_attention"]
    errors = measure.attention_grad_errors(state.model, records, PLAIN_OPS)
    assert len(errors) == 3
    assert max(errors.values()) <= 1e-6
    tol = min(measure.TOL_PROJ_GRAD.values())
    grad = state.model.attention_blocks[0].cross_attention.key_conv.weight.grad
    for wrong, expected in ((0.0, 1.0), (-1.0, 2.0), (3.0, 2.0)):
        kept = grad.clone()
        grad.mul_(wrong)
        errors = measure.attention_grad_errors(state.model, records,
                                               PLAIN_OPS)
        grad.copy_(kept)
        bad = errors["attention_blocks.0.cross_attention.key_conv.weight"]
        assert bad == pytest.approx(expected, rel=1e-6) and bad > tol


@pytest.fixture(scope="module")
def step1_dir(tmp_path_factory):
    return make_synthetic_step1(str(tmp_path_factory.mktemp("step1")),
                                n_frames=6, res=192, seed=3)


def test_resident_step_equals_host_batch_step(synthetic_step1_dir):
    """The resident step (gather, mask, /255 on the device) and the host
    step on the same sample indices give the same loss and parameters."""
    from calipsync_tpu_torch.data.dataset import (LipSyncDataset,
                                                  batch_iterator)

    host = LipSyncDataset(str(synthetic_step1_dir))
    res = ResidentLipSyncDataset(str(synthetic_step1_dir), device="cpu")
    hb = next(batch_iterator(host, 2, np.random.default_rng(5),
                             num_workers=2))
    idx, fidx, ex = next(res.epoch_indices(2, np.random.default_rng(5)))
    np.testing.assert_array_equal(hb["index"], idx)
    feats = torch.from_numpy(host.audio_feats)
    runs = []
    for resident in (False, True):
        state, tcfg = _small_state(perceptual_weight=0.0)
        if resident:
            m = trainer.make_resident_train_step(tcfg)(
                state, res.store, idx, fidx, ex, feats)
        else:
            m = trainer.make_train_step(tcfg)(state, hb, feats)
        runs.append((float(m["loss"]), _snapshot(state)))
    (l0, s0), (l1, s1) = runs
    _close(l1, l0, rtol=1e-6, atol=0)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_eval_step_after_training_sees_the_update(tmp_path):
    """An eval step between training steps serves the updated weights, not
    BN folds cached before the update: the trained model's eval output
    equals a fresh model's loaded from its state_dict."""
    batch, feats = _batch(11)
    state, tcfg = _small_state()
    step, evaluate = trainer.make_train_step(tcfg), trainer.make_eval_step()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((2, 160, 160, 6), dtype=np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 32, 32, 32)).astype(
        np.float32))
    before = evaluate(state.model, x, a)
    step(state, batch, torch.from_numpy(feats))
    after = evaluate(state.model, x, a)
    fresh = Generator(n_blocks=1)
    fresh.load_state_dict(state.model.state_dict())
    torch.testing.assert_close(after, evaluate(fresh, x, a), rtol=0,
                               atol=0)
    assert (after - before).abs().max() > 1e-4


def test_checkpoint_round_trip(tmp_path):
    """Model, Adam state and step count come back as saved; the latest
    step is the largest key. (Any module: the checkpoint does not depend
    on the generator.)"""
    def state(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                    torch.nn.BatchNorm1d(3))
        return trainer.TrainState(model, torch.optim.Adam(
            model.parameters(), lr=LR))

    saved = state(0)
    saved.model(torch.randn(5, 4)).square().mean().backward()
    saved.optimizer.step()
    saved.step = 1
    path = ckpt.save_checkpoint(tmp_path, 4, saved)
    assert path.exists() and ckpt.latest_step(tmp_path) == 4
    ckpt.save_checkpoint(tmp_path, 2, saved)
    assert ckpt.latest_step(tmp_path) == 4
    assert ckpt.latest_step(tmp_path / "missing") is None
    fresh = ckpt.restore_checkpoint(tmp_path, state(1))
    assert fresh.step == 1
    for k, v in saved.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    a, b = saved.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in a["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(b["state"][i][name], s[name])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "empty", fresh)


def test_adam_load_keeps_capturable_and_copies_in_place():
    """trainer.Adam: a state_dict written by a capturable (card) optimizer
    loads into a CPU one, which stays not capturable (its step count on
    the host), and a load copies into the moments the optimizer holds, so
    a CUDA graph that reads them sees the loaded values."""
    state, tcfg = _small_state()
    batch, feats = _batch(12)
    trainer.make_train_step(tcfg)(state, batch, torch.from_numpy(feats))
    opt = state.optimizer
    assert isinstance(opt, trainer.Adam)
    assert opt.param_groups[0]["capturable"] is False
    saved = copy.deepcopy(opt.state_dict())  # state_dict shares the dicts
    saved["param_groups"][0]["capturable"] = True
    held = {id(v) for st in opt.state.values() for v in st.values()}
    want = [st["exp_avg"].clone() * 2 for st in opt.state.values()]
    for st in saved["state"].values():
        st["exp_avg"] = st["exp_avg"] * 2
    opt.load_state_dict(saved)
    assert opt.param_groups[0]["capturable"] is False
    assert {id(v) for st in opt.state.values() for v in st.values()} == held
    for st, w in zip(opt.state.values(), want):
        torch.testing.assert_close(st["exp_avg"], w, rtol=0, atol=0)
        assert st["step"].device.type == "cpu"


def test_preemption_guard_latches_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with ckpt.PreemptionGuard() as guard:
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before


# The whole step in float64, JAX against the port: 5x the floor of 6e-4 of
# a leaf's norm that JAX's fp32 pins leave (ROADMAP.md C.4).
STEP_FP64_LEAF_TOL = 3e-3


def _train_cfg(**train):
    return config.PipelineConfig(
        model=config.ModelConfig(n_blocks=1),
        train=config.TrainConfig(batch_size=2, epochs=1, num_workers=2,
                                 **train))


@pytest.fixture(scope="module")
def trained(step1_dir, tmp_path_factory):
    """One epoch of train_digital_model on the synthetic speaker (6
    frames, 3 steps of 2), from a reference-layout .pth."""
    save = tmp_path_factory.mktemp("run")
    variables = random_jax_generator(n_blocks=1, seed=15)
    base = save / "base.pth"
    torch.save(from_jax_generator(variables, n_blocks=1), base)
    losses = []
    path = train_digital_model(step1_dir, str(save), unet_checkpoint=str(
        base), cfg=_train_cfg(), loss_history=losses, device="cpu")
    return save, path, losses


def test_train_digital_model_generator_pth_loads_in_jax(trained):
    """generator.pth is a bare reference-layout state_dict: the JAX
    import_generator reads it, and the two eval forwards agree."""
    from calipsync_tpu.nn.unet import Generator as JaxGenerator

    save, path, losses = trained
    assert path.endswith("step_1.pt") and len(losses) == 3
    assert np.isfinite(losses).all()
    sd = torch.load(save / GENERATOR_FILE, weights_only=True)
    model = Generator(n_blocks=1).eval()
    model.load_state_dict(sd, strict=True)
    variables = import_generator({k: v.numpy() for k, v in sd.items()},
                                 n_blocks=1)
    rng = np.random.default_rng(16)
    x = rng.random((2, 160, 160, 6), dtype=np.float32)
    a = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
    ref = jax.jit(lambda v, x, a: JaxGenerator(n_blocks=1).apply(
        v, x, a, train=False))(variables, x, a)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(a))
    _close(out, ref)


def _copy_run(src, dst):
    dst.mkdir()
    for f in src.iterdir():
        (dst / f.name).write_bytes(f.read_bytes())
    return dst


def test_resume_continues_from_the_checkpoint(trained, step1_dir,
                                              tmp_path):
    save, _, _ = trained
    run = _copy_run(save, tmp_path / "run")
    cfg = _train_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             epochs=2))
    losses = []
    path = train_digital_model(step1_dir, str(run), cfg=cfg, resume=True,
                               loss_history=losses, device="cpu")
    assert path.endswith("step_2.pt") and len(losses) == 3
    assert torch.load(path, weights_only=True)["step"] == 6


def test_preempted_epoch_is_redone(trained, step1_dir, tmp_path,
                                   monkeypatch):
    """A signal mid-epoch checkpoints under that epoch's key after the
    batch in flight, and resume redoes the epoch from there."""
    save, _, _ = trained
    run = _copy_run(save, tmp_path / "run")
    cfg = _train_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             epochs=2))
    monkeypatch.setattr(ckpt.PreemptionGuard, "triggered",
                        property(lambda self: True))
    losses = []
    path = train_digital_model(step1_dir, str(run), cfg=cfg, resume=True,
                               loss_history=losses, device="cpu")
    assert path.endswith("step_1.pt") and losses == []
    assert torch.load(path, weights_only=True)["step"] == 4
    monkeypatch.undo()
    path = train_digital_model(step1_dir, str(run), cfg=cfg, resume=True,
                               loss_history=losses, device="cpu")
    assert path.endswith("step_2.pt") and len(losses) == 3
    assert torch.load(path, weights_only=True)["step"] == 7


@pytest.mark.parametrize("resident", [True, False])
def test_resumed_run_sees_the_batches_of_an_uninterrupted_run(
        step1_dir, tmp_path, monkeypatch, resident):
    """The data order crosses a checkpoint: two epochs in one run, one
    epoch then a resumed second, and a second epoch preempted after its
    first batch then redone, all draw the same batches. (A resumed run
    once drew the first epoch's order again.)"""
    seen = []

    def recording_step(*_, **__):
        def step(state, *args):
            arrays = (args[1:4] if resident
                      else [args[0][k] for k in sorted(args[0])])
            seen.append(b"".join(np.asarray(a).tobytes() for a in arrays))
            state.step += 1
            return {"loss": torch.zeros(())}
        return step

    monkeypatch.setattr(step2_train, "make_resident_train_step",
                        recording_step)
    monkeypatch.setattr(step2_train, "make_train_step", recording_step)

    def run(name, epochs, **kw):
        cfg = _train_cfg(resident_data=resident)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, epochs=epochs))
        return train_digital_model(step1_dir, str(tmp_path / name), cfg=cfg,
                                   device="cpu", **kw)

    run("whole", 2)
    whole, per_epoch = list(seen), len(seen) // 2
    assert per_epoch == 3 and whole[:3] != whole[3:]
    seen.clear()
    run("resumed", 1)
    run("resumed", 2, resume=True)
    assert seen == whole

    class _TripsAfter:  # preempts at the first batch of the second epoch
        polls = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        @property
        def triggered(self):
            _TripsAfter.polls += 1
            return _TripsAfter.polls > per_epoch

    seen.clear()
    with monkeypatch.context() as m:
        m.setattr(ckpt, "PreemptionGuard", _TripsAfter)
        run("preempted", 2)
    run("preempted", 2, resume=True)
    assert seen[:per_epoch + 1] == whole[:per_epoch + 1]
    assert seen[per_epoch + 1:] == whole[per_epoch:]


@pytest.mark.slow
def test_whole_train_step_in_float64_matches_jax():
    """The whole JAX train step (make_train_step on a 1-device mesh,
    jax.enable_x64, float64 weights and features) against the port's step
    in float64, every gradient leaf, at n_blocks=1, B=2, L1 only. JAX pins
    the attention's scores and the output's sigmoid to fp32 even here, so
    the two stay ~6e-4 of a leaf's norm apart at best (ROADMAP.md C.4):
    STEP_FP64_LEAF_TOL is 5x that floor. Minutes on the CPU."""
    variables = random_jax_generator(n_blocks=1, seed=21)
    batch, feats = _batch(22)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        _, _, ref_stats, grads = _jax_stepper(1, 2, dtype=jnp.float64)(
            v64, batch, feats.astype(np.float64))
        assert all(g.dtype == np.float64
                   for g in jax.tree_util.tree_leaves(grads))
    state, _ = _port_step(variables, batch, feats.astype(np.float64), 1,
                          dtype=torch.float64)
    ref = _exported(grads, ref_stats, 1)
    worst, n = 0.0, 0
    for name, p in state.model.named_parameters():
        if name in FOLDED_BIASES:
            continue
        g = torch.from_numpy(np.array(ref[name], np.float64))
        norm = g.norm().item()
        if norm < 1e-7:  # zero exactly: a bias ahead of a train-mode BN
            assert p.grad.abs().max().item() < 1e-5, name
            continue
        err = (p.grad - g).norm().item() / norm
        worst, n = max(worst, err), n + 1
        assert err <= STEP_FP64_LEAF_TOL, f"{name}: {err:.3g} of its norm"
    print(f"whole step fp64: worst leaf {worst:.3g} of its norm ({n} "
          f"leaves)")
    assert n > 0.9 * sum(1 for _ in state.model.parameters())


@pytest.mark.parametrize("train,n_losses", [
    ({"resident_data": False}, 3),    # host decode through the Prefetcher
])
def test_train_digital_model_data_paths(step1_dir, tmp_path, train,
                                        n_losses):
    losses = []
    path = train_digital_model(step1_dir, str(tmp_path),
                               cfg=_train_cfg(perceptual_weight=0.0,
                                              **train),
                               loss_history=losses, device="cpu")
    assert len(losses) == n_losses and np.isfinite(losses).all()
    assert torch.load(path, weights_only=True)["step"] == n_losses
    with pytest.raises(FileNotFoundError):
        train_digital_model(step1_dir, str(tmp_path), unet_checkpoint=str(
            tmp_path / "missing.pth"), cfg=_train_cfg(), device="cpu")


def test_cli_train_on_cpu(step1_dir, tmp_path, capsys, monkeypatch):
    """`train --device cpu` writes generator.pth and prints its path; the
    port's loader serves it. Without --device and without CUDA it raises;
    --zero1 without data-parallel ranks raises."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": {"n_blocks": 1},
                               "train": {"batch_size": 3,
                                         "num_workers": 2}}))
    args = ["train", "--data", step1_dir, "--save", str(tmp_path / "run"),
            "--epochs", "1", "--dtype", "float32", "--config", str(cfg)]
    cli.main(args + ["--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == str(tmp_path / "run" / GENERATOR_FILE)
    loaded = cli.load_generator(printed, config.load_config(cfg))
    assert isinstance(loaded, Generator)
    with pytest.raises(ValueError, match="zero1 shards"):
        cli.main(args + ["--device", "cpu", "--zero1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)


def test_train_config_matches_jax():
    """The train section: the JAX TrainConfig's fields and defaults,
    steps_per_dispatch included; the data-parallel settings load."""
    ours = dataclasses.asdict(config.TrainConfig())
    theirs = dataclasses.asdict(jax_config.TrainConfig())
    assert ours == theirs and ours["sync_batchnorm"] is True
    cfg = config.load_config(overrides={"train": {
        "epochs": 3, "remat": True, "sync_batchnorm": False,
        "steps_per_dispatch": 4}})
    assert cfg.train.epochs == 3 and cfg.train.remat
    assert not cfg.train.sync_batchnorm
    assert cfg.train.steps_per_dispatch == 4
    cfg = config.load_config(overrides={"train": {"zero1": True},
                                        "mesh": {"data": 2}})
    assert cfg.train.zero1 and cfg.mesh.data == 2
    assert config.load_config(overrides={"mesh": {"data": 1}}).mesh.data == 1
