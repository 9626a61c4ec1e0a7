"""The port's K train steps a dispatch (train/trainer.py
``make_resident_multi_step``, ``TrainConfig.steps_per_dispatch`` and the
blocks of pipelines/step2_train.py) against the JAX package on the CPU in
fp32.

Weights cross by ``from_jax_generator`` (one attention block), inputs come
from numpy seeds; K=2 steps of B=2. The port's K steps run as one
dispatch; JAX's ``make_resident_multi_step`` runs them as K dispatches of
one step each, so that it compiles a one-step program once for the module
instead of an unrolled K-step one (its state carries from dispatch to
dispatch as from step to step: tests/test_train_step.py holds its K-step
dispatch to K single steps at rtol 1e-6). It runs on a thread of its own
while the port steps (XLA and torch release the GIL while they compute).
The bars
are those that tests/test_torch_train.py holds one train step to against
JAX: the first step's losses at rtol 1e-3 / atol 1e-5, and the parameters
at that bar plus Adam's sign-flip envelope, 2 lr a step (a near-zero
gradient whose sign differs between the frameworks moves an element by lr
either way), so 2 lr K here. A later step's losses are held at rtol 5e-3
(LATER_LOSS_RTOL): they are computed from parameters that already differ
by those sign flips. On this block the port's second loss moves by 1.1e-3
of itself with the intra-op thread count alone (2 threads against 4) and
sits 3e-4 to 8e-4 from the same two steps in fp64; JAX's unrolled two-step
program sits 1.5e-3 from them, and JAX's second loss, from either that
program or two one-step dispatches, 1.15e-3 from the port's at 2 threads.
A second step that missed the carry (computed from the initial
parameters) is 1.25e-2 off.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu import config as jax_config
from calipsync_tpu.core.mesh import make_mesh, replicate
from calipsync_tpu.core.weights_export import export_generator
from calipsync_tpu.pipelines import step2_train as jax_step2
from calipsync_tpu.train import trainer as jax_trainer
from calipsync_tpu_torch import config
from calipsync_tpu_torch.bench_assets import make_synthetic_step1
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              random_jax_generator)
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.pipelines import step2_train
from calipsync_tpu_torch.pipelines.step2_train import train_digital_model
from calipsync_tpu_torch.train import trainer

RTOL, ATOL = 1e-3, 1e-5
LATER_LOSS_RTOL = 5e-3
K, B, N_BLOCKS = 2, 2, 1
LR = config.TrainConfig().lr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Full-width steps on two intra-op threads, as test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_multi_step(variables, store, blocks, feats):
    """JAX's make_resident_multi_step on a 1-device CPU mesh, no
    perceptual term, over the K rows of ``blocks`` as K dispatches of one
    step: (losses (K,), params as the port's keys, step)."""
    mesh = make_mesh(data=1)
    tcfg = jax_config.TrainConfig(batch_size=B)
    model = jax_trainer.build_model(
        jax_config.ModelConfig(n_blocks=N_BLOCKS), axis_name="data")
    tx = jax_trainer.adam(tcfg)
    fn = jax_trainer.make_resident_multi_step(model, tx, mesh, tcfg,
                                              use_perceptual=False)
    state = replicate(jax_trainer.create_train_state(
        model, tx, jax.random.key(0),
        jax.tree_util.tree_map(jnp.asarray, variables)), mesh)
    store, feats = (replicate(jnp.asarray(a), mesh) for a in (store, feats))
    ms = []
    for i in range(K):
        state, m = fn(state, store,
                      *(jnp.asarray(b[i:i + 1]) for b in blocks), feats, {})
        ms.append(m)
    metrics = {k: np.concatenate([np.asarray(m[k]) for m in ms])
               for k in ms[0]}
    params = export_generator(
        {"params": jax.tree_util.tree_map(np.asarray, state.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               state.batch_stats)},
        mode="hubert", n_blocks=N_BLOCKS)
    return metrics, params, int(state.step)


def _inputs():
    rng = np.random.default_rng(21)
    store = rng.integers(0, 256, (6, 160 * 160 * 3), dtype=np.uint8)
    blocks = rng.integers(0, 6, (3, K, B)).astype(np.int32)
    feats = rng.standard_normal((12, 2, 1024)).astype(np.float32)
    return store, blocks, feats


def _port_state():
    model = Generator(n_blocks=N_BLOCKS)
    model.load_state_dict(from_jax_generator(
        random_jax_generator(n_blocks=N_BLOCKS, seed=5), n_blocks=N_BLOCKS),
        strict=True)
    tcfg = config.TrainConfig(batch_size=B)
    return trainer.create_train_state(model, tcfg), tcfg


@pytest.fixture(scope="module")
def multi_step():
    """One (K, B) block through the port's make_resident_multi_step on the
    CPU and JAX's, from the same weights, store, indices and features."""
    store, blocks, feats = _inputs()
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(_jax_multi_step, random_jax_generator(
            n_blocks=N_BLOCKS, seed=5), store, blocks, feats)
        state, tcfg = _port_state()
        fn = trainer.make_resident_multi_step(tcfg)
        metrics = fn(state, torch.from_numpy(store), *blocks,
                     torch.from_numpy(feats))
        ref = pending.result()
    return state, fn, metrics, ref


def test_multi_step_losses_match_jax(multi_step):
    """Each of the K losses (step k's from step k-1's parameters): the
    first at the bar of one train step, the later ones at
    LATER_LOSS_RTOL (module docstring); the metrics are (K,) tensors, the
    K steps run one after another on the CPU (no graph), and they are K
    make_resident_train_step calls to the bit: the same losses and
    state."""
    state, fn, metrics, (ref, _, _) = multi_step
    assert not fn.graphed
    assert set(metrics) == set(ref) == {"loss", "loss_pixel"}
    for name, v in ref.items():
        got = metrics[name].numpy()
        assert got.shape == (K,)
        np.testing.assert_allclose(got[0], v[0], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[1:], v[1:], rtol=LATER_LOSS_RTOL,
                                   atol=ATOL, err_msg=name)
    store, blocks, feats = _inputs()
    one, tcfg = _port_state()
    step = trainer.make_resident_train_step(tcfg)
    losses = [float(step(one, torch.from_numpy(store), *blocks[:, i],
                         torch.from_numpy(feats))["loss"])
              for i in range(K)]
    assert metrics["loss"].tolist() == losses and one.step == K
    ours = state.model.state_dict()
    for name, v in one.model.state_dict().items():
        assert torch.equal(ours[name], v), name


def test_multi_step_params_and_count_match_jax(multi_step):
    """The parameters within the bar plus 2 lr K of JAX's, and K updates
    counted on both sides."""
    state, _, _, (_, params, step) = multi_step
    assert state.step == step == K
    for name, p in state.model.named_parameters():
        ref = params[name]
        d = np.abs(p.detach().numpy() - ref)
        assert np.all(d <= ATOL + RTOL * np.abs(ref) + 2 * LR * K), (
            name, float(d.max()))


# ------------------------------------------------- step2's block schedule

class _CountingGuard:
    """A preemption guard that never triggers and counts its polls."""

    polls = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    @property
    def triggered(self):
        _CountingGuard.polls += 1
        return False


def _recorder(seen, array, k):
    def make(*_, **__):
        def step(state, store, idx, fidx, ex, *rest):
            seen.append(np.stack([np.asarray(a) for a in (idx, fidx, ex)]))
            return state, {"loss": array(np.zeros(k, np.float32))}
        return step
    return make


def _jax_schedule(data, save, k, monkeypatch):
    """JAX's train_digital_model for one epoch with its multi-step,
    state, VGG, replication and checkpoint writes stubbed: the (3, K, B)
    index blocks its loop dispatches, and its guard's polls."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(jax_step2, "make_resident_multi_step",
                  _recorder(seen, jnp.asarray, k))
        m.setattr(jax_step2, "create_train_state",
                  lambda *a, **kw: SimpleNamespace())
        m.setattr(jax_step2, "replicate", lambda x, mesh: x)
        m.setattr(jax_step2, "VGG19Features", lambda: SimpleNamespace(
            init=lambda key, x: {}))
        m.setattr(jax_step2.ckpt, "save_checkpoint",
                  lambda d, key, st: f"{d}/{key}")
        m.setattr(jax_step2.ckpt, "PreemptionGuard", _CountingGuard)
        _CountingGuard.polls = 0
        cfg = jax_config.PipelineConfig(
            model=jax_config.ModelConfig(n_blocks=N_BLOCKS),
            mesh=jax_config.MeshConfig(data=1),
            train=jax_config.TrainConfig(batch_size=B, epochs=1,
                                         num_workers=1,
                                         steps_per_dispatch=k))
        jax_step2.train_digital_model(data, str(save), cfg=cfg,
                                      log_every=0)
    return seen, _CountingGuard.polls


@pytest.mark.parametrize("n_batches,k", [(3, 2), (1, 4), (4, 2)])
def test_block_schedule_matches_jax(tmp_path, monkeypatch, n_batches, k):
    """The port's step2 with steps_per_dispatch K groups an epoch's
    batches as JAX's step2 does (calipsync_tpu/pipelines/step2_train.py:
    195-203): the same (K, B) index blocks in the same order, the tail of
    n_batches % K dropped, an epoch shorter than one block wrap-padded to
    K; K updates a block, and the guard polled once a block."""
    data = make_synthetic_step1(str(tmp_path / "s1"), n_frames=n_batches * B,
                                res=192, seed=n_batches)
    theirs, jax_polls = _jax_schedule(data, tmp_path / "jax", k,
                                      monkeypatch)
    ours = []
    make = _recorder(ours, torch.from_numpy, k)

    def counting(*a, **kw):
        fn = make()

        def step(state, *args):
            state.step += k
            return fn(state, *args)[1]
        return step

    monkeypatch.setattr(step2_train, "make_resident_multi_step", counting)
    monkeypatch.setattr(ckpt, "PreemptionGuard", _CountingGuard)
    _CountingGuard.polls = 0
    cfg = config.PipelineConfig(
        model=config.ModelConfig(n_blocks=N_BLOCKS),
        train=config.TrainConfig(batch_size=B, epochs=1, num_workers=1,
                                 steps_per_dispatch=k))
    losses = []
    path = train_digital_model(data, str(tmp_path / "run"), cfg=cfg,
                               loss_history=losses, log_every=0,
                               device="cpu")
    blocks = max(1, n_batches // k)
    assert len(theirs) == len(ours) == blocks
    for a, b in zip(ours, theirs):
        assert a.shape == (3, k, B)
        np.testing.assert_array_equal(a, b)
    assert _CountingGuard.polls == jax_polls == blocks
    assert len(losses) == blocks * k
    assert torch.load(path, weights_only=True)["step"] == blocks * k


def test_steps_per_dispatch_run_checkpoints_and_resumes(tmp_path):
    """step2 with steps_per_dispatch 2 (3 batches an epoch: one block of
    2, the third batch dropped): two epochs write a checkpoint after
    each, at steps 2 and 4; the first one, resumed in another directory,
    reaches step 4 through a second epoch whose losses are those of the
    uninterrupted run."""
    data = make_synthetic_step1(str(tmp_path / "s1"), n_frames=3 * B,
                                res=192, seed=11)
    base = tmp_path / "base.pth"
    torch.save(from_jax_generator(random_jax_generator(n_blocks=N_BLOCKS,
                                                       seed=15),
                                  n_blocks=N_BLOCKS), base)
    cfg = config.PipelineConfig(
        model=config.ModelConfig(n_blocks=N_BLOCKS),
        train=config.TrainConfig(batch_size=B, epochs=2, num_workers=1,
                                 steps_per_dispatch=K, checkpoint_every=1))

    def run(save, **kw):
        losses = []
        path = train_digital_model(data, str(save), unet_checkpoint=str(
            base), cfg=cfg, loss_history=losses, device="cpu", log_every=0,
            **kw)
        return path, losses

    whole_dir, resumed_dir = tmp_path / "whole", tmp_path / "resumed"
    path, whole = run(whole_dir)
    assert path.endswith("step_2.pt") and len(whole) == 2 * K
    first = ckpt.checkpoint_path(whole_dir, 1)
    assert torch.load(first, weights_only=True)["step"] == K
    resumed_dir.mkdir()
    (resumed_dir / first.name).write_bytes(first.read_bytes())
    path, second = run(resumed_dir, resume=True)
    assert path.endswith("step_2.pt")
    assert torch.load(path, weights_only=True)["step"] == 2 * K
    assert second == whole[K:]
    # the three checkpoints hold Adam's moments: ~0.9 GB of temp space
    shutil.rmtree(whole_dir)
    shutil.rmtree(resumed_dir)
