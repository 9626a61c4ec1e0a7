"""The port's multi-card serving and data-parallel training
(core/mesh.py, make_generate_resident_sharded_fn, FrameSynthesizer(mesh=),
MultiStreamSynthesizer(mesh=), the DP step with sync-BN, ZeRO-1, the
hybrid mesh, a 2-rank checkpoint) against the JAX package on the CPU.

JAX runs on the conftest's 8 virtual devices; the port runs on one group
of 4 gloo ranks spawned once for the module (``core.mesh.launch``, the
rank code in ``tests/_torch_ranks.py``), while the parent computes the
JAX references. Weights cross by ``from_jax_generator`` (one attention
block, fp32), inputs come from numpy seeds. Tolerances: the repo's bar,
rtol 1e-3 / atol 1e-5, unless a test states another and why. Where a rank
compares two port results of its own (ZeRO-1 against the mean path, the
hybrid mesh against the flat one) it ships, a tensor, the largest
|ours - ref| / (atol + rtol |ref|) at that bar (``allclose`` holds where
it is at most 1), and a replica's weights ship as fp64 digests.
"""

import ast
import json
import pathlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu import config as jax_config
from calipsync_tpu.config import CropConfig as JaxCrop
from calipsync_tpu.core import mesh as jax_mesh
from calipsync_tpu.core.weights_export import export_generator
from calipsync_tpu.infer.synthesizer import \
    make_generate_resident_sharded_fn as jax_sharded_fn
from calipsync_tpu.nn.unet import Generator as JaxGenerator
from calipsync_tpu.train import trainer as jax_trainer
from calipsync_tpu_torch.bench_assets import (make_synthetic_speaker,
                                              make_synthetic_step1)
from calipsync_tpu_torch.config import (MeshConfig, ModelConfig,
                                        PipelineConfig, TrainConfig)
from calipsync_tpu_torch.core import checkpoint as ckpt
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              random_jax_generator)
from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
from calipsync_tpu_torch.kernels.measure import grad_agreement
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.pipelines.step2_train import train_digital_model

import _torch_ranks as ranks

RTOL, ATOL = 1e-3, 1e-5
LR = jax_config.TrainConfig().lr
# The serving bound (tests/test_torch_serving.py): the port's and JAX's
# generators differ by float rounding, which flips a bgr truncation or a
# yuv420 rounding only at ties, on at most 1e-3 of the values; an I420
# decode scales a chroma LSB by up to 2.018. The same bound holds a
# sharded run against one rank: a rank's forward runs half the rows.
BOUND = {"bgr": 1, "yuv420": 3}
SHARE = 1e-3
FOLDED_BIASES = ("audio_model.conv3.bias", "audio_model.conv5.bias")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _levels(a, b):
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(
        np.int16))
    return int(d.max()), int((d > 0).sum()), d.size


def _within_bound(a, b, fmt):
    worst, changed, total = _levels(a, b)
    assert worst <= BOUND[fmt] and changed <= SHARE * total, (worst, changed)


def _batch(rng, b):
    batch = {k: rng.integers(0, 256, (b, 160, 160, 3)).astype(np.uint8)
             for k in ("ref", "masked", "target")}
    batch["index"] = rng.integers(0, 12, b).astype(np.int64)
    return batch


def _jax_references(variables, inputs):
    """JAX's sharded serving rows (bgr) and its DP step with sync-BN, each
    on a 2-device mesh."""
    mesh = jax_mesh.make_mesh(data=2)
    model = JaxGenerator(n_blocks=ranks.N_BLOCKS)
    jvars = jax_mesh.replicate(jax.tree_util.tree_map(jnp.asarray,
                                                      variables), mesh)
    s = inputs["serve"]
    rows = np.asarray(jax_sharded_fn(model, JaxCrop(), mesh)(
        jvars, jnp.asarray(s["store"]), jnp.asarray(s["phys"], jnp.int32),
        jnp.asarray(s["feats"]), jnp.asarray(s["fidx"], jnp.int32)))

    tcfg = jax_config.TrainConfig(batch_size=2)
    tmodel = jax_trainer.build_model(
        jax_config.ModelConfig(n_blocks=ranks.N_BLOCKS), axis_name="data")
    tx = jax_trainer.adam(tcfg)
    step = jax_trainer.make_train_step(tmodel, tx, mesh, tcfg,
                                       use_perceptual=False)
    state = jax_trainer.create_train_state(
        tmodel, tx, jax.random.key(0),
        jax.tree_util.tree_map(jnp.asarray, variables))
    batch = {k: v.astype(np.int32) if k == "index" else v
             for k, v in inputs["batch"].items()}
    state, metrics = step(jax_mesh.replicate(state, mesh),
                          jax_mesh.shard_batch(batch, mesh),
                          jax_mesh.replicate(jnp.asarray(inputs["feats"]),
                                             mesh), {})
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   state.opt_state[0].mu)

    def exported(params):
        return export_generator({"params": params, "batch_stats": stats},
                                mode="hubert", n_blocks=ranks.N_BLOCKS)

    return {"rows": rows,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": exported(jax.tree_util.tree_map(np.asarray,
                                                     state.params)),
            "grads": exported(grads)}


@pytest.fixture(scope="module")
def cases(synthetic_step3_dir, tmp_path_factory):
    """Every multi-rank case on one 4-rank group, the JAX references
    computed meanwhile; (inputs, per-rank results, JAX references)."""
    tmp = tmp_path_factory.mktemp("mesh")
    variables = random_jax_generator(n_blocks=ranks.N_BLOCKS, seed=5)
    sd = from_jax_generator(variables, n_blocks=ranks.N_BLOCKS)
    rng = np.random.default_rng(3)
    base = tmp / "base.pth"
    torch.save(sd, base)
    speakers = [str(synthetic_step3_dir), make_synthetic_speaker(
        str(tmp / "spk2"), n_frames=9, res=320, seed=5)]
    inputs = {
        "batch": _batch(rng, 2), "batch4": _batch(rng, 4),
        "feats": rng.standard_normal((12, 2, 1024)).astype(np.float32),
        "speakers": speakers,
        "features": rng.standard_normal((4, 2, 1024)).astype(np.float32),
        "ticks": [{"a": rng.standard_normal((1, 2, 1024)).astype(
            np.float32), "b": rng.standard_normal((1, 2, 1024)).astype(
                np.float32)} for _ in range(2)],
        "serve": {"store": rng.integers(0, 256, (8, 160 * 160 * 3)).astype(
            np.uint8), "phys": rng.integers(0, 8, 4),
            "feats": rng.standard_normal((16, 2, 1024)).astype(np.float32),
            "fidx": rng.integers(0, 16, 4)},
        "multi": {"store": rng.integers(0, 256, (6, 160 * 160 * 3)).astype(
            np.uint8), "blocks": rng.integers(0, 6, (3, 2, 2)).astype(
                np.int32), "feats": rng.standard_normal((12, 2, 1024)).astype(
                    np.float32)},
        "step1": make_synthetic_step1(str(tmp / "step1"), n_frames=2,
                                      res=192, seed=3),
        "base": str(base), "save": str(tmp / "run"),
        "train_config": str(tmp / "train.json")}
    (tmp / "train.json").write_text(json.dumps({
        "model": {"n_blocks": ranks.N_BLOCKS}, "mesh": {"data": 2},
        "train": {"batch_size": 2, "num_workers": 1}}))
    results = {}

    def run():
        try:
            results["ranks"] = meshlib.launch(
                ranks.mesh_cases, 4, inputs,
                timeout_s=ranks.LAUNCH_TIMEOUT_S,
                dist_timeout_s=ranks.COLLECTIVE_TIMEOUT_S)
        except BaseException as e:  # raised in the test thread below
            results["error"] = e

    t = threading.Thread(target=run)
    t.start()
    ref = _jax_references(variables, inputs)
    # launch bounds its own wait; this bounds the thread's, whatever held it
    t.join(ranks.LAUNCH_TIMEOUT_S + 60)
    assert not t.is_alive(), "the ranks' launch did not return"
    if "error" in results:
        raise results["error"]
    return inputs, results["ranks"], ref


def test_build_mesh_from_config_and_env(cases, monkeypatch):
    """build_mesh: the flat (data,) mesh over the group, the process-major
    (host, data) hybrid; without a group it joins none (one process) and
    refuses a config that asks for ranks."""
    _, out, _ = cases
    for r, o in enumerate(out):
        names, shape, idx = o["built"]["flat"]
        assert names == ("data",) and shape == {"data": 4} and idx == r
        names, shape, idx, host, data = o["built"]["hybrid"]
        assert names == ("host", "data")
        assert shape == {"host": 2, "data": 2}
        assert (idx, host, data) == (r, r // 2, r % 2)
        assert o["built"]["two"] == (("data",), {"data": 2}, r < 2)
    for k in ("CALIPSYNC_COORDINATOR", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert not meshlib.maybe_initialize_distributed()
    monkeypatch.setenv("CALIPSYNC_COORDINATOR", "localhost:1")
    monkeypatch.setenv("CALIPSYNC_NUM_PROCESSES", "1")
    assert not meshlib.maybe_initialize_distributed()
    monkeypatch.setenv("CALIPSYNC_NUM_PROCESSES", "2")
    monkeypatch.setenv("CALIPSYNC_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="process id"):
        meshlib.maybe_initialize_distributed()
    monkeypatch.delenv("CALIPSYNC_COORDINATOR")
    assert meshlib.build_mesh(MeshConfig()) is None
    with pytest.raises(RuntimeError, match="ranks"):
        meshlib.build_mesh(MeshConfig(data=2))


@pytest.mark.parametrize("fmt", ["bgr", "yuv420"])
def test_sharded_serving_rows(cases, fmt):
    """make_generate_resident_sharded_fn on 2 ranks: bgr against JAX's on
    2 devices, yuv420 against the one-rank step (JAX's packing is held in
    tests/test_torch_serving.py); both ranks return the whole batch."""
    _, out, ref = cases
    rows = out[2]["rows"]
    want = ref["rows"] if fmt == "bgr" else out[3]["one_rows"]
    assert rows[fmt].shape == want.shape
    assert ranks.digest(rows)[fmt] == out[3]["rows"][fmt]
    _within_bound(rows[fmt], want, fmt)


@pytest.mark.parametrize("fmt", ["bgr", "yuv420"])
def test_sharded_synthesizer_matches_one_rank(cases, fmt):
    """FrameSynthesizer(mesh=) on 2 ranks against the unsharded port: the
    same frames, in order, on both ranks."""
    inputs, out, _ = cases
    a, one = out[2]["frames"][fmt], out[3]["one_frames"][fmt]
    assert a.shape == one.shape == (len(inputs["features"]),) + a.shape[1:]
    assert ranks.digest(out[2]["frames"])[fmt] == out[3]["frames"][fmt]
    _within_bound(a, one, fmt)


def test_sharded_multistream_matches_one_rank(cases):
    """MultiStreamSynthesizer(mesh=) on 2 ranks, two ticks of two streams
    over two speakers (yuv420), against the unsharded port."""
    _, out, _ = cases
    for tick, tick1, one in zip(out[2]["ticks"], out[3]["ticks"],
                                out[3]["one_ticks"]):
        assert tick.keys() == one.keys() == {"a", "b"}
        assert ranks.digest(tick) == tick1
        for sid in tick:
            assert tick[sid].shape == one[sid].shape
            _within_bound(tick[sid], one[sid], "yuv420")


def test_sharded_eval_step_matches_one_rank(cases):
    """make_eval_step(mesh) on 2 ranks, a row each, against the one-rank
    eval forward at the repo's bar; both ranks return the whole batch."""
    _, out, _ = cases
    assert out[3]["eval_shape"] == (2, 160, 160, 3)
    assert out[2]["eval"] == out[3]["eval"]
    assert out[3]["eval_ratio"] <= 1, out[3]["eval_ratio"]


def test_mesh_serving_refusals(cases, synthetic_step3_dir):
    """A mesh needs preload, a batch (and head batch) that divide over it,
    and a store within preload_max_bytes; the multi-stream class checks
    the batch before it builds its store."""
    _, out, _ = cases
    assert out[2]["errors"] == out[3]["errors"]
    errors = out[2]["errors"]
    assert "mesh sharding requires the resident store" in errors["budget"]
    assert errors["head3"] == 0 and errors["head2"] == 2
    d = str(synthetic_step3_dir)
    three = SimpleNamespace(axis_size=lambda axis: 3)
    with pytest.raises(ValueError, match="divide over the mesh"):
        FrameSynthesizer(None, d, model=Generator(n_blocks=1), batch_size=4,
                         device="cpu", mesh=three)
    with pytest.raises(ValueError, match="preload"):
        FrameSynthesizer(None, d, model=Generator(n_blocks=1), batch_size=3,
                         device="cpu", mesh=three, preload=False)


BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _bn_buffers(state):
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def _params(state):
    return {k: v for k, v in state.items() if not k.endswith(BUFFERS)}


def _grads(out):
    return {k: torch.from_numpy(v) for k, v in out["grads"].items()}


def test_dp_step_with_sync_bn_matches_jax(cases):
    """The DP step on 2 ranks (1 row each, sync-BN) against JAX's
    make_train_step on 2 devices: the metrics and every BatchNorm's
    running statistics at the repo's bar; the parameters within Adam's
    first-step envelope (up to 2 lr where the fp32 gradients' signs
    differ, tests/test_torch_train.py); the gradients as close to the
    same step's in fp64 as JAX's are (kernels/measure.py grad_agreement:
    fp32 gradients of this random network carry percents of rounding
    noise, so no per-element tolerance holds)."""
    _, out, ref = cases
    dp = out[0]["dp"]
    assert dp["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        _close(dp["metrics"][k], v, msg=k)
    bn = _bn_buffers(dp["state"])
    assert len(bn) > 20
    for k, v in bn.items():
        _close(v, ref["state"][k], msg=k)
    for k, v in _params(dp["state"]).items():
        assert np.abs(v - ref["state"][k]).max() <= \
            2 * LR * (1 + RTOL) + ATOL, k
    exact = _grads(out[0]["dp64"])
    theirs = {k: torch.zeros_like(g) if k in FOLDED_BIASES
              else torch.from_numpy(np.array(ref["grads"][k]))
              for k, g in exact.items()}
    agree = grad_agreement(theirs, _grads(dp), exact)
    assert agree["ok"], (agree["bad"], agree["rms"], agree["rms_plain"])


def test_dp_step_equals_one_rank_on_the_global_batch(cases):
    """In fp64 (fp32 gradients of this random network carry percents of
    rounding noise), 2 ranks with sync-BN against one rank on the 2 rows:
    the metrics, every gradient and the BatchNorm statistics at the
    repo's bar, the weights within Adam's first-step envelope (a
    gradient that is zero but for rounding, e.g. a bias ahead of a
    train-mode BatchNorm, takes a step of lr either way); both ranks hold
    the same weights."""
    _, out, _ = cases
    dp, one = out[0]["dp64"], out[2]["one64"]
    assert out[0]["dp_state"] == out[1]["dp_state"]
    assert ranks.digest(out[0]["dp"]["state"]) == out[0]["dp_state"]
    for part in ("metrics", "grads"):
        assert dp[part].keys() == one[part].keys()
        for k, v in one[part].items():
            _close(dp[part][k], v, msg=k)
    bn = _bn_buffers(one["state"])
    assert len(bn) > 20
    for k, v in bn.items():
        _close(dp["state"][k], v, msg=k)
    for k, v in _params(one["state"]).items():
        assert np.abs(dp["state"][k] - v).max() <= \
            2 * LR * (1 + RTOL) + ATOL, k
    assert out[0]["dp"]["step"] == one["step"] == 1


def test_multi_step_equals_per_step_dp(cases):
    """make_resident_multi_step over a 2-rank gloo mesh on the CPU (K=2,
    one row a rank, sync-BN): the K steps run eagerly, as K per-step DP
    calls do, to the bit: the same losses, step count and weights on both
    ranks."""
    _, out, _ = cases
    for o in out[:2]:
        m = o["multi"]
        assert m["graphed"] is False
        assert m["multi"]["loss"] == m["per_step"]["loss"]
        assert len(m["multi"]["loss"]) == 2 and np.isfinite(
            m["multi"]["loss"]).all()
        assert m["multi"]["step"] == m["per_step"]["step"] == 2
        assert m["multi"]["state"] == m["per_step"]["state"]
    assert out[0]["multi"]["multi"] == out[1]["multi"]["multi"]


def test_zero1_equals_the_mean_path(cases):
    """ZeRO-1 on 2 ranks from the same weights and batch: the same
    parameters and (gathered to the replicated layout) the same Adam state
    as the mean path's; each rank keeps half the moment bytes (to the
    padding); the mean path's state loads into the blocks and gathers
    back unchanged (a one-rank checkpoint resumed with ZeRO-1)."""
    _, out, _ = cases
    z = out[0]["zero1"]
    assert z["step"] == out[1]["zero1"]["step"] == 1
    assert out[0]["zero1_state"] == out[1]["zero1_state"]
    assert max(z["state"].values()) <= 1, z["state"]
    assert z["opt"]["layout"] and z["opt"]["steps"] == [1.0]
    assert z["opt"]["moments"] <= 1, z["opt"]["moments"]
    # the reverse: the mean path's state loaded into 2 ranks' blocks
    # gathers back to itself
    assert z["reload"]["layout"] and z["reload"]["moments"] == 0
    for r in (0, 1):
        kept, full = out[r]["zero1"]["moment_bytes"], out[r][
            "dp_moment_bytes"]
        assert full / 2 <= kept <= full / 2 + 8


def test_hybrid_mesh_equals_flat_dp(cases):
    """A (host=2, data=2) mesh (process-major) against the flat 4-rank
    data mesh, one row a rank: the gradient mean and sync-BN over the
    (host, data) pair are the flat mesh's."""
    _, out, _ = cases
    for o in out:
        for part, ratios in o["hybrid"].items():
            assert ratios and max(ratios.values()) <= 1, (part, ratios)
        # every replica holds rank 0's weights
        assert o["flat_state"] == out[0]["flat_state"]
        assert o["hybrid_state"] == out[0]["hybrid_state"]


def test_checkpoint_from_two_ranks_resumes_on_one(cases):
    """The CLI's ``train --zero1`` with a config's ``mesh.data`` 2 on 2 of
    the 4 ranks writes (rank 0) a checkpoint in the replicated layout and
    ``generator.pth``, and one process without ZeRO-1 resumes it."""
    inputs, _, _ = cases
    path = pathlib.Path(inputs["save"]) / "step_1.pt"
    assert ckpt.latest_step(inputs["save"]) == 1
    assert (pathlib.Path(inputs["save"]) / "generator.pth").is_file()
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = Generator(n_blocks=ranks.N_BLOCKS)
    ref = torch.optim.Adam(model.parameters()).state_dict()
    assert saved["optimizer"]["param_groups"][0]["params"] == \
        ref["param_groups"][0]["params"]
    assert saved["step"] == 1  # 2 frames, global batch 2
    for i, p in enumerate(model.parameters()):
        st = saved["optimizer"]["state"][i]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
        assert float(st["step"]) == 1
    cfg = PipelineConfig(model=ModelConfig(n_blocks=ranks.N_BLOCKS),
                         train=TrainConfig(batch_size=2, epochs=2,
                                           num_workers=1))
    losses = []
    last = train_digital_model(inputs["step1"], inputs["save"], cfg=cfg,
                               resume=True, loss_history=losses,
                               device="cpu")
    assert pathlib.Path(last).name == "step_2.pt"
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert torch.load(last, map_location="cpu",
                      weights_only=True)["step"] == 2
    assert ckpt.latest_step(inputs["save"]) == 2


def test_rank_code_imports_no_jax():
    """What the spawned ranks import: torch and the port, never JAX."""
    path = pathlib.Path(ranks.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "optax", "calipsync_tpu"}
