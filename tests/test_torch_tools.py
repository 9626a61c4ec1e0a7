"""The port's tools (calipsync_tpu_torch export.py, profiling.py,
metrics.py, verify_weights.py, vision/normalize.py,
vision/legacy_landmark.py, audio/slicer.py and the cost, slice and
verify-weights commands), and the kernels as ``torch.library`` ops, against
the JAX package on the CPU, fp32.

Inputs and weights come from numpy seeds (or a JAX init, carried across
with ``core/weights.py``); the generator is cut to one attention block
where a JAX twin runs. Tolerance: the repo's bar, rtol 1e-3 / atol 1e-5,
unless a test states another and why.
"""

import json
import pathlib
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from calipsync_tpu import cli as jax_cli
from calipsync_tpu import export as jexport
from calipsync_tpu import metrics as jmetrics
from calipsync_tpu import profiling as jprofiling
from calipsync_tpu import verify_weights as jverify
from calipsync_tpu.audio import slicer as jslicer
from calipsync_tpu.nn import pfld as jpfld
from calipsync_tpu.nn import unet as jax_unet
from calipsync_tpu.vision import legacy_landmark as jlegacy
from calipsync_tpu.vision import normalize as jnormalize
from calipsync_tpu.vision.lip_detector import LipDetector as JaxLipDetector
from calipsync_tpu_torch import cli, export, metrics, profiling
from calipsync_tpu_torch import verify_weights as pverify
from calipsync_tpu_torch.audio import slicer
from calipsync_tpu_torch.audio.io import save_wav
from calipsync_tpu_torch.bench_assets import (random_pfld_state,
                                               random_state_dict,
                                               write_eval_weights,
                                               write_face_weights)
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              from_jax_hubert,
                                              random_jax_generator,
                                              random_jax_hubert)
from calipsync_tpu_torch.kernels import (cross_attention, depthwise3x3,
                                         fused_inverted_residual)
from calipsync_tpu_torch.kernels.cross_attention import cross_attention_plain
from calipsync_tpu_torch.nn import blocks
from calipsync_tpu_torch.nn.hubert import HubertConfig
from calipsync_tpu_torch.nn.pfld import fold_mobileone
from calipsync_tpu_torch.nn.syncnet import SyncNet
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.vision import legacy_landmark, normalize
from calipsync_tpu_torch.vision.lip_detector import LipDetector

RTOL, ATOL = 1e-3, 1e-5
# One B=1 forward of the full-width generator (hubert, 4 blocks): the
# products and convolutions FlopCounterMode sees on the plain route, plus
# the depthwise taps its nine shifted multiply-adds hide.
GENERATOR_FLOPS_B1 = 7_901_724_672


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


class _OpCalls(TorchDispatchMode):
    """Counts the ``calipsync::`` op calls of the block, by op name."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("calipsync."):
            op = name.split(".")[1]
            self.counts[op] = self.counts.get(op, 0) + 1
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------ the ops

def _op_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    return {"fused_ir": (t(2, 6, 5, 8), t(8, 16), t(16), t(9, 16), t(16),
                         t(16, 8), t(8), True),
            "depthwise3x3": (t(2, 7, 6, 12), t(9, 12), t(12) + 1, t(12), 2),
            "cross_attention": (t(2, 10, 4), t(2, 10, 4), t(2, 10, 6))}


@pytest.mark.parametrize("name", ["fused_ir", "depthwise3x3",
                                  "cross_attention"])
def test_ops_pass_torch_library_checks(name):
    """Schema, fake implementation (shape and dtype of the CPU output),
    and for the attention its registered autograd, by
    ``torch.library.opcheck``."""
    args = _op_inputs()[name]
    if name == "cross_attention":
        args = tuple(a.requires_grad_() for a in args)
    torch.library.opcheck(getattr(torch.ops.calipsync, name).default, args)


def test_fake_ops_give_shapes_and_count_no_launch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from calipsync_tpu_torch.kernels import launch_counts

    before = launch_counts()
    with FakeTensorMode() as mode:
        ins = {k: tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in v)
               for k, v in _op_inputs().items()}
        shapes = {k: tuple(getattr(torch.ops.calipsync, k)(*v).shape)
                  for k, v in ins.items()}
    assert shapes == {"fused_ir": (2, 6, 5, 8),
                      "depthwise3x3": (2, 4, 3, 12),
                      "cross_attention": (2, 10, 6)}
    assert launch_counts() == before


def test_attention_gradient_through_the_op_is_the_plain_backward():
    """The registered autograd of calipsync::cross_attention (its backward
    cross_attention_backward_plain) against autograd through the plain
    version, and the output carries a grad_fn."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(
        np.float32)) for s in ((2, 100, 16), (2, 100, 16), (2, 100, 24)))
    g = torch.from_numpy(rng.standard_normal((2, 100, 24)).astype(
        np.float32))
    grads = []
    for fn in (cross_attention, cross_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out, leaves, g))
    for name, a, b in zip("qkv", *grads):
        _close(a, b, rtol=1e-4, atol=1e-6, msg=f"d{name}")


@pytest.mark.parametrize("name", ["fused_ir", "depthwise3x3"])
def test_eval_only_ops_raise_on_backward(name):
    """The fused IR and the depthwise op run eval-mode blocks only: a
    backward through either raises instead of leaving x without a
    gradient."""
    x, *rest = _op_inputs()[name]
    out = getattr(torch.ops.calipsync, name)(x.requires_grad_(), *rest)
    assert out.grad_fn is not None
    with pytest.raises(RuntimeError, match="has no gradient"):
        out.sum().backward()


# ------------------------------------------------------------ export

def test_check_export_parity_matches_jax(tmp_path):
    """The JAX test_stablehlo_export_parity function and inputs: the
    round-tripped program equals eager, and both equal JAX."""
    w = np.random.default_rng(0).random((8, 4), np.float32)
    x = np.random.default_rng(1).random((3, 8), np.float32)

    def fn(w, x):
        return torch.tanh(x @ w) * 2.0

    export.check_export_parity(fn, (torch.from_numpy(w), torch.from_numpy(x)),
                               tmp_path / "fn.pt2")
    jexport.check_export_parity(lambda w, x: jnp.tanh(x @ w) * 2.0, (w, x),
                                tmp_path / "fn.stablehlo")
    _close(fn(torch.from_numpy(w), torch.from_numpy(x)),
           jnp.tanh(x @ w) * 2.0)


@pytest.fixture(scope="module")
def jax_generator_one_block():
    model = jax_unet.Generator(n_channels=6, mode="hubert", n_blocks=1)
    variables = random_jax_generator(n_blocks=1, seed=5)
    rng = np.random.default_rng(6)
    x = rng.random((2, 160, 160, 6), dtype=np.float32)
    a = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x, a: model.apply(
        v, x, a, train=False))(variables, x, a))
    return variables, x, a, ref


def test_exported_generator_matches_jax_and_swaps_weights(
        jax_generator_one_block, tmp_path):
    """A one-block generator exported after an eager forward (its BN folds
    cached), saved and loaded: its outputs against JAX's Generator.apply on
    the same variables; its graph holds one calipsync:: node per op call
    of the eager forward; a second seed's state_dict loaded into it gives
    that seed's eager output."""
    variables, x, a, ref = jax_generator_one_block
    model = Generator(mode="hubert", n_blocks=1).eval()
    model.load_state_dict(from_jax_generator(variables, n_blocks=1),
                          strict=True)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    with torch.no_grad(), _OpCalls() as calls:
        eager = model(xt, at)
    _close(eager, ref)
    path = export.export_generator(model, tmp_path / "g.pt2", batch=2)
    loaded = export.load_program(path)
    assert export.kernel_nodes(loaded) == calls.counts == {
        "fused_ir": 9, "depthwise3x3": 17, "cross_attention": 1}
    with torch.no_grad():
        _close(loaded(xt, at), ref)

    other = from_jax_generator(random_jax_generator(n_blocks=1, seed=7),
                               n_blocks=1)
    loaded.load_state_dict(other, strict=True)
    model.load_state_dict(other, strict=True)
    with torch.no_grad():
        want = model(xt, at)
        got = loaded(xt, at)
    assert (want - eager).abs().max() > 1e-2
    _close(got, want)


# ------------------------------------------------------------ cost

def test_compiled_cost_of_a_product_matches_xla():
    a = np.random.default_rng(0).random((64, 48), np.float32)
    b = np.random.default_rng(1).random((48, 32), np.float32)
    ours = profiling.compiled_cost(torch.matmul, torch.from_numpy(a),
                                   torch.from_numpy(b))
    theirs = jprofiling.compiled_cost(lambda x, y: x @ y, a, b)
    assert ours["flops"] == theirs["flops"] == 2 * 64 * 48 * 32
    assert ours["bytes_accessed"] is None


def test_generator_cost_counts_the_kernels_and_their_taps():
    """The ops route's count at B=1 is the plain route's FlopCounterMode
    count plus the depthwise taps the plain loops hide (from the op shapes
    recorded in the same forward), 7,901,724,672; it is linear in the
    batch and within the JAX package's own bracket (4-12 GFLOP)."""
    recorded = []

    def recording(name, fn):
        def run(*args, **kw):
            recorded.append((name, args[0].shape, args[1].shape,
                             kw.get("stride", 1)))
            return fn(*args, **kw)
        return run

    plain = Generator(mode="hubert", n_blocks=4, ops="plain").eval()
    ops = SimpleNamespace(
        fused_ir=recording("fused_ir", blocks.PLAIN_OPS.fused_ir),
        depthwise=recording("depthwise", blocks.PLAIN_OPS.depthwise),
        attention=blocks.PLAIN_OPS.attention)
    for m in plain.modules():
        if hasattr(m, "ops"):
            m.ops = ops
    x = torch.zeros((1, 160, 160, 6))
    a = torch.zeros((1, 32, 32, 32))
    plain_flops = profiling.compiled_cost(plain, x, a)["flops"]
    taps = 0
    for name, (b, h, w, _), second, stride in recorded:
        if name == "fused_ir":   # w1 (Cin, Ch): 9 taps a hidden channel
            taps += 2 * 9 * b * h * w * second[1]
        else:                    # taps (9, C), the output's pixels
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            taps += 2 * 9 * b * ho * wo * second[1]
    assert len(recorded) == 9 + 17
    one = profiling.generator_cost(batch=1, device="cpu")
    assert one["flops"] == plain_flops + taps == GENERATOR_FLOPS_B1
    assert 4.0 < one["gflops"] < 12.0
    assert profiling.generator_cost(batch=2, device="cpu")["flops"] == \
        2 * GENERATOR_FLOPS_B1
    for op in ("calipsync.fused_ir", "calipsync.depthwise3x3",
               "calipsync.cross_attention"):
        assert one["raw"][op] > 0


# ------------------------------------------------- metrics and profiling

def test_metrics_counters_gauges_timings(tmp_path):
    """tests/test_metrics.py's first test, on the port's copy."""
    m = metrics.Metrics()
    m.count("frames")
    m.count("frames", 4)
    m.gauge("buffer", 7)
    with m.time("step"):
        pass
    m.observe("step", 0.01)
    snap = m.snapshot()
    assert snap["counters"]["frames"] == 5
    assert snap["gauges"]["buffer"] == 7
    assert snap["timings"]["step"]["count"] == 2
    assert snap["timings"]["step"]["max_ms"] >= snap["timings"]["step"][
        "min_ms"]
    path = tmp_path / "m.jsonl"
    m.dump_jsonl(str(path))
    m.dump_jsonl(str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["counters"]["frames"] == 5
    m.reset()
    assert m.snapshot()["counters"] == {}


def test_metrics_thread_safety_and_global_logger():
    import threading

    m = metrics.Metrics()

    def work():
        for _ in range(1000):
            m.count("x")
            m.observe("t", 0.001)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = m.snapshot()
    assert snap["counters"]["x"] == 4000
    assert snap["timings"]["t"]["count"] == 4000
    assert metrics.global_metrics() is metrics.global_metrics()
    log = metrics.get_logger("calipsync.test_torch")
    log.info("hello")
    assert metrics.get_logger("calipsync.test_torch") is log


def test_metrics_snapshot_matches_jax():
    ours, theirs = metrics.Metrics(), jmetrics.Metrics()
    for m in (ours, theirs):
        m.count("serve.frames", 3)
        m.count("serve.frames")
        m.gauge("serve.player_buffer", 11)
        for s in (0.02, 0.005, 0.0125):
            m.observe("serve.synthesis_window", s)
    a, b = ours.snapshot(), theirs.snapshot()
    a.pop("ts"), b.pop("ts")
    assert a == b


def test_stage_timer_trace_and_device_sync(tmp_path):
    t = profiling.StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert t.summary()["a"]["count"] == 2
    assert "a:" in t.report()
    theirs = jprofiling.StageTimer()
    assert set(t.summary()["a"]) == {"total_s", "count", "mean_ms"}
    with theirs.stage("a"):
        pass
    assert set(theirs.summary()["a"]) == set(t.summary()["a"])

    with profiling.trace(str(tmp_path / "tr")) as prof:
        out = torch.ones(4, 4) @ torch.ones(4, 4)
        profiling.device_sync({"out": [out]})
    assert pathlib.Path(prof.trace_path).parent == tmp_path / "tr"
    events = json.loads(pathlib.Path(prof.trace_path).read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


# ------------------------------------------------------------ normalizer

def test_normalizer_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((720, 1920, 3), (2000, 500, 3), (1280, 720, 3),
                  (90, 161, 3)):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            normalize.process_frame(frame, 72, 128),
            jnormalize.process_frame(frame, 72, 128))
    video = str(tmp_path / "v.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (96, 64))
    for _ in range(5):
        vw.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    vw.release()
    n = normalize.extract_frames(video, str(tmp_path / "ours"), 36, 64)
    assert n == jnormalize.extract_frames(video, str(tmp_path / "jax"), 36,
                                          64) == 5
    for i in range(n):
        assert (tmp_path / "ours" / f"{i}.npy").read_bytes() == \
            (tmp_path / "jax" / f"{i}.npy").read_bytes()


# ------------------------------------------------------ legacy landmark

class _KeypointStub:
    """detect_with_keypoints of one face with the two eye keypoints
    given."""

    def __init__(self, bbox, left_eye, right_eye):
        self.out = (np.array([bbox], np.float32), [0],
                    np.array([[left_eye, right_eye, (0, 0), (0, 0),
                               (0, 0)]], np.float32))

    def detect_with_keypoints(self, img):
        return self.out


@pytest.fixture(scope="module")
def legacy_pair():
    """(JAX LipDetector, port LipDetector) over one seeded PFLD
    (bench_assets.random_pfld_state, near the mean face on any crop),
    carried into JAX by its importer and folded by each package; the
    mean face zero, as in tests/test_inventory_components.py."""
    sd = random_pfld_state(seed=4)
    folded = jpfld.fold_mobileone_params(jpfld.import_pfld(
        {k: v.numpy() for k, v in sd.items()}))
    face = np.zeros(220, np.float32)
    ours = LipDetector(fold_mobileone(sd), face, None, device="cpu")
    yield JaxLipDetector(folded, face, face_detector=None), ours
    ours.close()


@pytest.mark.parametrize("shape,bbox,eyes", [
    ((100, 100, 3), (20, 20, 50, 50), ((30, 35), (60, 35))),     # level
    ((640, 480, 3), (100, 150, 240, 260), ((160, 240), (250, 330))),  # 45
    ((300, 300, 3), (-10, 200, 120, 140), ((20, 250), (80, 236))),  # edge
])
def test_legacy_landmark_matches_jax(legacy_pair, shape, bbox, eyes):
    jlip, plip = legacy_pair
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    det = _KeypointStub(bbox, *eyes)
    ours = legacy_landmark.LegacyLandmark(plip, det).landmarks(img)
    theirs = jlegacy.LegacyLandmark(jlip, det).landmarks(img)
    assert len(ours) == len(theirs) == 1
    (p_ours, a_ours), (p_theirs, a_theirs) = ours[0], theirs[0]
    assert a_ours == a_theirs
    assert p_ours.dtype == np.int32 and p_ours.shape == (110, 2)
    assert np.abs(p_ours - p_theirs).max() <= 1


# ------------------------------------------------------------ slicer

def _bursts_wav(seed: int, seconds: float = 14.0) -> np.ndarray:
    sr = 16_000
    rng = np.random.default_rng(seed)
    audio = np.zeros(int(sr * seconds), np.float32)
    for start in (1.0, 5.0, 9.0):
        s = int(start * sr)
        audio[s:s + sr * 3] = rng.standard_normal(sr * 3) * 0.3
    return audio


def test_slicer_matches_jax(tmp_path):
    audio = _bursts_wav(0)
    assert slicer.energy_vad(audio, 16_000) == jslicer.energy_vad(audio,
                                                                  16_000)
    words = [(0.1, 0.4, "hello"), (0.5, 0.9, "world."), (1.6, 2.0, "next"),
             (2.1, 2.5, "one?"), (2.6, 3.3, "tail")]
    assert slicer.sentences_from_spans(words) == \
        jslicer.sentences_from_spans(words)
    spans = [(float(i), i + 0.7, f"s{i}") for i in range(0, 40, 2)]
    assert slicer.group_spans(spans, 5, 12, np.random.default_rng(3)) == \
        jslicer.group_spans(spans, 5, 12, np.random.default_rng(3))

    path = str(tmp_path / "long.wav")
    save_wav(path, audio, 16_000)

    def asr_fn(a, sr):
        return [(0.5, 4.1, "one"), (4.9, 8.2, "two"), (8.8, 12.5, "three")]

    for fn in (None, asr_fn):
        tag = "vad" if fn is None else "asr"
        ours = slicer.process_and_split_audio(
            path, str(tmp_path / f"ours_{tag}"), 4, 6, asr_fn=fn, seed=1)
        theirs = jslicer.process_and_split_audio(
            path, str(tmp_path / f"jax_{tag}"), 4, 6, asr_fn=fn, seed=1)
        assert ours == theirs and len(ours) >= 2
        for i in range(len(ours)):
            for ext in ("wav", "txt"):
                assert (tmp_path / f"ours_{tag}" / f"{i}.{ext}").read_bytes() \
                    == (tmp_path / f"jax_{tag}" / f"{i}.{ext}").read_bytes()


# ------------------------------------------------------------ verify-weights

TINY_HUBERT = dict(hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2),
                   conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Seeded files in the reference layouts, written once: the face
    weights (with YOLO), the evaluation weights, a full generator .pth, a
    tiny HuBERT-large-style HF dir, and a SyncNet .pth with one key
    removed and one with one key added."""
    root = tmp_path_factory.mktemp("weights")
    face = write_face_weights(str(root / "face"), seed=0, yolo=True)
    ev = write_eval_weights(str(root / "eval"), seed=0)
    gen = str(root / "generator.pth")
    torch.save(from_jax_generator(random_jax_generator(seed=1)), gen)
    hub = root / "hubert"
    hub.mkdir()
    cfg = HubertConfig(**TINY_HUBERT)
    torch.save(from_jax_hubert(random_jax_hubert(cfg, 2), cfg),
               hub / "pytorch_model.bin")
    (hub / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in vars(cfg).items()}))
    sd = random_state_dict(SyncNet(), 3)
    removed = dict(sd)
    removed.pop("face_encoder.0.conv_block.0.weight")
    added = dict(sd, **{"face_encoder.99.extra.weight": torch.zeros(2)})
    paths = {"removed": str(root / "removed.pth"),
             "added": str(root / "added.pth")}
    torch.save(removed, paths["removed"])
    torch.save(added, paths["added"])
    return dict(face=face, gen=gen, hubert=str(hub), **ev, **paths)


def _verify_kwargs(f):
    return [dict(weights_dir=f["face"]), dict(generator=f["gen"]),
            dict(syncnet=f["syncnet"]), dict(hubert=f["hubert"]),
            dict(lpips_trunk=f["vgg_trunk"], lpips_heads=f["vgg_heads"]),
            dict(syncnet=f["removed"]), dict(syncnet=f["added"])]


def test_verify_weights_matches_jax(weight_files):
    """Per artifact the same status and unconsumed keys as the JAX
    report; every seeded file checks out, the file with a key removed is
    an error and the one with a key added names that key."""
    statuses = []
    for kw in _verify_kwargs(weight_files):
        ours = pverify.verify_weights(device="cpu", **kw)
        theirs = jverify.verify_weights(**kw)
        assert [r["artifact"] for r in ours] == \
            [r["artifact"] for r in theirs]
        for a, b in zip(ours, theirs):
            assert a["status"] == b["status"], (a, b)
            assert a.get("keys_unconsumed") == b.get("keys_unconsumed")
            statuses.append(a["status"])
    assert statuses == ["ok"] * 8 + ["error", "unconsumed-keys"]


def test_cli_verify_weights_exit_codes_match_jax(weight_files, capsys):
    for kw, code in ((dict(syncnet=weight_files["syncnet"]), 0),
                     (dict(syncnet=weight_files["removed"]), 1),
                     (dict(syncnet=weight_files["added"]), 1)):
        argv = ["verify-weights", "--syncnet", kw["syncnet"]]
        for main, extra in ((cli.main, ["--device", "cpu"]),
                            (jax_cli.main, [])):
            with pytest.raises(SystemExit) as e:
                main(argv + extra)
            assert e.value.code == code
        capsys.readouterr()


# ------------------------------------------------------------ the CLI

def test_cli_has_every_jax_subcommand_but_export_torch():
    def commands(main):
        import argparse

        seen = {}

        class Stop(Exception):
            pass

        def parse(self, argv=None, namespace=None):
            sub = next(a for a in self._actions
                       if isinstance(a, argparse._SubParsersAction))
            seen["cmds"] = set(sub.choices)
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            with pytest.raises(Stop):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen["cmds"]

    assert commands(cli.main) == commands(jax_cli.main) - {"export-torch"}


def test_cli_cost_and_slice(tmp_path, capsys):
    cli.main(["cost", "--batch", "1", "--device", "cpu"])
    gflops = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert round(gflops * 1e9) == GENERATOR_FLOPS_B1

    path = str(tmp_path / "in.wav")
    save_wav(path, _bursts_wav(1), 16_000)
    cli.main(["slice", "--audio", path, "--out", str(tmp_path / "ours"),
              "--min-seconds", "4", "--max-seconds", "6"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(["slice", "--audio", path, "--out", str(tmp_path / "jax"),
                  "--min-seconds", "4", "--max-seconds", "6"])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours == theirs and ours["segments"] >= 2
    for i in range(ours["segments"]):
        assert (tmp_path / "ours" / f"{i}.wav").read_bytes() == \
            (tmp_path / "jax" / f"{i}.wav").read_bytes()


def test_cpu_ops_route_through_the_wrappers():
    """The wrappers call their ops: on CPU tensors each op's CPU
    implementation (the plain version), once a call."""
    args = _op_inputs(1)
    with _OpCalls() as calls:
        fused_inverted_residual(*args["fused_ir"][:-1], residual=True)
        depthwise3x3(*args["depthwise3x3"][:-1], stride=2)
        cross_attention(*args["cross_attention"])
    assert calls.counts == {"fused_ir": 1, "depthwise3x3": 1,
                            "cross_attention": 1}
