"""The port's serving path (calipsync_tpu_torch) against the JAX package:
audio windows, output packing and the whole FrameSynthesizer on the
synthetic step3 clip. fp32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.audio import windows as jax_windows
from calipsync_tpu.infer import synthesizer as jax_synth
from calipsync_tpu.nn.unet import Generator as JaxGenerator
from calipsync_tpu_torch.audio import windows as torch_windows
from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.core.weights import from_jax_generator
from calipsync_tpu_torch.infer import synthesizer as torch_synth
from calipsync_tpu_torch.nn.unet import Generator


@pytest.mark.parametrize("mode,row_shape", [("hubert", (2, 1024)),
                                            ("wenet", (8192,))])
def test_batched_windows_matches_jax(mode, row_shape):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((20,) + row_shape).astype(np.float32)
    # clip edges on both sides, interior rows, a repeated index
    idx = np.array([0, 1, 7, 8, 12, 19, 19], np.int32)
    ref = jax_windows.batched_windows(jnp.asarray(feats), jnp.asarray(idx),
                                      mode=mode)
    out = torch_windows.batched_windows(torch.from_numpy(feats),
                                        torch.from_numpy(idx), mode=mode)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the host helpers agree with the batched gather
    if mode == "hubert":
        for i, k in enumerate(idx):
            np.testing.assert_array_equal(
                torch_windows.window_nhwc_np(feats, int(k)), out[i].numpy())


@pytest.mark.parametrize("fmt", ["bgr", "yuv420"])
def test_pack_pred_matches_jax(fmt):
    pred = np.random.default_rng(1).random((3, 16, 16, 3), dtype=np.float32)
    ref = np.asarray(jax_synth._pack_pred(jnp.asarray(pred), fmt))
    out = torch_synth._pack_pred(torch.from_numpy(pred), fmt).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape
    # yuv420's 2x2 chroma mean may sum in another order: a tie can round
    # one LSB apart; bgr truncates the same float product and is exact
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= (1 if fmt == "yuv420" else 0)
    assert (diff > 0).mean() <= 1e-3


@pytest.fixture(scope="module")
def jax_generator():
    model = JaxGenerator()
    variables = jax.jit(model.init)(jax.random.key(0),
                                    jnp.zeros((1, 160, 160, 6)),
                                    jnp.zeros((1, 32, 32, 32)))
    # randomize the zero-init gammas too, so the attention reaches the output
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.25, 1.75, a.shape) if p[-1].key == "var"
                      else np.asarray(a) + rng.standard_normal(a.shape)
                      * 0.05).astype(np.float32), variables)
    return model, variables


@pytest.mark.parametrize("fmt", ["bgr", "yuv420"])
def test_frame_synthesizer_matches_jax(synthetic_step3_dir, jax_generator,
                                       fmt):
    jmodel, variables = jax_generator
    feats = np.random.default_rng(3).standard_normal(
        (10, 2, 1024)).astype(np.float32)
    ref = jax_synth.FrameSynthesizer(variables, str(synthetic_step3_dir),
                                     model=jmodel, batch_size=4, seed=0,
                                     transfer_format=fmt)
    port = torch_synth.FrameSynthesizer(
        from_jax_generator(variables), str(synthetic_step3_dir),
        batch_size=4, seed=0, transfer_format=fmt, device="cpu")
    a = list(ref.iterate_synthesized_frames(feats))
    b = list(port.iterate_synthesized_frames(feats))
    port.close()
    assert len(a) == len(b) == 10
    assert [x["physical_index"] for x in a] == \
        [x["physical_index"] for x in b]
    assert [x["index"] for x in b] == list(range(10))
    # The generators differ by float rounding (~1e-6), which flips a uint8
    # truncation (bgr) or rounding (yuv420) only at ties: +-1 LSB in the
    # packed rows. bgr frames carry it as is; the I420 decode scales a
    # chroma LSB by up to 2.018 (BT.601 U->B), so yuv420 frames may differ
    # by 3. Either way on at most 0.1% of the values.
    bound = 1 if fmt == "bgr" else 3
    changed = 0
    for x, y in zip(a, b):
        assert y["frame"].shape == x["frame"].shape == (480, 480, 3)
        d = np.abs(x["frame"].astype(np.int16) - y["frame"].astype(np.int16))
        assert d.max() <= bound
        changed += int((d > 0).sum())
    print(f"{fmt}: {changed} of {10 * 480 * 480 * 3} values differ")
    assert changed <= 1e-3 * 10 * 480 * 480 * 3


def test_unknown_transfer_format_raises(synthetic_step3_dir):
    with pytest.raises(ValueError, match="transfer_format"):
        torch_synth.FrameSynthesizer(None, str(synthetic_step3_dir),
                                     transfer_format="rgb",
                                     device="cpu")
    with pytest.raises(ValueError, match="transfer_format"):
        torch_synth._pack_pred(torch.zeros(1, 2, 2, 3), "rgb")


def test_default_device_without_gpu_raises(synthetic_step3_dir,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_synth.FrameSynthesizer(None, str(synthetic_step3_dir))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_synth.FrameSynthesizer(None, str(synthetic_step3_dir),
                                     device="cuda")
    model = Generator()
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_synth.make_generate_fn(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_synth.make_generate_resident_fn(model, CropConfig())


def test_first_batch_size_is_output_identical(synthetic_step3_dir):
    """The small head batch re-slices the same walk: same frames."""
    model = Generator().eval()
    feats = np.random.default_rng(4).standard_normal(
        (9, 2, 1024)).astype(np.float32)
    frames = []
    for head in (0, 2):
        s = torch_synth.FrameSynthesizer(None, str(synthetic_step3_dir),
                                         model=model, batch_size=4, seed=5,
                                         first_batch_size=head, device="cpu")
        frames.append([it["frame"] for it in
                       s.iterate_synthesized_frames(feats)])
        s.close()
    for x, y in zip(*frames):
        np.testing.assert_array_equal(x, y)
