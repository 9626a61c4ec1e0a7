"""Port generator (calipsync_tpu_torch) against the JAX generator.

Weights cross through ``from_jax_generator``; every leaf is randomized
(BN stats and the zero-init attention gammas included) so neither a layout
mistake nor a dead branch can hide behind init constants. fp32 on the CPU,
where the port's kernel wrappers take their plain versions. Tolerance: the
repo's bar, rtol 1e-3 / atol 1e-5 (CLAUDE.md "Conventions").
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.core.weights_export import export_generator
from calipsync_tpu.nn import unet as jax_unet
from calipsync_tpu_torch.core import weights
from calipsync_tpu_torch.core.weights import (from_jax_generator,
                                              random_jax_generator)
from calipsync_tpu_torch.nn import unet as torch_unet


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-3, 1e-5


def _randomize(variables, seed):
    """The recipe of tests/test_weights_export.py: var U(0.25, 1.75),
    mean N(0, 0.2), every other leaf N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def rand(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf, np.float32)
        if name == "var":
            return rng.uniform(0.25, 1.75, a.shape).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(rand, variables)


def _to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hubert_pair():
    model = jax_unet.Generator(n_channels=6, mode="hubert")
    variables = jax.jit(model.init)(jax.random.key(0),
                                    jnp.zeros((1, 160, 160, 6)),
                                    jnp.zeros((1, 32, 32, 32)))
    return model, _to_numpy_tree(_randomize(variables, seed=3))


@pytest.fixture(scope="module")
def jax_apply(hubert_pair):
    """The eval-mode JAX forward, jitted once for the module's recipes."""
    jmodel, _ = hubert_pair
    return jax.jit(lambda v, x, a: jmodel.apply(v, x, a, train=False))


def test_from_jax_generator_matches_export_and_loads_strict(hubert_pair):
    _, variables = hubert_pair
    sd = from_jax_generator(variables, mode="hubert", n_blocks=4)
    ref = export_generator(variables, mode="hubert", n_blocks=4)
    assert len(sd) == 582
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v),
                                      err_msg=k)
    model = torch_unet.Generator(mode="hubert", n_blocks=4)
    model.load_state_dict(sd, strict=True)


def test_random_jax_generator_has_the_jax_layout(hubert_pair):
    _, variables = hubert_pair
    shapes = partial(jax.tree_util.tree_map, np.shape)
    assert shapes(random_jax_generator(seed=0)) == shapes(variables)


@pytest.mark.parametrize("recipe", ["export_test", "scaled"])
def test_generator_matches_jax_fp32(hubert_pair, jax_apply, recipe):
    """``export_test``: the weights of tests/test_weights_export.py, under
    which each block shrinks the signal, so the output mostly sees the last
    decoder stage. ``scaled``: ``random_jax_generator``'s weights, under
    which the audio and the attention reach the output."""
    _, variables = hubert_pair
    if recipe == "scaled":
        variables = random_jax_generator(seed=4)
    rng = np.random.default_rng(11)
    x = rng.random((2, 160, 160, 6), dtype=np.float32)
    a = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)

    # JAX runs on a thread of its own while the port runs here (XLA and
    # torch release the GIL while they compute)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(jax_apply, variables, jnp.asarray(x),
                              jnp.asarray(a))
        model = torch_unet.Generator(mode="hubert").eval()
        model.load_state_dict(from_jax_generator(variables), strict=True)
        with torch.inference_mode():
            out = model(torch.from_numpy(x), torch.from_numpy(a)).numpy()
            silent = model(torch.from_numpy(x),
                           torch.zeros(a.shape)).numpy()
        ref = np.asarray(pending.result())

    assert out.shape == (2, 160, 160, 3) and out.dtype == np.float32
    # a sigmoid stuck at 0 or 1 would match trivially
    assert 0.01 < out.min() and out.max() < 0.99 and out.std() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    if recipe == "scaled":
        assert np.abs(out - silent).max() > 1e-2, "the audio does not " \
            "reach the output"


def test_audio_conv_wenet_matches_jax_fp32():
    jmodel = jax_unet.AudioConvWenet()
    x = np.random.default_rng(5).standard_normal(
        (2, 16, 32, 256)).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros_like(x))
    variables = _to_numpy_tree(_randomize(variables, seed=6))
    ref = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables, x))

    # the wenet encoder's keys: audio_model.* of a wenet generator
    sd = {}
    weights._audio(sd, "", variables["params"], variables["batch_stats"],
                   mode="wenet")
    model = torch_unet.AudioConvWenet().eval()
    model.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        out = model(xt).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 10, 10, 512)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
