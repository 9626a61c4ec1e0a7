"""The port's MultiStreamSynthesizer against the JAX class on the CPU:
two speakers, three streams over two consecutive ticks, batch 4, fp32,
one set of random generator weights carried across by key name; and
each stream against a single-stream FrameSynthesizer replay of its
physical walk."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.nn.unet import Generator as JaxGenerator
from calipsync_tpu.serve.multi_stream import \
    MultiStreamSynthesizer as JaxMultiStream
from calipsync_tpu_torch.bench_assets import make_synthetic_speaker
from calipsync_tpu_torch.core.weights import from_jax_generator
from calipsync_tpu_torch.infer.synthesizer import FrameSynthesizer
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.serve.multi_stream import MultiStreamSynthesizer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BATCH = 4
# (stream, speaker, rows) of each tick: 7 rows, two device batches a tick
STREAMS = (("a", 0, 3), ("b", 1, 2), ("c", 0, 2))
# The serving bound (tests/test_torch_serving.py): the two generators
# differ by float rounding, which flips a bgr truncation or a yuv420
# rounding only at ties, on at most 1e-3 of the values; an I420 decode
# scales a chroma LSB by up to 2.018.
BOUND = {"bgr": 1, "yuv420": 3}
SHARE = 1e-3
# Against the port's own single-stream path (the same model; the batch
# rows around a frame differ): bgr exact, yuv420 within 1 level.
SOLO_BOUND = {"bgr": 0, "yuv420": 1}


@pytest.fixture(scope="module")
def generator_variables():
    model = JaxGenerator()
    variables = jax.jit(model.init)(jax.random.key(0),
                                    jnp.zeros((1, 160, 160, 6)),
                                    jnp.zeros((1, 32, 32, 32)))
    # every leaf random, the zero-init gammas too, so the audio reaches
    # the output
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.25, 1.75, a.shape) if p[-1].key == "var"
                      else np.asarray(a) + rng.standard_normal(a.shape)
                      * 0.05).astype(np.float32), variables)


@pytest.fixture(scope="module")
def speakers(synthetic_step3_dir, tmp_path_factory):
    second = make_synthetic_speaker(str(tmp_path_factory.mktemp("spk2")),
                                    n_frames=9, res=320, seed=5)
    return [str(synthetic_step3_dir), second]


def _ticks():
    rng = np.random.default_rng(11)
    return [{sid: rng.standard_normal((n, 2, 1024)).astype(np.float32)
             for sid, _, n in STREAMS} for _ in range(2)]


def _serve(ms, ticks):
    for sid, spk, _ in STREAMS:
        ms.add_stream(sid, speaker=spk)
    return [ms.synthesize_windows(t) for t in ticks]


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), int((d > 0).sum()), d.size


class _Replay:
    """A sequencer that replays recorded physical indices."""

    def __init__(self, phys):
        self.phys = list(phys)

    def next(self, needed):
        out, self.phys = self.phys[:needed], self.phys[needed:]
        return out


@pytest.mark.parametrize("fmt", ["bgr", "yuv420"])
def test_multistream_matches_jax_and_single_stream(generator_variables,
                                                   speakers, fmt):
    ticks = _ticks()
    # the JAX class compiles and serves on a thread of its own while the
    # port serves here (XLA and torch release the GIL while they compute)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(lambda: _serve(JaxMultiStream(
            generator_variables, speakers, model=JaxGenerator(),
            batch_size=BATCH, transfer_format=fmt), ticks))
        ms = MultiStreamSynthesizer(from_jax_generator(generator_variables),
                                    speakers, batch_size=BATCH,
                                    transfer_format=fmt, device="cpu")
        ours = _serve(ms, ticks)

        # each stream against one FrameSynthesizer walking the same physical
        # frames, a call a tick: the same model, the same zero padding around
        # each window
        worst, changed, total = 0, 0, 0
        for sid, spk, _ in STREAMS:
            solo = FrameSynthesizer(None, speakers[spk], model=ms.model,
                                    batch_size=BATCH, transfer_format=fmt,
                                    preload=True, device="cpu")
            solo.sequencer = _Replay(x["physical_index"]
                                     for t in ours for x in t[sid])
            start = 0
            for tick, out in zip(ticks, ours):
                got = list(solo.iterate_synthesized_frames(tick[sid], start))
                start += len(got)
                assert [g["index"] for g in got] == \
                    [x["index"] for x in out[sid]]
                for g, x in zip(got, out[sid]):
                    m, c, n = _lsb(g["frame"], x["frame"])
                    worst, changed, total = max(worst, m), changed + c, total + n
            solo.close()
        ms.close()
        print(f"{fmt} vs single stream: max {worst} levels, {changed} values")
        assert worst <= SOLO_BOUND[fmt] and changed <= SHARE * total

        ref = pending.result()
        worst, changed, total = 0, 0, 0
        for r_tick, o_tick in zip(ref, ours):
            assert r_tick.keys() == o_tick.keys()
            for sid in r_tick:
                r, o = r_tick[sid], o_tick[sid]
                assert [x["index"] for x in o] == [x["index"] for x in r]
                assert [x["physical_index"] for x in o] == \
                    [x["physical_index"] for x in r]
                for x, y in zip(r, o):
                    assert y["frame"].shape == x["frame"].shape
                    m, c, n = _lsb(x["frame"], y["frame"])
                    worst, changed, total = max(worst, m), changed + c, total + n
        print(f"{fmt} vs JAX: max {worst} levels, {changed} of {total} values")
        assert worst <= BOUND[fmt] and changed <= SHARE * total
        for sid, _, n in STREAMS:  # the logical index runs on over the ticks
            assert [x["index"] for t in ours for x in t[sid]] == \
                list(range(2 * n))


def test_multistream_refuses_what_it_cannot_serve(synthetic_step3_dir,
                                                  monkeypatch):
    d = [str(synthetic_step3_dir)]
    with pytest.raises(ValueError, match="transfer_format"):
        MultiStreamSynthesizer(None, d, transfer_format="adaptive",
                               device="cpu")
    three = SimpleNamespace(axis_size=lambda axis: 3)  # 64 % 3 != 0
    with pytest.raises(ValueError, match="divide over the mesh"):
        MultiStreamSynthesizer(None, d, mesh=three, device="cpu")
    ms = MultiStreamSynthesizer(None, d, model=Generator(n_blocks=1),
                                device="cpu")
    with pytest.raises(ValueError, match="unknown speaker"):
        ms.add_stream("x", speaker=1)
    assert ms.synthesize_windows({}) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamSynthesizer(None, d)
