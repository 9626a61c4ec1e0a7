"""The port's HuBERT (calipsync_tpu_torch/nn/hubert.py) and its feature
extractor (audio/hubert_pipeline.py) against the JAX package, fp32 on the
CPU, on the JAX tests' tiny configs (tests/test_hubert.py) with every
weight random (``random_jax_hubert``), so no layout mistake hides behind
zero biases or unit norm scales. Tolerance: rtol 1e-4 / atol 1e-5, the
JAX package's own bar against HF."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.audio.hubert_pipeline import \
    HubertFeatureExtractor as JaxExtractor
from calipsync_tpu.nn import hubert as jax_hubert
from calipsync_tpu_torch.audio import hubert_pipeline
from calipsync_tpu_torch.audio.hubert_pipeline import HubertFeatureExtractor
from calipsync_tpu_torch.core.weights import (from_jax_hubert,
                                              random_jax_hubert)
from calipsync_tpu_torch.nn import hubert
from calipsync_tpu_torch.nn.hubert import (HubertConfig, HubertModel,
                                           normalize_wav)

RTOL, ATOL = 1e-4, 1e-5
TSV = (pathlib.Path(__file__).parent / "fixtures"
       / "hubert_large_ls960_ft_state_dict_keys.tsv")
VARIANTS = [("layer", True), ("group", False)]


def _tiny(feat_norm="layer", stable=True):
    kw = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=48, conv_dim=(16, 16, 16),
              conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), conv_bias=True,
              feat_extract_norm=feat_norm, do_stable_layer_norm=stable,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    return jax_hubert.HubertConfig(**kw), HubertConfig(**kw)


def _pair(feat_norm="layer", stable=True, seed=0):
    """(JAX config, port config, JAX variables, port model) on one set of
    random weights."""
    jcfg, cfg = _tiny(feat_norm, stable)
    variables = random_jax_hubert(cfg, seed=seed)
    model = HubertModel(cfg).eval()
    model.load_state_dict(from_jax_hubert(variables, cfg), strict=True)
    return jcfg, cfg, variables, model


@pytest.mark.parametrize("feat_norm,stable", VARIANTS)
def test_random_jax_hubert_has_the_jax_layout(feat_norm, stable):
    jcfg, cfg = _tiny(feat_norm, stable)
    init = jax.jit(jax_hubert.HubertModel(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 400)))
    ref = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), init)
    ours = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype),
                                  random_jax_hubert(cfg, seed=0))
    assert ours == ref


@pytest.mark.parametrize("feat_norm,stable", VARIANTS)
def test_hubert_matches_jax(feat_norm, stable):
    jcfg, _, variables, model = _pair(feat_norm, stable)
    wav = np.random.default_rng(1).standard_normal((2, 4000)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_hubert.HubertModel(jcfg).apply)(
        variables, jnp.asarray(wav)))
    with torch.inference_mode():
        out = model(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (2, 199, 24)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_padded_masked_forward_is_exact():
    """Bucket padding with num_valid_frames: the valid rows equal an
    unpadded forward's (and the JAX masked forward's) up to the rounding
    of products of another length (~1e-6 here; a pad frame that leaked in
    would move them by O(1)); a row with no valid frame (every key at
    -1e30) stays finite."""
    jcfg, cfg, variables, model = _pair()
    wav = np.random.default_rng(2).standard_normal((3210,)).astype(
        np.float32)
    n = cfg.num_frames(len(wav))
    padded = np.zeros((2, 4096), np.float32)
    padded[0, :len(wav)] = wav
    padded[1] = np.random.default_rng(3).standard_normal(4096)
    n_valid = np.array([n, 0], np.int32)
    with torch.inference_mode():
        exact = model(torch.from_numpy(wav[None]))[0].numpy()
        masked = model(torch.from_numpy(padded),
                       num_valid_frames=torch.from_numpy(n_valid)).numpy()
    np.testing.assert_allclose(masked[0, :n], exact, rtol=RTOL, atol=ATOL)
    assert np.isfinite(masked[1]).all()
    ref = np.asarray(jax.jit(jax_hubert.HubertModel(jcfg).apply)(
        variables, jnp.asarray(padded), num_valid_frames=jnp.asarray(
            n_valid)))
    np.testing.assert_allclose(masked[0, :n], ref[0, :n], rtol=RTOL,
                               atol=ATOL)


def test_normalize_wav_matches_jax():
    wav = (np.random.default_rng(4).standard_normal((2, 5000)) * 3
           + 0.5).astype(np.float32)
    out = normalize_wav(wav).numpy()
    ref = np.asarray(jax_hubert.normalize_wav(wav))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(out.mean(-1)).max() < 1e-5
    assert np.abs(out.std(-1) - 1).max() < 1e-3


# (batch, channels in, length, out, kernel, stride, padding, groups): the
# extractor's first layer, a strided layer, the last k=2 layers, and the
# padded grouped positional conv
@pytest.mark.parametrize("b,c,n,o,k,stride,pad,groups", [
    (2, 1, 400, 16, 10, 5, 0, 1), (2, 16, 79, 16, 3, 2, 0, 1),
    (1, 16, 33, 16, 2, 2, 0, 1), (2, 24, 50, 24, 16, 1, 8, 4)])
def test_conv1d_products_match_conv1d(b, c, n, o, k, stride, pad, groups):
    """The products conv equals F.conv1d (float64, so only the summation
    order may differ)."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(b, c, n, generator=g, dtype=torch.float64)
    w = torch.randn(o, c // groups, k, generator=g, dtype=torch.float64)
    bias = torch.randn(o, generator=g, dtype=torch.float64)
    out = hubert.conv1d(x, w, bias, stride, pad, groups)
    ref = torch.nn.functional.conv1d(x, w, bias, stride=stride,
                                     padding=pad, groups=groups)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_samples", [3730,   # 3 chunks + live remainder
                                       3025,   # remainder < kernel: dropped
                                       900,    # remainder-only clip
                                       20])    # too short: empty output
def test_extractor_matches_jax(n_samples):
    """One pass, chunked and streamed, on the JAX tests' tiny chunk
    arithmetic (kernel 30, stride 20, clip 1000: 50 frames a chunk)."""
    jcfg, cfg, variables, model = _pair()
    chunking = dict(bucket_samples=500, kernel=30, stride=20,
                    clip_samples=1000)
    ref = JaxExtractor(jax.tree_util.tree_map(jnp.asarray, variables), jcfg,
                       **chunking)
    ours = HubertFeatureExtractor(None, model=model, device="cpu",
                                  **chunking)
    wav = np.random.default_rng(6).standard_normal((n_samples,)).astype(
        np.float32)

    batch = ours.extract_features(wav)
    np.testing.assert_allclose(batch, ref.extract_features(wav),
                               rtol=RTOL, atol=ATOL)
    blocks = list(ours.extract_features_stream(wav))
    if batch.shape[0] == 0:
        assert sum(len(b) for b in blocks) == 0
    else:
        assert len(blocks) == len(list(ref.extract_features_stream(wav)))
        np.testing.assert_array_equal(np.concatenate(blocks), batch)
    if n_samples >= 400:
        one = ours.extract(wav)
        assert one.shape[1:] == (2, cfg.hidden_size)
        np.testing.assert_allclose(one, ref.extract(wav), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(
            ours.extract_auto(wav),
            one if n_samples <= ours.chunk_len else batch)


def test_hf_key_layout_matches_the_manifest():
    """The port's HuBERT-large keys, with HubertForCTC's ``hubert.``
    prefix, are the manifest's HubertModel part, shapes included."""
    with torch.device("meta"):
        model = HubertModel(HubertConfig.large())
    ours = {f"hubert.{k}": tuple(v.shape)
            for k, v in model.state_dict().items()}
    manifest = {}
    for line in TSV.read_text().splitlines():
        if line.startswith("#"):
            continue
        key, shape = line.split("\t")
        if key.startswith("hubert."):
            manifest[key] = tuple(int(s) for s in shape.split(","))
    assert len(manifest) == 422
    assert ours == manifest
    assert sum(int(np.prod(s)) for s in ours.values()) == 315_438_720


@pytest.mark.parametrize("spelling", ["weight_g", "parametrizations"])
def test_weight_norm_pair_folds_like_the_jax_importer(tmp_path, spelling):
    """An HF-keyed state dict with a random weight-norm pair, loaded
    through ``load_hf_checkpoint`` from a HubertForCTC-style .bin (the
    ``hubert.`` prefix and a CTC head), folds to the kernel the JAX
    importer computes, and the whole model matches the JAX model built by
    ``import_hubert`` from the same dict."""
    jcfg, cfg = _tiny()
    src = HubertModel(cfg)
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
              np.float32) * 0.2) for k, v in src.state_dict().items()}
    pc = "encoder.pos_conv_embed.conv."
    sd[pc + "weight_g"] = sd[pc + "weight_g"].abs() + 0.5
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    jax_vars = jax_hubert.import_hubert(numpy_sd, jcfg)

    if spelling == "parametrizations":
        sd[pc + "parametrizations.weight.original0"] = sd.pop(pc + "weight_g")
        sd[pc + "parametrizations.weight.original1"] = sd.pop(pc + "weight_v")
    ckpt = {f"hubert.{k}": v for k, v in sd.items()}
    ckpt["lm_head.weight"] = torch.zeros(32, cfg.hidden_size)
    torch.save(ckpt, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(
        '{"hidden_size": 24, "num_hidden_layers": 2, '
        '"num_attention_heads": 4, "intermediate_size": 48, '
        '"conv_dim": [16, 16, 16], "conv_kernel": [10, 3, 2], '
        '"conv_stride": [5, 2, 2], "conv_bias": true, '
        '"feat_extract_norm": "layer", "do_stable_layer_norm": true, '
        '"num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4, '
        '"layer_norm_eps": 1e-05, "model_type": "hubert"}')
    ex = hubert_pipeline.load_hf_checkpoint(str(tmp_path), device="cpu")
    assert ex.config == cfg

    folded = ex.model.encoder.pos_conv_embed.conv.weight().detach().numpy()
    kernel = np.asarray(
        jax_vars["params"]["encoder"]["pos_conv_embed"]["conv"]["kernel"])
    np.testing.assert_allclose(folded.transpose(2, 1, 0), kernel,
                               rtol=1e-5, atol=1e-7)
    wav = rng.standard_normal((1, 2000)).astype(np.float32)
    with torch.inference_mode():
        out = ex.model(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jax.jit(jax_hubert.HubertModel(jcfg).apply)(
        jax_vars, jnp.asarray(wav)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_default_device_without_cuda_raises(monkeypatch):
    _, cfg = _tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            HubertFeatureExtractor(None, cfg, device=device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HubertFeatureExtractor(None, cfg, device="cpu", parallel="tp")
