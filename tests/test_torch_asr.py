"""The port's CTC recognizer (calipsync_tpu_torch/audio/asr.py, the
``wav2vec2-ctc`` check of verify_weights.py, bench_assets.write_ctc_dir
and planted_ctc, and ``slice --asr``) against HF ``Wav2Vec2ForCTC`` and
the JAX package's recognizer on the CPU, fp32.

Tiny Wav2Vec2ForCTC models (the shapes of tests/test_asr.py), 'layer' and
'group' extractors, are written with ``save_pretrained`` and read back by
the port without ``transformers`` (the test imports it; the port does
not). Logits: rtol 1e-3 / atol 1e-4, the bar of tests/test_asr.py. The
port masks the 'group' extractor's GroupNorm statistics over the real
samples (ROADMAP.md C, "Fixed in the port"), the JAX package over the
padding too, so a bucket-padded 'group' input is held against HF only.
"""

import json
import os

import numpy as np
import pytest
import torch

from calipsync_tpu.audio import asr as jasr
from calipsync_tpu.audio import slicer as jslicer
from calipsync_tpu.nn.hubert import HubertConfig as JaxHubertConfig
from calipsync_tpu_torch import cli, verify_weights
from calipsync_tpu_torch.audio import asr, slicer
from calipsync_tpu_torch.audio.io import save_wav
from calipsync_tpu_torch.bench_assets import (planted_ctc, speech_like_wav,
                                               write_ctc_dir)
from calipsync_tpu_torch.core.weights import from_jax_wav2vec2_ctc
from calipsync_tpu_torch.nn.hubert import HubertConfig

VOCAB = {"<pad>": 0, "|": 1, "a": 2, "b": 3, "c": 4, "d": 5, "e": 6,
         "f": 7}
TINY = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
EXTRACTORS = {"layer": dict(conv_bias=True, feat_extract_norm="layer",
                            do_stable_layer_norm=True),
              "group": dict(conv_bias=False, feat_extract_norm="group",
                            do_stable_layer_norm=False)}
BUCKET = 2000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(EXTRACTORS))
def hf_dir(request, tmp_path_factory):
    """(extractor, HF model, its save_pretrained directory with the
    tokenizer and feature-extractor files)."""
    from transformers import (Wav2Vec2Config, Wav2Vec2CTCTokenizer,
                              Wav2Vec2FeatureExtractor, Wav2Vec2ForCTC)

    path = tmp_path_factory.mktemp(f"ctc_{request.param}")
    cfg = Wav2Vec2Config(vocab_size=len(VOCAB), layerdrop=0.0,
                         pad_token_id=0, **TINY,
                         **EXTRACTORS[request.param])
    torch.manual_seed(0)
    hf = Wav2Vec2ForCTC(cfg).eval()
    with torch.no_grad():   # a head that separates the tokens
        hf.lm_head.weight.mul_(20.0)
    hf.save_pretrained(path, safe_serialization=False)
    (path / "vocab.json").write_text(json.dumps(VOCAB))
    Wav2Vec2CTCTokenizer(str(path / "vocab.json"), pad_token="<pad>",
                         word_delimiter_token="|").save_pretrained(path)
    Wav2Vec2FeatureExtractor(do_normalize=True).save_pretrained(path)
    return request.param, hf, str(path)


def _hf_logits(hf, audio):
    norm = (audio - audio.mean()) / np.sqrt(audio.var() + 1e-7)
    with torch.no_grad():
        return hf(torch.from_numpy(norm[None])).logits.numpy()[0]


def _audio(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_loader_reads_the_hf_directory(hf_dir):
    """Vocabulary, blank, delimiter and normalization from the tokenizer
    and feature-extractor files as transformers reads them; every key of
    the weights is loaded (the verify-weights check reports none left)."""
    from transformers import Wav2Vec2Processor

    _, _, path = hf_dir
    rec = asr.load_hf_ctc_checkpoint(path, device="cpu")
    proc = Wav2Vec2Processor.from_pretrained(path)
    tok = proc.tokenizer
    assert rec.id_to_token == {i: t for t, i in tok.get_vocab().items()}
    assert rec.blank_id == tok.pad_token_id
    assert rec.word_delimiter == tok.word_delimiter_token
    assert rec.do_normalize == proc.feature_extractor.do_normalize
    report, = verify_weights.verify_weights(asr=path, device="cpu")
    assert report["status"] == "ok" and report["keys_unconsumed"] == []
    assert report["keys_consumed"] == report["keys_total"]


@pytest.mark.parametrize("n", [1790, 2 * BUCKET])
def test_logits_match_hf(hf_dir, n):
    """Padded (1790 samples in a bucket of 2000) and unpadded, both
    extractors, against HF's unpadded forward."""
    _, hf, path = hf_dir
    rec = asr.load_hf_ctc_checkpoint(path, device="cpu")
    rec.bucket = BUCKET
    audio = _audio(n)
    want = _hf_logits(hf, audio)
    got = rec.logits(audio)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def _jax_recognizer(sd, config, blank_id=0, vocab=VOCAB, bucket=BUCKET):
    jcfg = JaxHubertConfig(**{k: getattr(config, k)
                              for k in JaxHubertConfig.__dataclass_fields__})
    variables, head = jasr.import_wav2vec2_ctc(sd, jcfg)
    return jasr.CTCRecognizer(variables, head, jcfg, vocab,
                              bucket_samples=bucket, blank_id=blank_id)


def test_logits_match_jax(hf_dir):
    """Against the JAX recognizer on the same weights, where the two
    compute the same function: both extractors unpadded, the 'layer' one
    padded too (bucket padding moves JAX's 'group' GroupNorm statistics;
    that case is held against HF in test_logits_match_hf)."""
    extractor, hf, path = hf_dir
    rec = asr.load_hf_ctc_checkpoint(path, device="cpu")
    rec.bucket = BUCKET
    theirs = _jax_recognizer(_np_sd(hf), rec.config)
    lengths = [2 * BUCKET] + ([1790] if extractor == "layer" else [])
    for n in lengths:
        audio = _audio(n, 1)
        np.testing.assert_allclose(rec.logits(audio), theirs.logits(audio),
                                   rtol=1e-3, atol=1e-4, err_msg=str(n))


def test_from_jax_wav2vec2_ctc_inverts_the_jax_importer(hf_dir):
    _, hf, _ = hf_dir
    sd = _np_sd(hf)
    config = HubertConfig.from_hf(hf.config.to_dict())
    jcfg = JaxHubertConfig(**{k: getattr(config, k)
                              for k in JaxHubertConfig.__dataclass_fields__})
    back = from_jax_wav2vec2_ctc(*jasr.import_wav2vec2_ctc(sd, jcfg), config)
    model = asr.Wav2Vec2CTC(config, len(VOCAB))
    model.load_state_dict(back, strict=True)
    audio = torch.from_numpy(_audio(2 * BUCKET, 2)[None])
    with torch.no_grad():
        want = hf(audio).logits
        got = model(audio)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_greedy_ctc_spans_match_jax():
    id_to_token = {i: t for t, i in VOCAB.items()}
    rng = np.random.default_rng(3)
    ids = rng.choice(len(VOCAB), 400, p=[0.4, 0.1] + [0.5 / 6] * 6)
    for gap in (None, 0.0, 0.1, 0.5):
        assert asr.greedy_ctc_spans(ids, id_to_token, 0.02, 0, "|", gap) \
            == jasr.greedy_ctc_spans(ids, id_to_token, 0.02, 0, "|", gap)


@pytest.fixture(scope="module")
def planted_dir(tmp_path_factory):
    """write_ctc_dir at a tiny 'layer' width (the public vocabulary and
    tokenizer files), its head planted on a 12 s speech-like clip; the
    clip's path; the planting's margins."""
    root = tmp_path_factory.mktemp("planted")
    config = HubertConfig(conv_bias=True, feat_extract_norm="layer",
                          do_stable_layer_norm=True,
                          **dict(TINY, conv_dim=(16,) * 7,
                                 conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                                 conv_stride=(5, 2, 2, 2, 2, 2, 2)))
    path = write_ctc_dir(str(root / "ctc"), seed=0, config=config)
    wav = speech_like_wav(12.0, seed=5)
    info = planted_ctc(path, wav)
    wav_path = str(root / "clip.wav")
    save_wav(wav_path, wav, 16_000)
    return path, wav, wav_path, info


def test_write_ctc_dir_loads_in_transformers(planted_dir):
    """HF reads the seeded directory (config, weights, tokenizer and
    feature-extractor files) into the same recognizer."""
    from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

    path, wav, _, _ = planted_dir
    hf = Wav2Vec2ForCTC.from_pretrained(path).eval()
    tok = Wav2Vec2Processor.from_pretrained(path).tokenizer
    rec = asr.load_hf_ctc_checkpoint(path, device="cpu")
    assert tok.pad_token_id == rec.blank_id == 0
    np.testing.assert_allclose(rec.logits(wav[:64_000]),
                               _hf_logits(hf, wav[:64_000]), rtol=1e-3,
                               atol=1e-4)


def test_planted_spans_and_the_slicer_match_jax(planted_dir, tmp_path):
    """The planted head decodes words and gaps with margins far above the
    JAX-vs-port logit difference; spans, as_asr_fn through
    process_and_split_audio, and ``slice --asr`` equal JAX's."""
    from transformers import Wav2Vec2ForCTC

    path, wav, wav_path, info = planted_dir
    rec = asr.load_hf_ctc_checkpoint(path, device="cpu")
    ours = rec.logits(wav)
    top2 = np.sort(ours, axis=-1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]).min()
    assert margin == pytest.approx(info["min_margin"], rel=1e-3)
    theirs_rec = _jax_recognizer(
        _np_sd(Wav2Vec2ForCTC.from_pretrained(path)), rec.config,
        vocab=json.load(open(os.path.join(path, "vocab.json"))),
        bucket=rec.bucket)
    diff = np.abs(ours - theirs_rec.logits(wav)).max()
    assert margin > 10 * diff
    spans = rec.recognize(wav)
    assert len(spans) >= 3 and all(text for _, _, text in spans)
    assert spans == theirs_rec.recognize(wav)

    segs = slicer.process_and_split_audio(wav_path, str(tmp_path / "ours"),
                                          3, 5, asr_fn=rec.as_asr_fn())
    jsegs = jslicer.process_and_split_audio(
        wav_path, str(tmp_path / "jax"), 3, 5,
        asr_fn=theirs_rec.as_asr_fn())
    assert segs == jsegs and len(segs) >= 2

    cli.main(["slice", "--audio", wav_path, "--out", str(tmp_path / "cli"),
              "--asr", path, "--min-seconds", "3", "--max-seconds", "5",
              "--device", "cpu"])
    for i in range(len(segs)):
        for ext in ("wav", "txt"):
            a = (tmp_path / "cli" / f"{i}.{ext}").read_bytes()
            assert a == (tmp_path / "jax" / f"{i}.{ext}").read_bytes()
    assert not (tmp_path / "cli" / f"{len(segs)}.wav").exists()
