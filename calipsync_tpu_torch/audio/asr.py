"""CTC speech recognition for the training-audio slicer (counterpart of
calipsync_tpu/audio/asr.py).

The reference slices training audio with a funasr Paraformer stack
(utils/get_srt/slice_origin_audio.py:7-122). The JAX package replaces it
with a Wav2Vec2-CTC recognizer on its HuBERT trunk, and so does the port:
a Wav2Vec2 encoder has HuBERT's module layout, so the recognizer is the
port's ``nn/hubert.py`` model plus a linear vocabulary head.

  - :class:`Wav2Vec2CTC`: the trunk under ``wav2vec2.`` and ``lm_head``,
    the keys of HF's ``Wav2Vec2ForCTC``, so its state_dict loads as it is.
  - :class:`CTCRecognizer`: the bucket-padded forward (exact masking of
    the padding, as the feature extractor's) -> fp32 per-frame logits ->
    greedy CTC decode with word timestamps from the conv-stride frame rate
    (20 ms at 16 kHz for the standard config).
  - :func:`load_hf_ctc_checkpoint`: a local HF ``Wav2Vec2ForCTC``
    directory read without ``transformers``.
  - ``as_asr_fn()`` adapts the recognizer to the slicer's
    ``(audio, sr) -> [(start_s, end_s, text)]`` span contract.

On a bucket-padded input with the 'group' extractor the port takes the
GroupNorm's statistics over the real samples only (nn/hubert.py), as HF's
unpadded forward does; the JAX package takes them over the padding too.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel

Span = Tuple[float, float, str]
# Keys of an HF checkpoint the recognizer may do without: SpecAugment's
# training-time embedding, unused at inference.
OPTIONAL_KEYS = ("wav2vec2.masked_spec_embed",)


class Wav2Vec2CTC(nn.Module):
    """The HuBERT/Wav2Vec2 trunk and a linear head over the vocabulary,
    with HF ``Wav2Vec2ForCTC``'s keys: (B, samples) normalized wav ->
    (B, frames, vocab) fp32 logits. The head runs in fp32 whatever the
    trunk's dtype."""

    def __init__(self, config: HubertConfig, vocab_size: int):
        super().__init__()
        self.config = config
        self.wav2vec2 = HubertModel(config)
        self.lm_head = nn.Linear(config.hidden_size, vocab_size)

    def forward(self, input_values: torch.Tensor,
                num_valid_samples: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.wav2vec2(input_values, num_valid_samples)
        return F.linear(h.float(), self.lm_head.weight.float(),
                        self.lm_head.bias.float())


def greedy_ctc_spans(ids: np.ndarray, id_to_token: Dict[int, str],
                     frame_dt: float, blank_id: int = 0,
                     word_delimiter: str = "|",
                     max_word_gap_s: Optional[float] = 0.5) -> List[Span]:
    """Per-frame argmax ids -> word spans.

    Standard CTC collapse (drop repeats, drop blanks), char timestamps
    from frame indices; words split on the delimiter token; consecutive
    words closer than ``max_word_gap_s`` merge into one span (sentence-
    like units for the slicer's grouping). ``max_word_gap_s=None``
    returns the raw word spans unmerged (for punctuation-aware sentence
    segmentation downstream, ``slicer.sentences_from_spans``)."""
    events = []  # (frame, token)
    prev = blank_id
    for t, i in enumerate(ids):
        i = int(i)
        if i != prev and i != blank_id:
            events.append((t, id_to_token.get(i, "")))
        prev = i

    words: List[Span] = []
    chars: List[str] = []
    start_f = end_f = 0
    for f, tok in events + [(len(ids), word_delimiter)]:
        if tok == word_delimiter:
            if chars:
                words.append((start_f * frame_dt, (end_f + 1) * frame_dt,
                              "".join(chars)))
                chars = []
            continue
        if not chars:
            start_f = f
        end_f = f
        chars.append(tok)

    if max_word_gap_s is None:
        return words
    spans: List[Span] = []
    for s, e, w in words:
        if spans and s - spans[-1][1] <= max_word_gap_s:
            ps, pe, pt = spans[-1]
            spans[-1] = (ps, e, f"{pt} {w}")
        else:
            spans.append((s, e, w))
    return spans


class CTCRecognizer:
    """Wav2Vec2-CTC inference on the port's HuBERT trunk, on one device."""

    def __init__(self, state_dict: Mapping, config: HubertConfig,
                 vocab: Dict[str, int], dtype: Optional[torch.dtype] = None,
                 bucket_samples: int = 32_000, blank_id: int = 0,
                 word_delimiter: str = "|", do_normalize: bool = True,
                 device: str | torch.device | None = None):
        """
        Args:
          state_dict: ``Wav2Vec2ForCTC``-keyed weights (``wav2vec2.*`` and
            ``lm_head.*``), loaded strictly but for OPTIONAL_KEYS; the
            head has as many rows as ``lm_head.weight``.
          config: the trunk's config.
          vocab: token -> id (``vocab.json``).
          dtype: the trunk's compute dtype (default fp32); logits are fp32.
          bucket_samples: inputs are zero-padded up to a multiple of this.
          blank_id, word_delimiter, do_normalize: the tokenizer's pad id,
            its word delimiter, and the feature extractor's normalization.
          device: 'cuda' (default; raises without a GPU) or 'cpu'.
        """
        self.device = resolve_device(device)
        self.config = config
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.blank_id = blank_id
        self.word_delimiter = word_delimiter
        self.bucket = bucket_samples
        self.do_normalize = do_normalize
        # seconds per encoder frame = conv stride product / sample rate
        self.frame_dt = int(np.prod(config.conv_stride)) / 16_000.0
        model = Wav2Vec2CTC(config, state_dict["lm_head.weight"].shape[0])
        missing, unexpected = model.load_state_dict(state_dict, strict=False)
        missing = [k for k in missing if k not in OPTIONAL_KEYS]
        if missing or unexpected:
            raise KeyError(f"Wav2Vec2ForCTC state_dict: missing "
                           f"{missing[:8]}, unexpected {unexpected[:8]}")
        model.wav2vec2.to(dtype or torch.float32)
        self.model = model.to(self.device).eval()

    def _run(self, module: nn.Module, audio: np.ndarray) -> torch.Tensor:
        """``module`` (the model or its trunk) on one normalized,
        bucket-padded clip, with its valid samples masked in; the rows of
        the valid frames."""
        x = np.asarray(audio, np.float32)
        if self.do_normalize:
            x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        n_valid = self.config.num_frames(len(x))
        padded = max(self.bucket, -(-len(x) // self.bucket) * self.bucket)
        buf = torch.zeros((1, padded), dtype=torch.float32)
        buf[0, :len(x)] = torch.from_numpy(x)
        out = module(buf.to(self.device),
                     torch.tensor([len(x)], device=self.device))
        return out[0, :n_valid]

    @torch.inference_mode()
    def logits(self, audio: np.ndarray) -> np.ndarray:
        """(L,) 16 kHz float audio -> (frames, vocab) fp32 logits."""
        return self._run(self.model, audio).cpu().numpy()

    @torch.inference_mode()
    def hidden_states(self, audio: np.ndarray) -> np.ndarray:
        """(L,) 16 kHz float audio -> (frames, hidden) fp32: the trunk's
        last states, what the head reads."""
        return self._run(self.model.wav2vec2, audio).float().cpu().numpy()

    def recognize(self, audio: np.ndarray) -> List[Span]:
        """Punctuation-aware sentence spans (funasr ``sentence_info``
        analogue): raw CTC word spans re-segmented at punctuation / long
        gaps. For punctuation-free vocabs (e.g. wav2vec2-base-960h) this
        reduces to a 0.5 s word-gap merge."""
        from calipsync_tpu_torch.audio.slicer import sentences_from_spans

        ids = self.logits(audio).argmax(axis=-1)
        words = greedy_ctc_spans(ids, self.id_to_token, self.frame_dt,
                                 self.blank_id, self.word_delimiter,
                                 max_word_gap_s=None)
        return sentences_from_spans(words)

    def as_asr_fn(self):
        """Adapter for audio.slicer.process_and_split_audio(asr_fn=...)."""
        def asr_fn(audio: np.ndarray, sample_rate: int) -> List[Span]:
            if sample_rate != 16_000:
                from calipsync_tpu_torch.audio.io import resample

                audio = resample(np.asarray(audio, np.float32),
                                 sample_rate, 16_000)
            return self.recognize(audio)

        return asr_fn


def _token(value, default: str) -> str:
    """A special token as the tokenizer files store it: a string, or a
    dict with its ``content``."""
    if isinstance(value, dict):
        value = value.get("content")
    return value if isinstance(value, str) else default


def read_ctc_tokenizer(model_dir: str | pathlib.Path) -> dict:
    """The tokenizer and feature-extractor files of an HF ``Wav2Vec2ForCTC``
    directory, read as ``Wav2Vec2Processor`` reads them: ``vocab`` (token
    -> id: ``vocab.json`` plus ``added_tokens.json`` and the
    ``added_tokens_decoder`` of ``tokenizer_config.json``), ``pad_token``
    and ``word_delimiter_token`` (``tokenizer_config.json``, then
    ``special_tokens_map.json``; defaults ``<pad>`` and ``|``) and
    ``do_normalize`` (``preprocessor_config.json``, default True)."""
    p = pathlib.Path(model_dir)

    def read(name):
        f = p / name
        return json.loads(f.read_text()) if f.exists() else {}

    vocab = dict(read("vocab.json"))
    tok_cfg = read("tokenizer_config.json")
    special = read("special_tokens_map.json")
    vocab.update(read("added_tokens.json"))
    for i, entry in tok_cfg.get("added_tokens_decoder", {}).items():
        vocab.setdefault(_token(entry, ""), int(i))
    vocab.pop("", None)

    def special_token(name, default):
        for src in (tok_cfg, special):
            if name in src:
                return _token(src[name], default)
        return default

    return {"vocab": vocab, "pad_token": special_token("pad_token", "<pad>"),
            "word_delimiter_token": special_token("word_delimiter_token",
                                                  "|"),
            "do_normalize": bool(read("preprocessor_config.json").get(
                "do_normalize", True))}


def load_hf_ctc_checkpoint(model_dir: str,
                           device: str | torch.device | None = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> CTCRecognizer:
    """A local HF ``Wav2Vec2ForCTC`` checkpoint directory -> CTCRecognizer
    on ``device`` (the card unless 'cpu'), without ``transformers``: the
    trunk's config from ``config.json``, the weights (every key used,
    ``masked_spec_embed`` optional), and the tokenizer's vocabulary, blank
    (its pad token) and word delimiter, and the feature extractor's
    ``do_normalize``, from their json files. The weights are read as the
    HuBERT extractor reads its directory (``model.safetensors`` or
    ``pytorch_model.bin``), keys as stored."""
    from calipsync_tpu_torch.audio.hubert_pipeline import _load_hf_state_dict

    config = HubertConfig.from_hf(pathlib.Path(model_dir) / "config.json")
    tok = read_ctc_tokenizer(model_dir)
    vocab = tok["vocab"]
    return CTCRecognizer(
        _load_hf_state_dict(model_dir), config, vocab, dtype=dtype,
        blank_id=vocab[tok["pad_token"]],
        word_delimiter=tok["word_delimiter_token"],
        do_normalize=tok["do_normalize"], device=device)
