"""HuBERT feature extraction, one-pass and chunked long audio
(counterpart of calipsync_tpu/audio/hubert_pipeline.py; the reference's
utils/hubert_extractor.py HubertExtractor):

  - ``extract``: normalize -> one forward -> drop an odd last row ->
    (T/2, 2, hidden).
  - ``extract_features``: the chunked long-audio path with the
    reference's chunk boundaries (20 s clips of ``stride*1000`` samples,
    each extended by ``kernel - stride`` so the chunks' features line up
    with one pass), then a pad or trim to ``expected_T = (L - 80) // 320``.
  - ``extract_features_stream``: the same rows as a generator of blocks,
    one a chunk, for the pipelined offline manager.

Each row is padded up to a multiple of ``bucket_samples`` and run with
``num_valid_frames`` masking, which is exact for the 'layer' extractor
(nn/hubert.py); the padded shapes are those of the JAX package, so the
two compute the same rows.
"""

from __future__ import annotations

import pathlib
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

from calipsync_tpu_torch.audio.io import load_audio
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.hubert import (HubertConfig, HubertModel,
                                           normalize_wav)

KERNEL = 400
STRIDE = 320
CLIP_SAMPLES = STRIDE * 1000          # 20 s at 16 kHz
CHUNK_LEN = CLIP_SAMPLES - STRIDE + KERNEL  # 320080 -> exactly 1000 frames

_NO_MESH = ("mesh-sharded HuBERT (tensor or pipeline parallel) is not "
            "ported yet: ROADMAP.md A.3 (mesh serving and mesh HuBERT)")


class HubertFeatureExtractor:
    """A HubertModel on one device, driven from the host."""

    def __init__(self, state_dict: Optional[Mapping],
                 config: Optional[HubertConfig] = None,
                 model: Optional[HubertModel] = None,
                 dtype: Optional[torch.dtype] = None,
                 bucket_samples: int = 32_000,
                 kernel: int = KERNEL, stride: int = STRIDE,
                 clip_samples: int = CLIP_SAMPLES,
                 device: str | torch.device | None = None,
                 mesh=None, parallel: Optional[str] = None):
        """
        Args:
          state_dict: HF-keyed HuBERT weights (e.g. from
            ``core.weights.from_jax_hubert`` or an HF checkpoint), loaded
            strictly; None keeps ``model``'s own weights.
          config: the model's config (default: HuBERT-large).
          model: a HubertModel to use (default: one built from config).
          dtype: compute dtype (default fp32, as the JAX package's
            ``dtype=None``); the attention softmax stays fp32.
          bucket_samples: rows are zero-padded up to a multiple of this.
          kernel, stride, clip_samples: the chunk arithmetic (the
            reference's 400/320/320000 for HuBERT-large); tests override
            them to run the same chunking on tiny configs.
          device: 'cuda' (default; raises without a GPU) or 'cpu'.
          mesh, parallel: sharded extraction is not ported and raises.
        """
        if mesh is not None or parallel is not None:
            raise NotImplementedError(_NO_MESH)
        self.device = resolve_device(device)
        self.config = config or (model.config if model is not None
                                 else HubertConfig.large())
        model = model or HubertModel(self.config)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, dtype or torch.float32).eval()
        self.bucket = bucket_samples
        self.kernel = kernel
        self.stride = stride
        self.clip_samples = clip_samples
        self.chunk_len = clip_samples - stride + kernel

    @torch.inference_mode()
    def _forward_rows(self, rows: list) -> list:
        """Normalized (L_i,) wavs -> [(num_frames(L_i), hidden) fp32], one
        bucket-padded forward a row."""
        outs = []
        for row in rows:
            row = np.asarray(row, np.float32)
            n_valid = self.config.num_frames(int(row.shape[0]))
            if n_valid <= 0:
                outs.append(np.zeros((0, self.config.hidden_size),
                                     np.float32))
                continue
            padded_len = -(-int(row.shape[0]) // self.bucket) * self.bucket
            wav = torch.zeros((1, padded_len), dtype=torch.float32)
            wav[0, :row.shape[0]] = torch.from_numpy(row)
            out = self.model(wav.to(self.device),
                             num_valid_frames=torch.tensor(
                                 [n_valid], device=self.device))
            outs.append(out[0, :n_valid].float().cpu().numpy())
        return outs

    def _normalized(self, speech_16k: np.ndarray) -> np.ndarray:
        if speech_16k.ndim == 2:
            speech_16k = speech_16k[:, 0]
        return normalize_wav(speech_16k).numpy()

    def extract(self, speech_16k: np.ndarray) -> np.ndarray:
        """One-pass path (reference .extract): wav -> (T/2, 2, hidden)."""
        feats = self._forward_rows([self._normalized(speech_16k)])[0]
        t = feats.shape[0] - (feats.shape[0] % 2)
        return feats[:t].reshape(-1, 2, self.config.hidden_size)

    def _chunk_rows(self, normalized: np.ndarray) -> list:
        """The full 20 s chunks, then the remainder when it holds at
        least one kernel."""
        num_iter = normalized.shape[0] // self.clip_samples
        rows = [normalized[self.clip_samples * i:
                           self.clip_samples * i + self.chunk_len]
                for i in range(num_iter)]
        remaining = normalized[self.clip_samples * num_iter:]
        if remaining.shape[0] >= self.kernel:
            rows.append(remaining)
        return rows

    def _expected_t(self, total: int) -> int:
        return (total - (self.kernel - self.stride)) // self.stride

    def extract_features(self, speech_16k: np.ndarray) -> np.ndarray:
        """Chunked long-audio path (reference .extract_features)."""
        normalized = self._normalized(speech_16k)
        expected_t = self._expected_t(normalized.shape[0])
        pieces = self._forward_rows(self._chunk_rows(normalized))
        if not pieces:
            return np.zeros((0, 2, self.config.hidden_size), np.float32)
        feats = np.concatenate(pieces, axis=0)
        if feats.shape[0] < expected_t:
            feats = np.pad(feats,
                           ((0, expected_t - feats.shape[0]), (0, 0)))
        else:
            feats = feats[:expected_t]
        t = feats.shape[0] - (feats.shape[0] % 2)
        return feats[:t].reshape(-1, 2, self.config.hidden_size)

    def extract_features_stream(self, speech_16k: np.ndarray
                                ) -> Iterator[np.ndarray]:
        """The chunked path as a generator of (n_i, 2, hidden) blocks;
        ``np.concatenate(list(...))`` equals :meth:`extract_features` row
        for row. A block leaves as soon as its chunk's forward is done, so
        a consumer can synthesize frames while later audio is still being
        featurized."""
        normalized = self._normalized(speech_16k)
        expected_t = self._expected_t(normalized.shape[0])
        t_even = max(0, expected_t - expected_t % 2)
        hidden = self.config.hidden_size

        got_piece = False
        emitted = 0  # rows paired off so far (always even)
        buf = np.zeros((0, hidden), np.float32)
        for row in self._chunk_rows(normalized):
            piece = self._forward_rows([row])[0]
            got_piece = True
            buf = piece if buf.shape[0] == 0 else np.concatenate(
                [buf, piece], axis=0)
            take = min(buf.shape[0], t_even - emitted)
            n2 = take - take % 2
            if n2 > 0:
                yield np.ascontiguousarray(buf[:n2].reshape(-1, 2, hidden))
                emitted += n2
                buf = buf[n2:]
        if not got_piece:
            return  # the reference returns an empty array here
        if emitted < t_even:  # pad up to expected_T
            # buf may hold one leftover real row (an odd total below
            # expected_T): it pairs with the first pad row, as
            # extract_features' concatenate-then-pad keeps it
            need = t_even - emitted
            if buf.shape[0] < need:
                buf = np.concatenate(
                    [buf, np.zeros((need - buf.shape[0], hidden),
                                   np.float32)], axis=0)
            yield np.ascontiguousarray(buf[:need].reshape(-1, 2, hidden))

    def extract_from_file_stream(self, audio_path: str
                                 ) -> Iterator[np.ndarray]:
        return self.extract_features_stream(load_audio(audio_path, 16_000))

    def extract_auto(self, speech_16k: np.ndarray) -> np.ndarray:
        """One pass for clips up to one chunk, the chunked path beyond
        (one pass over minutes of audio would be one quadratic attention
        over thousands of frames)."""
        if len(speech_16k) <= self.chunk_len:
            return self.extract(speech_16k)
        return self.extract_features(speech_16k)

    def extract_from_file(self, audio_path: str) -> np.ndarray:
        return self.extract_features(load_audio(audio_path, 16_000))


def _load_hf_state_dict(hubert_path: str | pathlib.Path) -> dict:
    """HF checkpoint directory -> HubertModel state_dict (CPU tensors).

    ``model.safetensors`` is read through safetensors (imported here, so
    a host without the package can still read ``pytorch_model.bin``),
    ``pytorch_model.bin`` with ``torch.load(weights_only=True)``. The
    ``hubert.`` prefix of a HubertForCTC checkpoint is stripped and its
    CTC head dropped.
    """
    p = pathlib.Path(hubert_path)
    st_path, bin_path = p / "model.safetensors", p / "pytorch_model.bin"
    if st_path.exists():
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{st_path} needs the safetensors package, which is not "
                "installed; convert the checkpoint to pytorch_model.bin "
                "or install safetensors") from e
        sd = load_file(str(st_path))
    elif bin_path.exists():
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no model weights under {hubert_path}")
    if any(k.startswith("hubert.") for k in sd):
        sd = {k[len("hubert."):]: v for k, v in sd.items()
              if k.startswith("hubert.")}
    return sd


def load_hf_checkpoint(hubert_path: str, dtype: Optional[torch.dtype] = None,
                       device: str | torch.device | None = None,
                       mesh=None, parallel: Optional[str] = None
                       ) -> HubertFeatureExtractor:
    """An extractor from a local HF checkpoint directory (``config.json``
    and the weights), on ``device`` ('cuda' by default)."""
    if mesh is not None or parallel is not None:
        raise NotImplementedError(_NO_MESH)
    config = HubertConfig.from_hf(pathlib.Path(hubert_path) / "config.json")
    return HubertFeatureExtractor(_load_hf_state_dict(hubert_path), config,
                                  dtype=dtype, device=device)
