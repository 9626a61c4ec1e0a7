"""Multi-stream serving: many concurrent avatars through one generator on
one card (counterpart of calipsync_tpu/serve/multi_stream.py).

  - Every speaker's mouth-crop store is concatenated into ONE uint8 tensor
    on the card; a stream's physical frame index is offset by its
    speaker's base, so one device step serves every stream.
  - Each scheduling tick packs the pending feature windows of all streams
    into shared device batches (the streams' frames interleave freely), so
    the card runs at its batch size although each stream needs only
    25 frames a second.
  - Every stream keeps its own ping-pong sequencer; paste-back uses its
    speaker's frame cache. Each window is padded with 8 zero rows on both
    sides in the shared feature buffer, which reproduces the per-call zero
    padding of a single-stream call.

With ``mesh=`` every device batch also splits over the mesh's data axis
(``make_generate_resident_sharded_fn``): every rank builds the same
synthesizer, makes the same calls and returns every stream's frames.

All device batches of a tick are launched first (asynchronous on the CUDA
stream, each with its copy into pinned memory behind an event), then each
is gathered and composited in turn, so the host composites batch k while
batches k+1.. compute and copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.core import mesh as meshlib
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.infer.synthesizer import (
    FrameSynthesizer, PingPongSequencer, _check_format, _Pending,
    make_generate_resident_fn, make_generate_resident_sharded_fn,
    yuv420_unpack)
from calipsync_tpu_torch.nn.unet import Generator

_PAD = 8  # +-8-row window context

@dataclass
class _Stream:
    stream_id: str
    speaker: int
    sequencer: PingPongSequencer
    logical_index: int = -1


class MultiStreamSynthesizer:
    def __init__(self, state_dict: Optional[dict],
                 speaker_dirs: Sequence[str],
                 model: Optional[Generator] = None, batch_size: int = 64,
                 crop: CropConfig = CropConfig(), seed: int = 0,
                 mesh=None, axis_name: str = "data",
                 feature_bucket: int = 512,
                 transfer_format: str = "bgr",
                 device: str | torch.device | None = None):
        """
        Args:
          state_dict: generator weights with the reference key names,
            loaded strictly into ``model``; None keeps ``model``'s own.
          speaker_dirs: one step-3 ``infer_data`` directory a speaker.
          batch_size: device batch; a tick's tail batch is padded to it.
          seed: seeds the streams' sequencers (``add_stream``).
          mesh: a ``core.mesh.Mesh``; each device batch splits over its
            ``axis_name`` ranks, so ``batch_size`` must divide over it.
          feature_bucket: a tick's feature buffer is padded up to a
            multiple of this many rows, so few shapes reach the card.
          transfer_format: 'bgr' or 'yuv420'.
          device: 'cuda' (default; raises without a GPU) or 'cpu'.
        """
        if mesh is not None and batch_size % mesh.axis_size(axis_name):
            # before the store is built: a batch that does not divide
            # would fail only at the first tick
            raise ValueError("batch_size must divide over the mesh")
        _check_format(transfer_format)
        self.device = resolve_device(device)
        model = model or Generator()
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval()
        self.crop = crop
        self.batch_size = batch_size
        self.feature_bucket = feature_bucket
        self.transfer_format = transfer_format
        self._rng = np.random.default_rng(seed)

        # per-speaker frame caches from plain FrameSynthesizers (no
        # preload; one combined store is built here instead)
        self._speakers: List[FrameSynthesizer] = [
            FrameSynthesizer(None, d, model=self.model,
                             batch_size=batch_size, crop=crop,
                             preload=False, device=self.device)
            for d in speaker_dirs]
        offsets, stores, base = [], [], 0
        for s in self._speakers:
            entries = s._entries_for(range(s.total_frames))
            stores.append(np.stack([e["ref"].reshape(-1) for e in entries]))
            offsets.append(base)
            base += s.total_frames
        self._offsets = offsets
        self._crops_dev = torch.from_numpy(
            np.concatenate(stores, axis=0)).to(self.device)
        if mesh is not None:
            meshlib.replicate(self.model, mesh, axis_name)
            self._generate = make_generate_resident_sharded_fn(
                self.model, crop, mesh, axis_name, transfer_format,
                self.device)
        else:
            self._generate = make_generate_resident_fn(
                self.model, crop, transfer_format, self.device)
        self._streams: Dict[str, _Stream] = {}

    # ------------- stream registry -------------

    def add_stream(self, stream_id: str, speaker: int = 0,
                   seed: Optional[int] = None) -> None:
        if speaker >= len(self._speakers):
            raise ValueError(f"unknown speaker {speaker}")
        rng = np.random.default_rng(
            self._rng.integers(2**63) if seed is None else seed)
        self._streams[stream_id] = _Stream(
            stream_id, speaker,
            PingPongSequencer(self._speakers[speaker].total_frames, rng))

    def remove_stream(self, stream_id: str) -> None:
        self._streams.pop(stream_id, None)

    # ------------- scheduling tick -------------

    def synthesize_windows(self, requests: Dict[str, np.ndarray]
                           ) -> Dict[str, List[dict]]:
        """One tick: {stream_id: features (K, 2, 1024)} ->
        {stream_id: [{'frame', 'index', 'physical_index'}, ...]}.

        All requested frames are packed into shared batches of
        ``batch_size`` (the tail padded) through the one device step;
        compositing uses each stream's speaker caches.
        """
        jobs = []  # (stream, speaker, global phys idx, feature idx, entry)
        feat_blocks = []
        feat_base = 0
        for stream_id, features in requests.items():
            st = self._streams[stream_id]
            spk = self._speakers[st.speaker]
            k = len(features)
            seq = st.sequencer.next(k)
            # window-edge isolation: 8 zero rows around each block
            block = np.zeros((k + 2 * _PAD, 2, 1024), np.float32)
            block[_PAD:_PAD + k] = features
            feat_blocks.append(block)
            phys_seq = [seq[i] % spk.total_frames for i in range(k)]
            # threaded entry fetch: a serial JPEG decode on a cache miss
            # would stall every stream's tick
            entries = spk._entries_for(phys_seq)
            for i in range(k):
                jobs.append((st, spk, self._offsets[st.speaker] + phys_seq[i],
                             feat_base + _PAD + i, entries[i]))
            feat_base += k + 2 * _PAD

        if not jobs:
            return {sid: [] for sid in requests}

        feats = np.concatenate(feat_blocks, axis=0)
        padded_t = max(self.feature_bucket,
                       -(-len(feats) // self.feature_bucket)
                       * self.feature_bucket)
        feats = np.pad(feats, ((0, padded_t - len(feats)), (0, 0), (0, 0)))
        # fp32 up, cast on the card: FrameSynthesizer's cast
        feats_dev = torch.from_numpy(feats).to(self.device).to(
            self.model.dtype)

        # launch every device batch first, then gather
        pending = []
        for start in range(0, len(jobs), self.batch_size):
            chunk = jobs[start:start + self.batch_size]
            phys = np.zeros((self.batch_size,), np.int64)
            fidx = np.zeros((self.batch_size,), np.int64)
            for i, (_, _, p, f, _) in enumerate(chunk):
                phys[i] = p
                fidx[i] = f
            preds = self._generate(
                self._crops_dev, torch.from_numpy(phys).to(self.device),
                feats_dev, torch.from_numpy(fidx).to(self.device))
            pending.append((len(chunk), _Pending(preds)))

        # gather and composite a batch at a time: each waits only for its
        # own copy, while the later batches compute and copy
        out: Dict[str, List[dict]] = {sid: [] for sid in requests}
        size = self.crop.size
        job_pos = 0
        for n, p in pending:
            for r in p.numpy()[:n]:
                st, spk, phys_g, _, entry = jobs[job_pos]
                job_pos += 1
                if self.transfer_format == "yuv420":
                    pred = yuv420_unpack(r, size)
                else:
                    pred = r.reshape(size, size, 3)
                st.logical_index += 1
                out[st.stream_id].append({
                    "frame": spk._paste_back(pred, entry),
                    "index": st.logical_index,
                    "physical_index": phys_g - self._offsets[st.speaker]})
        return out

    def close(self) -> None:
        for s in self._speakers:
            s.close()
