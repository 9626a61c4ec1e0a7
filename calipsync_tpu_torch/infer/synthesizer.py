"""FrameSynthesizer: batched lip-sync frame generation and paste-back
(counterpart of calipsync_tpu/infer/synthesizer.py; the reference
implementation's image_infer_v1/tools/frame_synthesizer/infer_api.py).

  - "Motion generalization" ping-pong walk over physical frames (random
    5-15%-of-total segments, direction flips at clip ends) driven by an
    explicit numpy Generator.
  - The speaker's mouth crops live on the device once (``preload``); each
    step sends two index vectors and the device gathers crops and audio
    windows, masks the mouth, runs the generator and packs uint8 rows
    (``make_generate_resident_fn``). Without preload each batch uploads
    its crops (``make_generate_fn``).
  - A software pipeline overlaps the device with the host: the main
    thread launches batch k (asynchronous on the CUDA stream) and its copy
    into pinned host memory; a worker thread waits for that copy and
    composites while batch k+1 computes.
  - Paste-back (face polygon -> area-proportional dilate -> optional XSeg
    blend -> alpha composite) is uint8 host work through
    native/compositor.cpp, pixel-matching the reference.

Transfer formats: 'bgr' (reference-exact uint8 crops), 'yuv420' (planar
I420 packed on the device, half the bytes) and 'adaptive', which runs one
of the two a call and keeps the faster by measured fps (the JAX package's
bandit, unchanged: ``_choose_call_format``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import cv2
import numpy as np
import torch

from calipsync_tpu_torch.audio.windows import batched_windows
from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.native_ext import composite_frame
from calipsync_tpu_torch.nn.unet import Generator
from calipsync_tpu_torch.vision.geometry import CropParams, mouth_bbox_infer

TRANSFER_FORMATS = ("bgr", "yuv420")


def _check_format(transfer_format: str, allowed=TRANSFER_FORMATS) -> None:
    if transfer_format not in allowed:
        raise ValueError(f"unknown transfer_format: {transfer_format!r} "
                         f"(supported: {allowed})")


def yuv420_pack(pred255: torch.Tensor) -> torch.Tensor:
    """BGR -> planar I420 on the device: (B, S, S, 3) float in [0, 255] ->
    (B, S*S*3//2) uint8 [Y plane | U plane | V plane]. Video-range BT.601,
    the exact pair of OpenCV's COLOR_YUV2BGR_I420; chroma is a 2x2 mean;
    rounded, not truncated."""
    b, g, r = pred255[..., 0], pred255[..., 1], pred255[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) * (1.0 / 256.0)
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) * (1.0 / 256.0)
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) * (1.0 / 256.0)

    def sub(c):  # 2x2 mean chroma
        n, h, w = c.shape
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def q(c):
        return torch.clamp(torch.round(c), 0.0, 255.0).to(torch.uint8)

    n = pred255.shape[0]
    return torch.cat([q(y).reshape(n, -1), q(sub(u)).reshape(n, -1),
                      q(sub(v)).reshape(n, -1)], dim=1)


def yuv420_unpack(flat_u8: np.ndarray, size: int) -> np.ndarray:
    """Host-side inverse of :func:`yuv420_pack` for ONE frame:
    (S*S*3//2,) uint8 -> (S, S, 3) uint8 BGR via OpenCV's I420 decode."""
    return cv2.cvtColor(flat_u8.reshape(size * 3 // 2, size),
                        cv2.COLOR_YUV2BGR_I420)


def _pack_pred(pred: torch.Tensor, transfer_format: str) -> torch.Tensor:
    """Model output (B,S,S,3) float [0,1] -> flat uint8 rows. 'bgr' keeps
    the reference's quantization (float*255 C-cast truncation); 'yuv420'
    halves the bytes."""
    _check_format(transfer_format)
    pred = pred * 255.0
    if transfer_format == "yuv420":
        return yuv420_pack(pred)
    return pred.to(torch.uint8).reshape(pred.shape[0], -1)


def make_generate_fn(model: Generator, transfer_format: str = "bgr",
                     device: str | torch.device | None = None):
    """Device step from uploaded crops: uint8 crops -> uint8 mouth rows.

    Moves ``model`` to ``device`` ('cuda' by default; raises without a
    GPU) and runs there.

    fn(ref_u8 (B,160,160,3), masked_u8 (B,160,160,3), audio_feats (T,2,1024),
       indices (B,)) -> (B, S) uint8 on that device
    (S = size*size*3 for 'bgr', size*size*3//2 for 'yuv420').
    """
    _check_format(transfer_format)
    dev = resolve_device(device)
    model.to(dev)

    @torch.inference_mode()
    def fn(ref_u8, masked_u8, audio_feats, indices):
        dtype = model.dtype
        imgs = torch.cat([ref_u8.to(dev), masked_u8.to(dev)],
                         dim=-1).to(dtype) / 255.0
        audio = batched_windows(audio_feats.to(dev), indices,
                                mode=model.mode).to(dtype)
        return _pack_pred(model(imgs, audio), transfer_format)

    return fn


def make_generate_resident_fn(model: Generator, crop: CropConfig,
                              transfer_format: str = "bgr",
                              device: str | torch.device | None = None):
    """Device-resident step: the speaker's mouth crops live on the device
    once, flat (N, size*size*3) uint8, and batches are addressed by index;
    the mouth mask is applied on the device. Moves ``model`` to ``device``
    ('cuda' by default; raises without a GPU).

    fn(crops_u8 (N, S) [resident], phys_idx (B,), audio_feats (T,2,1024)
       [resident], feat_idx (B,)) -> (B, S') uint8 on that device; the
    resident arrays are expected there already.
    """
    _check_format(transfer_format)
    model.to(resolve_device(device))
    y0, y1 = crop.mask_y, crop.mask_y + crop.mask_h
    x0, x1 = crop.mask_x, crop.mask_x + crop.mask_w
    size = crop.size

    @torch.inference_mode()
    def fn(crops_u8, phys_idx, audio_feats, feat_idx):
        dtype = model.dtype
        ref = crops_u8[phys_idx].reshape(-1, size, size, 3).to(dtype) / 255.0
        masked = ref.clone()
        masked[:, y0:y1, x0:x1, :] = 0.0
        imgs = torch.cat([ref, masked], dim=-1)
        audio = batched_windows(audio_feats, feat_idx,
                                mode=model.mode).to(dtype)
        return _pack_pred(model(imgs, audio), transfer_format)

    return fn


class PingPongSequencer:
    """Physical-frame walk (reference _generate_frame_sequence:147-190)."""

    def __init__(self, total_frames: int, rng: np.random.Generator,
                 min_pct: int = 5, max_pct: int = 15):
        self.total_frames = total_frames
        self.rng = rng
        self.min_pct = min_pct
        self.max_pct = max_pct
        self.direction: Optional[int] = None
        self.target = 0
        self.processed = 0
        self.position = 0

    def next(self, needed: int) -> list[int]:
        seq: list[int] = []
        if self.processed >= self.target or self.direction is None:
            pct = int(self.rng.integers(self.min_pct, self.max_pct + 1))
            self.target = self.total_frames * pct // 100
            self.direction = int(self.rng.choice([1, -1]))
            self.processed = 0
        while len(seq) < needed:
            seq.append(self.position)
            self.position += self.direction
            if self.position >= self.total_frames:
                self.position = self.total_frames - 2
                self.direction = -1
            elif self.position < 0:
                self.position = 1
                self.direction = 1
        self.processed += len(seq)
        return seq


class _Pending:
    """A device batch of packed rows on its way to the host: on CUDA a
    copy into pinned memory behind an event, on the CPU the rows
    themselves."""

    def __init__(self, preds: torch.Tensor):
        if preds.device.type == "cuda":
            self.host = torch.empty(preds.shape, dtype=preds.dtype,
                                    pin_memory=True)
            self.host.copy_(preds, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = preds, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class FrameSynthesizer:
    def __init__(self, state_dict: Optional[dict], data_dir: str,
                 model: Optional[Generator] = None, batch_size: int = 8,
                 crop: CropConfig = CropConfig(),
                 seed: Optional[int] = None,
                 max_cached_frames: int = 4000,
                 preload: bool = True,
                 pipeline_depth: int = 3,
                 transfer_format: str = "bgr",
                 preload_max_bytes: int = 4 << 30,
                 first_batch_size: int = 0,
                 device: str | torch.device | None = None):
        """
        Args:
          state_dict: generator weights with the reference key names (e.g.
            from ``core.weights.from_jax_generator``), loaded strictly into
            ``model``; None keeps ``model``'s own weights.
          data_dir: step3 ``infer_data`` directory (frames/positions/masks)
          model: Generator (default: fp32 hubert)
          batch_size: device batch; tails are padded to it
          max_cached_frames: LRU bound on the host cache of decoded frames
            and their derived crops/masks.
          preload: decode every physical frame up front and keep the whole
            speaker's mouth-crop array on the device (~75 KB/frame); each
            step then uploads only two index vectors.
          pipeline_depth: device batches in flight.
          transfer_format: 'bgr', 'yuv420' or 'adaptive' (see module
            docstring).
          preload_max_bytes: crop stores above this use the upload path.
          first_batch_size: when >0, the first device batch of each
            iterate call runs at this smaller padded shape so the first
            frame ships early; the rest runs at ``batch_size``.
            Output-identical.
          device: 'cuda' (default; raises without a GPU) or 'cpu'.
        """
        _check_format(transfer_format, TRANSFER_FORMATS + ("adaptive",))
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.batch_size = batch_size
        self.set_first_batch_size(first_batch_size)
        self.crop = crop
        self.frames_dir = os.path.join(data_dir, "frames")
        self.positions_dir = os.path.join(data_dir, "positions")
        self.masks_dir = os.path.join(data_dir, "masks")
        self.total_frames = len([f for f in os.listdir(self.frames_dir)
                                 if f.endswith(".jpg")])
        model = model or Generator()
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval()  # the step factories move it
        self.transfer_format = transfer_format
        # the formats this synthesizer dispatches; adaptive keeps both
        # steps and starts on yuv420 (its worst case is a sub-ms host
        # decode, bgr's twice the bytes); measurements take over within
        # two calls
        fmts = (TRANSFER_FORMATS if transfer_format == "adaptive"
                else (transfer_format,))
        self._active_format = fmts[-1]
        self._fmt_fps: Dict[tuple, float] = {}
        self._last_explore = 0.0
        self._generate_fns = {f: make_generate_fn(self.model, f, self.device)
                              for f in fmts}
        self._generate_resident_fns = {
            f: make_generate_resident_fn(self.model, crop, f, self.device)
            for f in fmts}
        self.executor = ThreadPoolExecutor(max_workers=max(4, batch_size))
        self.sequencer = PingPongSequencer(
            self.total_frames, np.random.default_rng(seed))
        self.last_logical_index = -1
        self.pipeline_depth = pipeline_depth
        self.max_cached_frames = max_cached_frames
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._crops_dev: Optional[torch.Tensor] = None
        if preload and self.total_frames > 0:
            store_bytes = self.total_frames * crop.size * crop.size * 3
            if store_bytes > preload_max_bytes:
                print(f"crop store {store_bytes >> 20} MiB exceeds "
                      f"preload_max_bytes; using the upload path")
            else:
                self.preload()

    def set_first_batch_size(self, n: int) -> int:
        """Validated setter for the first-window head batch: sizes outside
        [1, batch_size) disable it (0). Returns the effective value."""
        requested = n
        if n < 0 or n >= self.batch_size:
            n = 0
        if requested > 0 and n == 0:
            print(f"first_batch_size {requested} disabled: must be in "
                  f"[1, batch_size)")
        self.first_batch_size = n
        return n

    # ---------------- per-physical-frame cache ----------------

    def _build_entry(self, phys_idx: int) -> dict:
        """Load one physical frame and precompute everything derived from
        (frame, landmarks): model input crops and the dilated face-polygon
        compositing mask."""
        cfg = self.crop
        n = str(phys_idx % self.total_frames).zfill(6)
        img = cv2.imread(os.path.join(self.frames_dir, f"{n}.jpg"))
        lms = np.loadtxt(os.path.join(self.positions_dir, f"{n}.txt"))
        xseg = None
        mask_path = os.path.join(self.masks_dir, f"{n}.jpg")
        if os.path.exists(mask_path):
            m = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
            if m is not None:
                xseg = m.astype(np.float32) / 255.0

        h, w = img.shape[:2]
        p = mouth_bbox_infer(lms, h, w)
        crop168 = cv2.resize(img[p.ymin:p.ymax, p.xmin:p.xmax],
                             (cfg.resize, cfg.resize))
        m = cfg.margin
        real = np.ascontiguousarray(crop168[m:cfg.resize - m,
                                            m:cfg.resize - m])
        masked = real.copy()
        masked[cfg.mask_y:cfg.mask_y + cfg.mask_h,
               cfg.mask_x:cfg.mask_x + cfg.mask_w] = 0

        # compositing mask (reference process_batch:279-315): face polygon
        # scaled into the (width, width) paste square, area-proportional
        # dilation, optional XSeg blend
        face_mask = np.zeros((p.ymax - p.ymin, p.xmax - p.xmin), np.uint8)
        pts = np.asarray(lms[:33], dtype=np.float64).copy()
        pts[:, 0] -= p.xmin
        pts[:, 1] -= p.ymin
        pts[:, 0] *= p.width / (p.xmax - p.xmin)
        pts[:, 1] *= p.width / (p.ymax - p.ymin)
        cv2.fillPoly(face_mask, [pts.astype(np.int32)], 255)
        area = np.sum(face_mask > 0)
        expand = max(1, int(np.sqrt(area / np.pi) * 0.15))
        kernel = np.ones((expand * 2 + 1, expand * 2 + 1), np.uint8)
        face_mask = cv2.dilate(face_mask, kernel, iterations=1)
        fm = (face_mask.astype(np.float32) / 255.0)[..., None]
        if xseg is not None:
            # resized to the face mask's own shape, which equals the
            # reference's (width, width) whenever the bbox is unclamped
            rm = cv2.resize(xseg, (p.xmax - p.xmin, p.ymax - p.ymin))
            fm = fm * rm[..., None]

        return {"img": img, "lms": lms, "params": p, "crop168": crop168,
                "ref": real, "masked": masked, "fm": fm}

    def _frame_entry(self, phys_idx: int) -> dict:
        phys_idx = phys_idx % self.total_frames
        with self._cache_lock:
            e = self._cache.get(phys_idx)
            if e is not None:
                self._cache.move_to_end(phys_idx)
                return e
        e = self._build_entry(phys_idx)  # outside the lock (ms-scale work)
        with self._cache_lock:
            self._cache[phys_idx] = e
            while len(self._cache) > self.max_cached_frames:
                self._cache.popitem(last=False)
        return e

    def _entries_for(self, seq):
        return list(self.executor.map(self._frame_entry, seq))

    def preload(self) -> None:
        """Decode all physical frames and put the flat (N, S*S*3) uint8
        crop store on the device."""
        crops = np.stack(list(self.executor.map(
            lambda i: self._frame_entry(i)["ref"].reshape(-1),
            range(self.total_frames))))
        self._crops_dev = torch.from_numpy(crops).to(self.device)

    # ---------------- adaptive transfer format ----------------
    #
    # The signal is each format's MEASURED throughput, not a cost model of
    # the link: each iterate call runs ONE format, its achieved fps feeds
    # an EMA keyed by (format, call-size class), and the next call takes
    # the argmax, re-measuring the loser every ``_EXPLORE_INTERVAL_S``.
    # Size classes keep 25-row streaming windows (fixed costs dominate)
    # apart from 1000-row offline calls.

    _EXPLORE_INTERVAL_S = 30.0

    def _size_class(self, n_rows: int) -> str:
        return "small" if n_rows <= 64 else "large"

    def _note_call_fps(self, fmt: str, n_rows: int, wall: float) -> None:
        if self.transfer_format != "adaptive" or not n_rows or wall <= 0:
            return
        key = (fmt, self._size_class(n_rows))
        fps = n_rows / wall
        old = self._fmt_fps.get(key)
        self._fmt_fps[key] = fps if old is None else 0.5 * old + 0.5 * fps

    def _choose_call_format(self, n_rows: int) -> str:
        """The transfer format of one whole iterate call: a table lookup
        that never blocks, so it is safe ahead of the head batch."""
        if self.transfer_format != "adaptive":
            return self._active_format
        cls = self._size_class(n_rows)
        bgr = self._fmt_fps.get(("bgr", cls))
        yuv = self._fmt_fps.get(("yuv420", cls))
        if bgr is None and yuv is None:
            choice = self._active_format  # bootstrap on the default
        elif bgr is None:
            choice = "bgr"                # measure the unmeasured arm
            self._last_explore = time.time()  # bootstrap IS an explore
        elif yuv is None:
            choice = "yuv420"
            self._last_explore = time.time()
        elif (time.time() - self._last_explore
                > self._EXPLORE_INTERVAL_S):
            self._last_explore = time.time()
            choice = "bgr" if bgr <= yuv else "yuv420"  # refresh loser
        else:
            choice = "bgr" if bgr > yuv else "yuv420"
        self._active_format = choice
        return choice

    # ---------------- synthesis ----------------

    def _dispatch(self, entries, seq, feature_indices, feats_dev, fmt: str,
                  pad_to: Optional[int] = None) -> _Pending:
        """Stage inputs, launch the device step packing rows in ``fmt`` and
        the copy of its rows to the host (both asynchronous on CUDA).
        ``pad_to`` overrides the padded batch (the small first-window
        batch)."""
        n = len(entries)
        pad_to = pad_to or self.batch_size
        feat_idx = np.zeros((pad_to,), np.int64)
        feat_idx[:n] = feature_indices
        feat_idx = torch.from_numpy(feat_idx).to(self.device)
        if self._crops_dev is not None:
            phys_idx = np.zeros((pad_to,), np.int64)
            phys_idx[:n] = [s % self.total_frames for s in seq]
            preds = self._generate_resident_fns[fmt](
                self._crops_dev, torch.from_numpy(phys_idx).to(self.device),
                feats_dev, feat_idx)
        else:
            cfg = self.crop
            ref_u8 = np.zeros((pad_to, cfg.size, cfg.size, 3), np.uint8)
            masked_u8 = np.zeros_like(ref_u8)
            for i, e in enumerate(entries):
                ref_u8[i] = e["ref"]
                masked_u8[i] = e["masked"]
            preds = self._generate_fns[fmt](
                torch.from_numpy(ref_u8).to(self.device),
                torch.from_numpy(masked_u8).to(self.device), feats_dev,
                feat_idx)
        return _Pending(preds)

    def _paste_back(self, pred_u8: np.ndarray, entry: dict) -> np.ndarray:
        """Composite one generated mouth into a copy of its full frame
        (reference process_batch:263-349)."""
        cfg = self.crop
        p: CropParams = entry["params"]
        crop_img = entry["crop168"].copy()
        m = cfg.margin
        crop_img[m:cfg.resize - m, m:cfg.resize - m] = pred_u8
        crop_img = cv2.resize(crop_img, (p.width, p.width))

        if crop_img.shape[:2] != (p.ymax - p.ymin, p.xmax - p.xmin):
            return entry["img"].copy()  # shape-mismatch fallback (:317-324)
        return composite_frame(entry["img"], crop_img,
                               entry["fm"][..., 0], p.ymin, p.xmin)

    def _composite_batch(self, pending: _Pending, entries,
                         fmt: str) -> list[np.ndarray]:
        cfg = self.crop
        preds = pending.numpy()[:len(entries)]  # waits for the copy
        if fmt == "yuv420":
            preds = [yuv420_unpack(p, cfg.size) for p in preds]
        else:
            preds = preds.reshape(-1, cfg.size, cfg.size, 3)
        return [self._paste_back(preds[i], e) for i, e in enumerate(entries)]

    def iterate_synthesized_frames(
            self, features: np.ndarray, start_frame_idx: int = 0,
            is_generate_sync_frame: bool = True,
            row_range: Optional[tuple] = None) -> Iterator[Dict]:
        """Yield {'frame','index','physical_index'} dicts for each output
        frame driven by the HuBERT features (reference :359-451), in order.

        ``row_range=(lo, hi)`` generates frames only for feature rows
        [lo, hi) while the rest of the array gives audio-window context
        (the window spans rows [i-8, i+8)); results equal one call over the
        full array provided span starts are multiples of ``batch_size``."""
        self.last_logical_index = start_frame_idx - 1
        stats = {"load_frame": 0.0, "process_batch": 0.0}
        total = len(features)
        lo, hi = (0, total) if row_range is None else row_range
        if not (0 <= lo <= hi <= total):
            raise ValueError(f"row_range {row_range} out of bounds for "
                             f"{total} feature rows")
        n_rows = hi - lo
        feats_dev = torch.from_numpy(
            np.ascontiguousarray(features, dtype=np.float32)).to(
                self.device).to(self.model.dtype)

        inflight: deque = deque()  # (future -> frames, seq)
        t_start = time.time()

        def emit(frames, seq):
            for frame, phys in zip(frames, seq):
                self.last_logical_index += 1
                yield {"frame": frame, "index": self.last_logical_index,
                       "physical_index": phys}

        # batch partition: optional small head (first_batch_size) so the
        # first frame ships early, then full batches
        ranges = []
        pos = lo
        if self.first_batch_size and hi - lo > self.first_batch_size:
            ranges.append((pos, pos + self.first_batch_size))
            pos += self.first_batch_size
        while pos < hi:
            ranges.append((pos, min(pos + self.batch_size, hi)))
            pos += self.batch_size

        # The sequencer redraws its random segment at next() call
        # boundaries, so it is always pulled at the canonical batch_size
        # partition; the head batch only re-slices the index stream. This
        # keeps the physical walk identical for any first_batch_size.
        def canonical_seq_stream():
            p = lo
            while p < hi:
                n = min(self.batch_size, hi - p)
                yield from self.sequencer.next(n)
                p += n

        seq_iter = canonical_seq_stream()
        # one transfer format a call; the call's achieved fps is fed back
        # in the finally block
        call_fmt = self._choose_call_format(n_rows)
        try:
            for ri, (start, end) in enumerate(ranges):
                head = (ri == 0 and self.first_batch_size
                        and end - start == self.first_batch_size)
                seq = list(itertools.islice(seq_iter, end - start))

                t0 = time.time()
                entries = self._entries_for(seq)
                stats["load_frame"] += time.time() - t0

                if not is_generate_sync_frame:
                    yield from emit([e["img"].copy() for e in entries], seq)
                    continue

                pending = self._dispatch(
                    entries, seq, list(range(start, end)), feats_dev,
                    call_fmt, pad_to=self.first_batch_size if head else None)
                inflight.append((self.executor.submit(
                    self._composite_batch, pending, entries, call_fmt), seq))
                # pop as soon as the head batch is composited, so frames
                # reach the consumer before the pipeline is full
                while len(inflight) >= self.pipeline_depth or (
                        inflight and inflight[0][0].done()):
                    fut, s = inflight.popleft()
                    yield from emit(fut.result(), s)
            while inflight:
                fut, s = inflight.popleft()
                yield from emit(fut.result(), s)
        finally:
            stats["process_batch"] = time.time() - t_start - \
                stats["load_frame"]
            t = time.time() - t_start
            if is_generate_sync_frame:
                # frames actually delivered: an early-closed generator
                # must not report the full row count over a short wall
                emitted = self.last_logical_index - start_frame_idx + 1
                self._note_call_fps(call_fmt, min(emitted, n_rows), t)
            if t > 0 and n_rows:
                print(f"synthesis: {n_rows / t:.2f} fps "
                      f"(load {stats['load_frame']:.2f}s, "
                      f"generate+paste {stats['process_batch']:.2f}s)")

    def close(self) -> None:
        self.executor.shutdown(wait=True)

    def __del__(self):
        if hasattr(self, "executor"):
            self.executor.shutdown(wait=False)
