"""Training data over a step-1 directory (counterpart of
calipsync_tpu/data/dataset.py; the reference's dataset/dataset.py), with
the JAX package's sampling streams:

  - :class:`LipSyncDataset` and :func:`batch_iterator`: host threads decode
    JPEGs into uint8 160x160 crops (reference, masked, target) and the
    audio row index; no float math on the host. Each sample's generator is
    seeded ahead of time, so thread scheduling cannot change the stream.
  - :class:`Prefetcher`: decodes on a background thread into a bounded
    queue; ``pin_memory`` makes its batches pinned host tensors. The
    training thread issues the copies to the card (``non_blocking``), so
    every device op of a step stays on one thread and one stream.
  - :class:`ResidentLipSyncDataset`: every frame decoded once, its crop
    stored flat as uint8 on the card; a step receives index vectors.

Layout read (the step-1 output): ``{dir}/full_body_img/{i}.jpg``,
``{dir}/landmarks/{i}.lms``, ``{dir}/aud_hu.npy`` (or ``aud_wenet.npy``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from typing import Callable, Iterator, Optional

import cv2
import numpy as np
import torch

from calipsync_tpu_torch.config import CropConfig
from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.vision.geometry import (center_160, crop_resize_168,
                                                 load_landmarks,
                                                 mouth_bbox_train,
                                                 train_pair_uint8)


def count_frames(data_dir: str) -> int:
    return len([f for f in os.listdir(os.path.join(data_dir,
                                                   "full_body_img"))
                if f.endswith(".jpg")])


def _draw_ex(idx: int, n: int, rng: np.random.Generator) -> int:
    """The reference frame: uniform over {0..n-1} without ``idx`` (the
    reference's setdiff1d draw, dataset/dataset.py:141-146)."""
    ex = int(rng.integers(0, n - 1))
    return ex + 1 if ex >= idx else ex


class LipSyncDataset:
    """Index-addressable view of a step-1 directory."""

    def __init__(self, data_dir: str, mode: str = "hubert",
                 crop: CropConfig = CropConfig()):
        self.data_dir = data_dir
        self.mode = mode
        self.crop = crop
        n_frames = count_frames(data_dir)
        self.img_paths = [os.path.join(data_dir, "full_body_img", f"{i}.jpg")
                          for i in range(n_frames)]
        self.lms_paths = [os.path.join(data_dir, "landmarks", f"{i}.lms")
                          for i in range(n_frames)]
        feat_file = "aud_hu.npy" if mode == "hubert" else "aud_wenet.npy"
        self.audio_feats = np.load(
            os.path.join(data_dir, feat_file)).astype(np.float32)

    def __len__(self) -> int:
        # one sample per audio row minus one (the reference's dataset.py:37)
        return self.audio_feats.shape[0] - 1

    def _frame_idx(self, idx: int) -> int:
        return min(idx, len(self.img_paths) - 1)

    def sample(self, idx: int, rng: np.random.Generator) -> dict:
        """One training sample: uint8 crops and the audio row index."""
        fidx = self._frame_idx(idx)
        ex = self._frame_idx(_draw_ex(idx, len(self), rng))
        ref, masked, target = train_pair_uint8(
            cv2.imread(self.img_paths[fidx]),
            load_landmarks(self.lms_paths[fidx]),
            cv2.imread(self.img_paths[ex]),
            load_landmarks(self.lms_paths[ex]), self.crop)
        return {"ref": ref, "masked": masked, "target": target,
                "index": np.int32(idx)}


def batch_iterator(dataset: LipSyncDataset, batch_size: int,
                   rng: np.random.Generator, shuffle: bool = True,
                   drop_last: bool = False,
                   num_workers: int = 4) -> Iterator[dict]:
    """One epoch of stacked numpy batches, decoded by a thread pool."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    seeds = rng.integers(0, 2**63 - 1, size=len(order))
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            futs = [pool.submit(dataset.sample, int(i),
                                np.random.default_rng(int(s)))
                    for i, s in zip(idxs, seeds[start:start + len(idxs)])]
            samples = [f.result() for f in futs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def pin_memory(batch: dict) -> dict:
    """A numpy batch -> pinned host tensors (for ``Prefetcher``'s
    ``put_fn``; the training thread then copies them ``non_blocking``)."""
    return {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}


class Prefetcher:
    """Runs an iterator on a background thread into a bounded queue.

    ``put_fn`` runs on that thread on each item (``pin_memory``: host work
    only). An exception in the iterator is raised to the consumer at the
    item where it happened. ``close()`` stops the thread; call it before
    releasing what the iterator reads from.
    """

    def __init__(self, it: Iterator, depth: int = 2,
                 put_fn: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._put_fn = put_fn
        self._stop = threading.Event()
        self._it = it
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once close() is asked for, so the
        thread never stays blocked on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if self._put_fn is not None:
                    item = self._put_fn(item)
                if not self._put(item):
                    return
            self._put(None)
        except Exception as e:  # handed to the consumer, raised there
            self._put(e)

    def close(self) -> None:
        """Stop the thread, wait for it, then close the iterator."""
        self._stop.set()
        while self._thread.is_alive():
            try:  # drain, so a blocked put sees the stop flag
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        close_it = getattr(self._it, "close", None)
        if close_it is not None:
            close_it()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


class ResidentLipSyncDataset:
    """The whole speaker on the card: each frame decoded once and its
    160x160 crop stored flat (``store``, (n_frames, 160*160*3) uint8, 76.8
    KB a frame). A training pair is ref = crop(ex), masked =
    mask(crop(idx)), target = crop(idx), so a step needs only the index
    vectors of :meth:`epoch_indices`; the trainer's resident step gathers,
    masks and normalizes on the card. Sampling is that of
    :meth:`LipSyncDataset.sample` and :func:`batch_iterator`. ``device``
    defaults to the GPU (``resolve_device``)."""

    def __init__(self, data_dir: str, mode: str = "hubert",
                 crop: CropConfig = CropConfig(), device=None,
                 num_workers: int = 4):
        base = LipSyncDataset(data_dir, mode, crop)
        self.audio_feats = base.audio_feats
        self._len = len(base)
        self.n_frames = len(base.img_paths)

        def crop160(i: int) -> np.ndarray:
            x0, y0, x1, y1 = mouth_bbox_train(load_landmarks(
                base.lms_paths[i]))
            img = cv2.imread(base.img_paths[i])
            return center_160(crop_resize_168(img, y0, y1, x0, x1, crop),
                              crop).reshape(-1)

        with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
            store = np.stack(list(pool.map(crop160, range(self.n_frames))))
        self.store = torch.from_numpy(store).to(resolve_device(device))

    def __len__(self) -> int:
        return self._len

    def epoch_indices(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True, drop_last: bool = True
                      ) -> Iterator[tuple]:
        """Yield (index, fidx, ex) int32 arrays a batch: the audio row, the
        clamped frame and the reference frame, drawn with the per-sample
        streams of :func:`batch_iterator`."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        seeds = rng.integers(0, 2**63 - 1, size=len(order))
        last_frame = self.n_frames - 1
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            ex = [min(_draw_ex(int(i), len(self),
                               np.random.default_rng(int(s))), last_frame)
                  for i, s in zip(idxs, seeds[start:start + len(idxs)])]
            yield (idxs.astype(np.int32),
                   np.minimum(idxs, last_frame).astype(np.int32),
                   np.asarray(ex, np.int32))
