"""HuBERT / WeNet feature windowing: per-frame +-8 rows of context ->
the generator's audio input (counterpart of calipsync_tpu/audio/windows.py).

The reference slices a 16-row window of (2,1024) HuBERT features around
each video frame, zero-padding at clip edges, and reshapes it to a
(32,32,32) NCHW tensor (the reference's dataset/dataset.py:39-56,172-176).
The port keeps the JAX package's NHWC layout at its public functions:
(h, w, c) = nchw (c, h, w) transposed.

  - :func:`window_rows_np`, :func:`pack_nhwc_np`, :func:`window_nhwc_np`:
    host-side numpy, one frame at a time.
  - :func:`batched_windows`: one batch of windows gathered on the device
    from the whole feature array (out-of-range rows masked to zero).
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = 16  # rows of (2, 1024) => +-8 frames of context


def window_rows_np(features: np.ndarray, index: int) -> np.ndarray:
    """(T, 2, 1024) -> (16, 2, 1024) rows [index-8, index+8), zero-padded."""
    t = features.shape[0]
    left, right = index - 8, index + 8
    pad_left = max(0, -left)
    pad_right = max(0, right - t)
    rows = features[max(0, left):min(t, right)]
    if pad_left or pad_right:
        rows = np.pad(rows, ((pad_left, pad_right), (0, 0), (0, 0)))
    return rows


def pack_nhwc_np(rows: np.ndarray) -> np.ndarray:
    """(16, 2, 1024) -> (32, 32, 32) NHWC (channels last)."""
    nchw = rows.reshape(32, 32, 32)  # (C, H, W) in reference layout
    return np.ascontiguousarray(nchw.transpose(1, 2, 0))


def window_nhwc_np(features: np.ndarray, index: int) -> np.ndarray:
    """Host-side: one frame's audio window as (32, 32, 32) NHWC fp32."""
    return pack_nhwc_np(window_rows_np(features, index).astype(np.float32))


def batched_windows(features: torch.Tensor, indices: torch.Tensor,
                    mode: str = "hubert") -> torch.Tensor:
    """Batch windowing on the features' device.

    Args:
      features: (T, ...) features of the whole clip — HuBERT (T, 2, 1024)
        or WeNet rows of 8192 values.
      indices: (B,) integer frame indices.
      mode: 'hubert' -> (B, 32, 32, 32) NHWC; 'wenet' -> (B, 16, 32, 256)
        NHWC (the reference's (256,16,32) NCHW reshape, channels last).
    Returns:
      Audio windows in features.dtype, zero at rows outside the clip.
    """
    if mode == "hubert":
        nchw = (32, 32, 32)
    elif mode == "wenet":
        nchw = (256, 16, 32)
    else:
        raise ValueError(f"unknown mode: {mode}")
    t = features.shape[0]
    flat = features.reshape(t, -1)
    offs = torch.arange(WINDOW, device=features.device) - 8
    rows = indices.to(features.device, torch.long)[:, None] + offs[None, :]
    valid = (rows >= 0) & (rows < t)
    gathered = flat[rows.clamp(0, t - 1)]                    # (B, 16, F)
    gathered = torch.where(valid[..., None], gathered,
                           gathered.new_zeros(()))
    return gathered.reshape(-1, *nchw).permute(0, 2, 3, 1)
