"""S3FD face detector, VGG16-SSD (counterpart of calipsync_tpu/nn/s3fd.py;
the reference's utils/lip_detector/tools/s3fd).

The backbone and heads run as one forward on the card (NCHW convs); the
priors, box decode and greedy NMS are small host work in numpy, the same
code as the JAX package's. The module keeps the keys of the reference's
``sfd_face.pth`` (``vgg.{i}``, ``L2Norm{3,4,5}_3``, ``extras.{i}``,
``loc.{i}``, ``conf.{i}``), so that file loads with ``strict=True``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.product_conv import ProductConv2d

S3FD_MEAN_BGR = np.array([104.0, 117.0, 123.0], dtype=np.float32)

VARIANCES = (0.1, 0.2)
MIN_SIZES = (16, 32, 64, 128, 256, 512)
STEPS = (4, 8, 16, 32, 64, 128)

# (out_channels a conv) per VGG stage; a pool ends each stage
_VGG_PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
             (512, 512, 512))
# the convs' indices in the reference's vgg ModuleList (ReLUs and pools
# between them carry no weights); 31 is fc6 (dilated), 33 fc7
_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28, 31, 33)
_SOURCE_CHANNELS = (256, 512, 512, 1024, 512, 256)


class L2Norm(nn.Module):
    """Channel L2 normalization with a learned per-channel scale."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = x.float().pow(2).sum(dim=1, keepdim=True).sqrt() + 1e-10
        return (x / norm * self.weight[None, :, None, None]).to(x.dtype)


def s3fd_feature_maps(h: int, w: int) -> tuple[tuple[int, int], ...]:
    """Source feature-map sizes for an input of (h, w): floor pools, one
    ceil pool, stride-2 k3 p1 extras."""
    def floor2(n):
        return n // 2

    def ceil2(n):
        return -(-n // 2)

    def conv_s2(n):
        return (n - 1) // 2 + 1

    s1 = (floor2(floor2(h)), floor2(floor2(w)))
    s2 = (ceil2(s1[0]), ceil2(s1[1]))
    s3 = (floor2(s2[0]), floor2(s2[1]))
    s4 = (floor2(s3[0]), floor2(s3[1]))
    s5 = (conv_s2(s4[0]), conv_s2(s4[1]))
    s6 = (conv_s2(s5[0]), conv_s2(s5[1]))
    return (s1, s2, s3, s4, s5, s6)


class S3FDBackbone(nn.Module):
    """Mean-subtracted BGR image (B, H, W, 3) -> (loc (B, N, 4), conf
    (B, N, 2) softmaxed). The priors follow the reference's flattening
    (per source map, row-major H, W)."""

    def __init__(self):
        super().__init__()
        layers: list = [nn.Identity() for _ in range(35)]
        cin = 3
        convs = iter(_VGG_CONV_IDX)
        for widths in _VGG_PLAN:
            for w in widths:
                layers[next(convs)] = ProductConv2d(cin, w, 3, padding=1)
                cin = w
        layers[next(convs)] = ProductConv2d(512, 1024, 3, padding=6,
                                            dilation=6)
        layers[next(convs)] = ProductConv2d(1024, 1024, 1)
        self.vgg = nn.ModuleList(layers)
        self.L2Norm3_3 = L2Norm(256, 10.0)
        self.L2Norm4_3 = L2Norm(512, 8.0)
        self.L2Norm5_3 = L2Norm(512, 5.0)
        self.extras = nn.ModuleList([
            ProductConv2d(1024, 256, 1), ProductConv2d(256, 512, 3, 2, 1),
            ProductConv2d(512, 128, 1), ProductConv2d(128, 256, 3, 2, 1)])
        self.loc = nn.ModuleList(ProductConv2d(c, 4, 3, padding=1)
                                 for c in _SOURCE_CHANNELS)
        self.conf = nn.ModuleList(
            ProductConv2d(c, 4 if k == 0 else 2, 3, padding=1)
            for k, c in enumerate(_SOURCE_CHANNELS))

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).to(self.vgg[0].weight.dtype)
        sources = []
        convs = iter(_VGG_CONV_IDX)
        for stage, widths in enumerate(_VGG_PLAN):
            for _ in widths:
                x = F.relu(self.vgg[next(convs)](x))
            if stage == 2:
                sources.append(self.L2Norm3_3(x))
                # ceil mode: pads an odd H or W with -inf, as the JAX pool
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                if stage == 3:
                    sources.append(self.L2Norm4_3(x))
                elif stage == 4:
                    sources.append(self.L2Norm5_3(x))
                x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.vgg[next(convs)](x))
        x = F.relu(self.vgg[next(convs)](x))
        sources.append(x)
        for i in range(0, 4, 2):
            x = F.relu(self.extras[i](x))
            x = F.relu(self.extras[i + 1](x))
            sources.append(x)

        locs, confs = [], []
        for k, s in enumerate(sources):
            b = s.shape[0]
            loc = self.loc[k](s).permute(0, 2, 3, 1)
            conf = self.conf[k](s).permute(0, 2, 3, 1)
            if k == 0:
                # max-out background label (reference nets.py:144-145)
                bg = conf[..., 0:3].amax(dim=-1, keepdim=True)
                conf = torch.cat([bg, conf[..., 3:]], dim=-1)
            locs.append(loc.reshape(b, -1, 4))
            confs.append(conf.reshape(b, -1, 2))
        loc = torch.cat(locs, dim=1).float()
        conf = torch.softmax(torch.cat(confs, dim=1).float(), dim=-1)
        return loc, conf


@functools.lru_cache(maxsize=32)
def priors_np(im_h: int, im_w: int,
              fmaps: tuple[tuple[int, int], ...]) -> np.ndarray:
    """Anchor centers and sizes in normalized coordinates."""
    out = []
    for k, (fh, fw) in enumerate(fmaps):
        f_kw = im_w / STEPS[k]
        f_kh = im_h / STEPS[k]
        j = (np.arange(fw) + 0.5) / f_kw
        i = (np.arange(fh) + 0.5) / f_kh
        cx, cy = np.meshgrid(j, i)
        s_kw = MIN_SIZES[k] / im_w
        s_kh = MIN_SIZES[k] / im_h
        n = fh * fw
        out.append(np.stack([cx.ravel(), cy.ravel(),
                             np.full(n, s_kw), np.full(n, s_kh)], axis=1))
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_np(loc: np.ndarray, priors: np.ndarray,
              variances=VARIANCES) -> np.ndarray:
    """Offset regression -> corner boxes."""
    centers = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          axis=1)


def nms_np(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy IoU NMS over [x1, y1, x2, y2, score] rows."""
    if len(dets) == 0:
        return np.zeros((0,), int)
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], \
        dets[:, 3], dets[:, 4]
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return np.asarray(keep, int)


def _bucket_pad(batch: np.ndarray) -> np.ndarray:
    """Pad a batch with zero images up to a power of 2."""
    n = len(batch)
    b = 1
    while b < n:
        b *= 2
    if b > n:
        batch = np.concatenate(
            [batch, np.zeros((b - n,) + batch.shape[1:], batch.dtype)])
    return batch


class S3FDDetector:
    """Host-facing detector with the reference wrapper's interface:
    ``detect(images) -> [(bboxes xywh, indices)]`` with the last-good-
    detection fallback."""

    def __init__(self, state_dict: dict, scale: float = 0.25,
                 det_conf_th: float = 0.8, nms_thresh: float = 0.3,
                 cross_scale_nms: float = 0.1, top_k: int = 750,
                 batch_size: int = 16, topk_device: int = 512,
                 device: str | torch.device | None = None):
        """``state_dict``: ``sfd_face.pth``'s keys, loaded strictly.
        ``topk_device``: the prior grid is
        compacted on the card to this many best-scored rows (0: the full
        grid crosses to the host). ``device``: 'cuda' (default; raises
        without a GPU) or 'cpu'."""
        self.device = resolve_device(device)
        model = S3FDBackbone()
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.scale = scale
        self.det_conf_th = det_conf_th
        self.nms_thresh = nms_thresh
        self.cross_scale_nms = cross_scale_nms
        self.top_k = top_k
        self.batch_size = batch_size
        self.topk_device = topk_device
        self._topk_sticky_off = False
        self.last_detection = None
        self._mean = torch.from_numpy(S3FD_MEAN_BGR).to(self.device)

    @torch.inference_mode()
    def _fwd(self, x_u8: np.ndarray):
        # uint8 up, the mean subtracted on the card; face scores only
        x = torch.from_numpy(x_u8).to(self.device).float() - self._mean
        loc, conf = self.model(x)
        return loc, conf[..., 1]

    def _scaled(self, image_bgr: np.ndarray) -> np.ndarray:
        return cv2.resize(image_bgr, dsize=(0, 0), fx=self.scale,
                          fy=self.scale, interpolation=cv2.INTER_LINEAR)

    def _forward_scaled(self, scaled_batch: np.ndarray):
        """(B, h, w, 3) uint8 -> numpy (loc (B, P, 4), scores (B, P)); the
        batch is padded to a power of 2."""
        n = len(scaled_batch)
        loc, scores = self._fwd(_bucket_pad(scaled_batch))
        return loc[:n].cpu().numpy(), scores[:n].cpu().numpy()

    def _forward_scaled_topk(self, scaled_batch: np.ndarray):
        """Compacted on the card: (B, h, w, 3) uint8 -> numpy (loc_k
        (B, K, 4), scores_k (B, K), prior idx_k (B, K), count (B,)), the
        count being the priors above 0.05. The host falls back to the
        full grid for an image whose count exceeds K, so the result equals
        the full grid's."""
        n = len(scaled_batch)
        with torch.inference_mode():
            loc, s = self._fwd(_bucket_pad(scaled_batch))
            k = min(self.topk_device, s.shape[1])
            count = (s > 0.05).sum(dim=1)
            vals, idx = torch.topk(s, k, dim=1)
            loc_k = torch.take_along_dim(loc, idx[..., None], dim=1)
        return (loc_k[:n].cpu().numpy(), vals[:n].cpu().numpy(),
                idx[:n].cpu().numpy(), count[:n].cpu().numpy())

    def _decode_one(self, loc: np.ndarray, scores: np.ndarray,
                    priors: np.ndarray, src_h: int, src_w: int,
                    conf_th: float) -> np.ndarray:
        """One frame's host decode -> [x1, y1, x2, y2, score] in source
        coordinates (threshold 0.05, NMS 0.3)."""
        mask = scores > 0.05
        if not mask.any():
            return np.empty((0, 5), np.float32)
        boxes = decode_np(loc[mask], priors[mask])
        return self._nms_tail(boxes, scores[mask], src_h, src_w, conf_th)

    def _decode_one_topk(self, loc_k: np.ndarray, scores_k: np.ndarray,
                         idx_k: np.ndarray, priors: np.ndarray,
                         src_h: int, src_w: int,
                         conf_th: float) -> np.ndarray:
        """Decode from compacted rows, put back in prior order first, so
        the result equals :meth:`_decode_one`'s whenever the rows above
        0.05 fit in K (ties may come out of the top-k in any order)."""
        mask = scores_k > 0.05
        if not mask.any():
            return np.empty((0, 5), np.float32)
        idx = idx_k[mask]
        order = np.argsort(idx)
        idx = idx[order]
        boxes = decode_np(loc_k[mask][order], priors[idx])
        return self._nms_tail(boxes, scores_k[mask][order], src_h, src_w,
                              conf_th)

    def _nms_tail(self, boxes: np.ndarray, s: np.ndarray, src_h: int,
                  src_w: int, conf_th: float) -> np.ndarray:
        h, w = src_h, src_w
        dets = np.concatenate([boxes, s[:, None]], axis=1)
        keep = nms_np(dets, self.nms_thresh)[:self.top_k]
        dets = dets[keep]
        # the wrapper stage: confidence filter, cross-scale NMS 0.1
        dets = dets[dets[:, 4] > conf_th]
        if len(dets):
            scale_vec = np.array([w, h, w, h], np.float32)
            dets = np.concatenate([dets[:, :4] * scale_vec, dets[:, 4:]],
                                  axis=1)
            dets = dets[nms_np(dets, self.cross_scale_nms)]
        return dets

    def detect(self, images: Sequence[np.ndarray]):
        """Frames of one shape go through one forward a ``batch_size``
        chunk; decode and NMS run a frame at a time on the host; the
        last-good-detection fallback is applied in input order."""
        n = len(images)
        scaled = [self._scaled(img) for img in images]
        all_dets: list = [None] * n

        by_shape: dict = {}
        for i, s in enumerate(scaled):
            by_shape.setdefault(s.shape, []).append(i)
        for shape, idxs in by_shape.items():
            priors = priors_np(shape[0], shape[1],
                               s3fd_feature_maps(shape[0], shape[1]))
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                stack = np.stack([scaled[i] for i in chunk])
                if self.topk_device and not self._topk_sticky_off:
                    loc_k, s_k, idx_k, count = self._forward_scaled_topk(
                        stack)
                    overflow = [j for j in range(len(chunk))
                                if count[j] > loc_k.shape[1]]
                    if len(overflow) * 2 > len(chunk):
                        # more than half the batch exceeded k (an
                        # untrained net scoring every prior > 0.05):
                        # compaction only adds a second forward here, so
                        # it is off for the rest of this detector's life
                        self._topk_sticky_off = True
                    for j, i in enumerate(chunk):
                        if j in overflow:
                            continue
                        h, w = images[i].shape[:2]
                        all_dets[i] = self._decode_one_topk(
                            loc_k[j], s_k[j], idx_k[j], priors, h, w,
                            self.det_conf_th)
                    if not overflow:
                        continue
                    # more than k priors above 0.05: those frames again
                    # through the full grid
                    sub = [chunk[j] for j in overflow]
                    loc, scores = self._forward_scaled(
                        np.stack([scaled[i] for i in sub]))
                    for j, i in enumerate(sub):
                        h, w = images[i].shape[:2]
                        all_dets[i] = self._decode_one(
                            loc[j], scores[j], priors, h, w,
                            self.det_conf_th)
                    continue
                loc, scores = self._forward_scaled(stack)
                for j, i in enumerate(chunk):
                    h, w = images[i].shape[:2]
                    all_dets[i] = self._decode_one(
                        loc[j], scores[j], priors, h, w, self.det_conf_th)

        detections = []
        for dets in all_dets:
            if len(dets) == 0:
                detections.append((np.array([]), [])
                                  if self.last_detection is None
                                  else self.last_detection)
                continue
            xywh = np.column_stack([dets[:, :2], dets[:, 2:4] - dets[:, :2]])
            current = (xywh, list(range(len(dets))))
            self.last_detection = current
            detections.append(current)
        return detections
