"""YOLOv8n-face (counterpart of calipsync_tpu/nn/yolo.py): a YOLOv8-n
pose-style network with 1 class and 5 facial keypoints.

  backbone  CSP stages of Conv(k3, s2) + C2f, then SPPF            (0-9)
  neck      PAN: 2x nearest upsample + concat + C2f, then down    (10-21)
  head      per-scale branches: box (4*reg_max via DFL), cls (1),
            keypoints (5 x (x, y, conf))                           (22)

The module keeps the ultralytics ``model.{i}.*`` keys (pinned by
tests/fixtures/yolov8n_face_state_dict_keys.tsv), so a
``yolov8n_face_state_dict.pth`` loads with ``strict=True``. The convs run
NCHW on the card; the network takes and returns NHWC, as the JAX module
does. The DFL expectation, box and keypoint decode and sigmoids run on the
card beside the net, so only (N, anchors, 20) crosses to the host; greedy
NMS stays on the host.
"""

from __future__ import annotations

from typing import Sequence

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.core.device import resolve_device
from calipsync_tpu_torch.nn.product_conv import ProductConv2d
from calipsync_tpu_torch.nn.s3fd import nms_np

REG_MAX = 16
NUM_KPT = 5
STRIDES = (8, 16, 32)


class ConvBNSiLU(nn.Module):
    """ultralytics Conv: bias-less conv (k//2 pad), BN (eps 1e-3), SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.conv = ProductConv2d(cin, cout, kernel, stride, kernel // 2,
                                  bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNSiLU(c, c, 3)
        self.cv2 = ConvBNSiLU(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: split after cv1, chain n bottlenecks on
    the second half, concatenate everything into cv2."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        self.c = cout // 2
        self.cv1 = ConvBNSiLU(cin, cout, 1)
        self.cv2 = ConvBNSiLU((2 + n) * self.c, cout, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, shortcut)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, pool: int = 5):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBNSiLU(cin, c, 1)
        self.cv2 = ConvBNSiLU(c * 4, cout, 1)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.pool, 1,
                                     self.pool // 2))
        return self.cv2(torch.cat(outs, dim=1))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest 2x: each pixel repeated over a 2x2 block."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class DFL(nn.Module):
    """The distribution-focal-loss projection: a fixed arange 1x1 conv in
    the checkpoint. The decode computes the expectation directly; the
    weight is kept for the key layout."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(REG_MAX, 1, 1, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(
                REG_MAX, dtype=torch.float32).view(1, REG_MAX, 1, 1))
        self.conv.requires_grad_(False)


def _branch(cin: int, mid: int, out: int) -> nn.Sequential:
    """Two ConvBNSiLU(k3), then a biased 1x1 (ultralytics cv2/cv3/cv4)."""
    return nn.Sequential(ConvBNSiLU(cin, mid, 3), ConvBNSiLU(mid, mid, 3),
                         ProductConv2d(mid, out, 1))


class Pose(nn.Module):
    """The face head: cv2 box, cv3 class, cv4 keypoints, per scale."""

    def __init__(self, chs: Sequence[int], num_classes: int = 1):
        super().__init__()
        c_box = max(16, chs[0] // 4, REG_MAX * 4)
        c_cls = max(chs[0], min(num_classes, 100))
        c_kpt = max(chs[0] // 4, NUM_KPT * 3)
        self.cv2 = nn.ModuleList(_branch(c, c_box, 4 * REG_MAX) for c in chs)
        self.cv3 = nn.ModuleList(_branch(c, c_cls, num_classes) for c in chs)
        self.cv4 = nn.ModuleList(_branch(c, c_kpt, NUM_KPT * 3) for c in chs)
        self.dfl = DFL()


class YoloV8Face(nn.Module):
    """The detector trunk and pose-style face head.

    channels: per-stage widths; (16, 32, 64, 128, 256) is the 'n' scale.
    depths: C2f bottleneck counts per backbone stage; (1, 2, 2, 1) is 'n'.
    (N, H, W, 3) in; per scale s in (8, 16, 32) returns NHWC
      box (N, H_s, W_s, 4*REG_MAX) raw DFL logits,
      cls (N, H_s, W_s, 1) raw logits,
      kpt (N, H_s, W_s, NUM_KPT*3) raw offsets and logits.
    """

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256),
                 depths: Sequence[int] = (1, 2, 2, 1),
                 num_classes: int = 1):
        super().__init__()
        ch, d = channels, depths
        self.model = nn.ModuleList([
            ConvBNSiLU(3, ch[0], 3, 2),                 # 0
            ConvBNSiLU(ch[0], ch[1], 3, 2),             # 1
            C2f(ch[1], ch[1], d[0], True),              # 2
            ConvBNSiLU(ch[1], ch[2], 3, 2),             # 3
            C2f(ch[2], ch[2], d[1], True),              # 4
            ConvBNSiLU(ch[2], ch[3], 3, 2),             # 5
            C2f(ch[3], ch[3], d[2], True),              # 6
            ConvBNSiLU(ch[3], ch[4], 3, 2),             # 7
            C2f(ch[4], ch[4], d[3], True),              # 8
            SPPF(ch[4], ch[4]),                         # 9
            nn.Identity(), nn.Identity(),               # 10 up, 11 concat
            C2f(ch[4] + ch[3], ch[3], d[0]),            # 12
            nn.Identity(), nn.Identity(),               # 13 up, 14 concat
            C2f(ch[3] + ch[2], ch[2], d[0]),            # 15
            ConvBNSiLU(ch[2], ch[2], 3, 2),             # 16
            nn.Identity(),                              # 17 concat
            C2f(ch[2] + ch[3], ch[3], d[0]),            # 18
            ConvBNSiLU(ch[3], ch[3], 3, 2),             # 19
            nn.Identity(),                              # 20 concat
            C2f(ch[3] + ch[4], ch[4], d[0]),            # 21
            Pose((ch[2], ch[3], ch[4]), num_classes),   # 22
        ])

    def forward(self, x: torch.Tensor):
        m = self.model
        x = x.permute(0, 3, 1, 2).to(m[0].conv.weight.dtype)
        x = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        n4 = m[12](torch.cat([upsample2x_nearest(p5), p4], dim=1))
        n3 = m[15](torch.cat([upsample2x_nearest(n4), p3], dim=1))
        o4 = m[18](torch.cat([m[16](n3), n4], dim=1))
        o5 = m[21](torch.cat([m[19](o4), p5], dim=1))
        head = m[22]
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return [(nhwc(head.cv2[i](f)), nhwc(head.cv3[i](f)),
                 nhwc(head.cv4[i](f))) for i, f in enumerate((n3, o4, o5))]


def decode_outputs(outs):
    """Raw per-scale head outputs -> (boxes_xyxy (N, A, 4), scores (N, A),
    kpts (N, A, 5, 3)) in letterboxed-image pixels.

    Box: DFL softmax expectation over REG_MAX bins -> l, t, r, b distances
    from the anchor center, times the stride. Keypoints: ultralytics' pose
    decode ``(raw_xy * 2 + center - 0.5) * stride``; conf = sigmoid.
    """
    all_boxes, all_scores, all_kpts = [], [], []
    for (box, cls, kpt), stride in zip(outs, STRIDES):
        n, h, w, _ = box.shape
        dev = box.device
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cx = (gx + 0.5).reshape(-1)
        cy = (gy + 0.5).reshape(-1)

        dist = box.float().reshape(n, h * w, 4, REG_MAX)
        dist = torch.softmax(dist, dim=-1) @ bins          # (N, HW, 4)
        x1 = (cx[None] - dist[..., 0]) * stride
        y1 = (cy[None] - dist[..., 1]) * stride
        x2 = (cx[None] + dist[..., 2]) * stride
        y2 = (cy[None] + dist[..., 3]) * stride
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        all_scores.append(torch.sigmoid(cls.float().reshape(n, h * w)))

        k = kpt.float().reshape(n, h * w, NUM_KPT, 3)
        kx = (k[..., 0] * 2.0 + (cx[None, :, None] - 0.5)) * stride
        ky = (k[..., 1] * 2.0 + (cy[None, :, None] - 0.5)) * stride
        all_kpts.append(torch.stack([kx, ky, torch.sigmoid(k[..., 2])],
                                    dim=-1))
    return (torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1),
            torch.cat(all_kpts, dim=1))


def letterbox(img: np.ndarray, size: int = 640) -> tuple[np.ndarray,
                                                          float, int, int]:
    """ultralytics LetterBox: a fit-preserving resize onto a gray (114)
    canvas, the padding split evenly. Returns (canvas, scale, pad_x,
    pad_y)."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    resized = cv2.resize(img, (nw, nh)) if (nh, nw) != (h, w) else img
    canvas = np.full((size, size, 3), 114, np.uint8)
    top = (size - nh) // 2
    left = (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = resized
    return canvas, r, left, top


class YoloV8FaceDetector:
    """Reference-shaped wrapper: ``detect(images) -> [(bboxes xywh,
    indices)]`` with the last-good-detection fallback, and
    ``detect_with_keypoints`` (5 facial points)."""

    def __init__(self, state_dict: dict,
                 conf_threshold: float = 0.1, nms_threshold: float = 0.5,
                 img_size: int = 640, batch_size: int = 1,
                 device: str | torch.device | None = None):
        """``state_dict``: ultralytics ``model.{i}.*`` keys, loaded
        strictly. ``device``: 'cuda' (default; raises without a GPU) or
        'cpu'."""
        self.device = resolve_device(device)
        model = YoloV8Face()
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.img_size = img_size
        self.batch_size = batch_size
        self.last_detection = None

    @torch.inference_mode()
    def _forward(self, canvases: np.ndarray):
        """(B, S, S, 3) uint8 RGB -> numpy (boxes, scores, kpts); padded to
        ``batch_size``."""
        n = len(canvases)
        if n < self.batch_size:
            canvases = np.concatenate(
                [canvases, np.zeros((self.batch_size - n,) +
                                    canvases.shape[1:], np.uint8)])
        x = torch.from_numpy(canvases).to(self.device).float() / 255.0
        boxes, scores, kpts = decode_outputs(self.model(x))
        return (boxes[:n].cpu().numpy(), scores[:n].cpu().numpy(),
                kpts[:n].cpu().numpy())

    def _detect_raw(self, images):
        canvases, metas = [], []
        for img in images:
            canvas, r, px, py = letterbox(
                np.ascontiguousarray(img[..., ::-1]), self.img_size)
            canvases.append(canvas)
            metas.append((r, px, py, img.shape[1], img.shape[0]))
        results = []
        for start in range(0, len(canvases), self.batch_size):
            chunk = np.stack(canvases[start:start + self.batch_size])
            boxes, scores, kpts = self._forward(chunk)
            for bi in range(len(chunk)):
                r, px, py, w, h = metas[start + bi]
                keep = scores[bi] >= self.conf_threshold
                b, s, k = boxes[bi][keep], scores[bi][keep], kpts[bi][keep]
                dets = np.concatenate([b, s[:, None]], axis=1)
                order = nms_np(dets, self.nms_threshold)
                b, s, k = b[order], s[order], k[order]
                b[:, 0::2] = (b[:, 0::2] - px) / r     # un-letterbox
                b[:, 1::2] = (b[:, 1::2] - py) / r
                k[..., 0] = (k[..., 0] - px) / r
                k[..., 1] = (k[..., 1] - py) / r
                # ultralytics clips boxes and keypoints to the image
                np.clip(b[:, 0::2], 0, w, out=b[:, 0::2])
                np.clip(b[:, 1::2], 0, h, out=b[:, 1::2])
                np.clip(k[..., 0], 0, w, out=k[..., 0])
                np.clip(k[..., 1], 0, h, out=k[..., 1])
                results.append((b, s, k))
        return results

    def detect(self, images):
        """Per image (bboxes (M, 4) x, y, w, h, indices); the previous
        frame's result when nothing is found."""
        out = []
        for b, s, k in self._detect_raw(images):
            if len(b) == 0:
                out.append((np.zeros((0, 4), np.float32), [])
                           if self.last_detection is None
                           else self.last_detection)
                continue
            xywh = np.column_stack([b[:, :2], b[:, 2:] - b[:, :2]])
            cur = (xywh.astype(np.float32), list(range(len(b))))
            self.last_detection = cur
            out.append(cur)
        return out

    def detect_with_keypoints(self, image):
        """(bboxes_xywh (M, 4), indices, kps (M, 5, 2)) for one image."""
        b, s, k = self._detect_raw([image])[0]
        xywh = np.column_stack([b[:, :2], b[:, 2:] - b[:, :2]]).astype(
            np.float32)
        return xywh, list(range(len(b))), k[..., :2].astype(np.float32)
