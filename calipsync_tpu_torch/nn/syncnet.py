"""SyncNet lip-sync evaluator: contrastive audio/face embeddings
(counterpart of calipsync_tpu/nn/syncnet.py; the reference's
module/syncnet.py:110-246).

VGG-ish Conv-BN-ReLU stacks (with identity residuals) encode a 160x160
face crop and a HuBERT (32,32,32) / WeNet (16,32,256) window into
L2-normalised, LeakyReLU'd embeddings; the loss is the BCE of their
cosine similarity (:357-361).

The reference flattens the encoder outputs raw, which leaves the audio
embedding (512*3*3) and the face embedding (512) of different sizes in
hubert mode, so its own trainer cannot run as shipped. ``pool='avg'``
(the default) averages over space first, so both are (B, 512) and
training works; ``pool='flatten'`` is the reference's, for weight-import
parity.

The modules keep the reference ``SyncNet_color`` state_dict keys
(``face_encoder.{i}.conv_block.{0,1}.*``, ``audio_encoder.{i}...``), so a
reference ``.pth`` loads strictly (:func:`load_syncnet`). Inputs are NHWC,
as in the JAX package; BatchNorm in train mode moves its running
statistics as flax's does (momentum 0.9, biased variance;
nn/blocks.py:BatchNorm2d).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from calipsync_tpu_torch.nn.blocks import BatchNorm2d

# (features, kernel, stride, padding, residual)
_FACE_PLAN = (
    (32, 7, 1, 3, False),
    (64, 5, 2, 1, False), (64, 3, 1, 1, True), (64, 3, 1, 1, True),
    (128, 3, 2, 1, False), (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (128, 3, 1, 1, True),
    (256, 3, 2, 1, False), (256, 3, 1, 1, True), (256, 3, 1, 1, True),
    (512, 3, 2, 1, False), (512, 3, 1, 1, True), (512, 3, 1, 1, True),
    (512, 3, 2, 1, False), (512, 3, 1, 0, False), (512, 1, 1, 0, False),
)


def _audio_plan(mode: str):
    p2 = (2, 2) if mode == "hubert" else (1, 2)
    return (
        (256, 3, (1, 1), 1, False), (256, 3, (1, 1), 1, True),
        (256, 3, (1, 1), 1, True),
        (256, 3, p2, 1, False), (256, 3, (1, 1), 1, True),
        (256, 3, (1, 1), 1, True),
        (256, 3, (2, 2), 2, False), (256, 3, (1, 1), 1, True),
        (256, 3, (1, 1), 1, True),
        (512, 3, (2, 2), 1, False), (512, 3, (1, 1), 1, True),
        (512, 3, (1, 1), 1, True),
        (512, 3, (1, 1), 0, False), (512, 1, (1, 1), 0, False),
    )


def audio_channels(mode: str) -> int:
    """Channels of the NHWC audio window: HuBERT (32,32,32), WeNet
    (16,32,256)."""
    if mode not in ("hubert", "wenet"):
        raise ValueError(f"unknown mode: {mode}")
    return 32 if mode == "hubert" else 256


class ConvBNReLU(nn.Module):
    """conv (with bias) -> BN (eps 1e-5) [-> + x] -> ReLU; the reference's
    ``Conv2d`` block, ``conv_block`` = (Conv2d, BatchNorm2d)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride, padding: int,
                 residual: bool = False):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride, padding),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1))
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_block(x)
        if self.residual:
            y = y + x
        return F.relu(y)


def _encoder(plan, cin: int) -> nn.Sequential:
    layers = []
    for f, k, s, p, res in plan:
        layers.append(ConvBNReLU(cin, f, k, s, p, residual=res))
        cin = f
    return nn.Sequential(*layers)


class SyncNet(nn.Module):
    """forward(face (B,160,160,3), audio NHWC window) ->
    (audio_embedding, face_embedding) in the parameters' dtype (fp32)."""

    def __init__(self, mode: str = "hubert", pool: str = "avg"):
        super().__init__()
        if pool not in ("avg", "flatten"):
            raise ValueError(f"unknown pool: {pool}")
        self.mode = mode
        self.pool = pool
        self.face_encoder = _encoder(_FACE_PLAN, 3)
        self.audio_encoder = _encoder(_audio_plan(mode), audio_channels(mode))

    def _embed(self, encoder: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        dtype = encoder[0].conv_block[0].weight.dtype  # fp32 unless cast
        x = encoder(x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last))
        if self.pool == "avg":
            x = x.mean(dim=(2, 3))
        else:  # the reference's: torch flattens in NCHW order
            x = x.flatten(1)
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return F.leaky_relu(x, 0.01)

    def forward(self, face: torch.Tensor, audio: torch.Tensor):
        return (self._embed(self.audio_encoder, audio),
                self._embed(self.face_encoder, face))


def cosine_bce_loss(audio_emb: torch.Tensor, face_emb: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """BCE(cosine_similarity(a, v), y) (reference :357-361)."""
    a = audio_emb / audio_emb.norm(dim=1, keepdim=True).clamp_min(1e-8)
    v = face_emb / face_emb.norm(dim=1, keepdim=True).clamp_min(1e-8)
    d = (a * v).sum(dim=1).clamp(1e-7, 1 - 1e-7)
    y = y.reshape(-1)
    return -(y * torch.log(d) + (1 - y) * torch.log(1 - d)).mean()


def load_syncnet(path_or_state_dict, mode: str = "hubert",
                 device=None) -> SyncNet:
    """A reference ``SyncNet_color`` .pth (a bare state_dict or one wrapped
    as ``{'state_dict': ...}``), or such a state_dict, -> :class:`SyncNet`
    loaded strictly, in eval mode, on ``device`` (default the GPU,
    ``resolve_device``)."""
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.core.weights import load_torch_state_dict

    sd = (load_torch_state_dict(path_or_state_dict)
          if isinstance(path_or_state_dict, str) else path_or_state_dict)
    model = SyncNet(mode=mode)
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).eval()


def random_syncnet(mode: str = "hubert",
                   device: Optional[str] = None) -> SyncNet:
    """A SyncNet of torch's default initialisation from seed 0 (no trained
    SyncNet weights are in the repository), in eval mode."""
    from calipsync_tpu_torch.core.device import resolve_device

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SyncNet(mode=mode)
    return model.to(resolve_device(device)).eval()
