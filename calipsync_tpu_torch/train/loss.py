"""Training losses: L1 + weighted VGG19 perceptual (counterpart of
calipsync_tpu/train/loss.py; the reference's step2_train_unet.py:79,110-112):
total = L1(pred, label) + 0.1 * MSE(vgg(pred), vgg(label)), the label's
features detached, VGG19 cut at conv3_3 and fed raw [0, 1] RGB.
"""

from __future__ import annotations

from typing import Optional

import torch

from calipsync_tpu_torch.nn.vgg import VGG19Features


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def perceptual_loss(vgg: VGG19Features, pred: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """MSE between the trunk's features of pred and target, in fp32; the
    trunk computes in its own ``dtype``."""
    f_pred = vgg(pred)
    with torch.no_grad():
        f_target = vgg(target)
    return (f_pred.float() - f_target.float()).square().mean()


def generator_loss(pred: torch.Tensor, target: torch.Tensor,
                   vgg: Optional[VGG19Features] = None,
                   perceptual_weight: float = 0.1
                   ) -> tuple[torch.Tensor, dict]:
    """Total loss and its terms (``loss``, ``loss_pixel`` and, with a
    trunk and a positive weight, ``loss_perceptual``), 0-d tensors."""
    pix = l1_loss(pred, target)
    metrics = {"loss_pixel": pix}
    total = pix
    if vgg is not None and perceptual_weight > 0:
        per = perceptual_loss(vgg, pred, target)
        metrics["loss_perceptual"] = per
        total = total + perceptual_weight * per
    metrics["loss"] = total
    return total, metrics
