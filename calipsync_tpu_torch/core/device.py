"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU: it raises when there is none, so a run never
    carries on on the CPU unless the caller asked for ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; "
                               "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
