"""Output-fidelity evaluation: PSNR, perceptual distances, lip-sync scores
and the generator parity harness (counterpart of calipsync_tpu/eval.py).

  - :func:`psnr` / :func:`batch_psnr` on uint8 or [0,1] float frames
  - :func:`vgg_distance`: an LPIPS-style distance on the VGG19-conv3_3
    features the training loss uses (normalised MSE in feature space)
  - :func:`lpips_distance` / :func:`make_default_lpips`: the real LPIPS
    (nn/lpips.py)
  - :func:`sync_metrics`: LSE-C / LSE-D of a SyncNet offset scan
  - :func:`generator_parity_report`: the port's generator against a
    reference-layout torch generator on the same inputs and weights

The networks run on the device their parameters are on.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean(np.square(a - b)))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def batch_psnr(a: np.ndarray, b: np.ndarray,
               data_range: float = 255.0) -> np.ndarray:
    """Per-frame PSNR over the leading dim."""
    return np.asarray([psnr(x, y, data_range) for x, y in zip(a, b)])


def _device_of(model: torch.nn.Module) -> torch.device:
    """Where ``model``'s parameters are (the CPU for a module without
    any)."""
    p = next(model.parameters(), None)
    return torch.device("cpu") if p is None else p.device


def _to01(x, device) -> torch.Tensor:
    """uint8 or [0,1] float frames -> fp32 [0,1] on ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(x)).to(device)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


@torch.inference_mode()
def vgg_distance(vgg: torch.nn.Module, a, b) -> float:
    """Perceptual distance in VGG19-conv3_3 feature space ([0,1] RGB NHWC
    inputs; ``vgg`` a :class:`calipsync_tpu_torch.nn.vgg.VGG19Features`);
    lower is closer."""
    dev = _device_of(vgg)
    fa = vgg(torch.as_tensor(np.asarray(a, np.float32)).to(dev)).float()
    fb = vgg(torch.as_tensor(np.asarray(b, np.float32)).to(dev)).float()
    fa = fa / (fa.norm(dim=-1, keepdim=True) + 1e-10)
    fb = fb / (fb.norm(dim=-1, keepdim=True) + 1e-10)
    return float((fa - fb).square().mean())


@torch.inference_mode()
def lpips_distance(model: torch.nn.Module, a, b) -> np.ndarray:
    """Real LPIPS (Zhang et al. 2018) between two NHWC RGB [0,1] or uint8
    frame batches -> per-frame distances (B,). ``model`` an
    :class:`calipsync_tpu_torch.nn.lpips.LPIPS` with imported weights
    (``nn.lpips.load_lpips``) or from :func:`make_default_lpips`."""
    dev = _device_of(model)
    return model(_to01(a, dev), _to01(b, dev)).cpu().numpy()


def make_default_lpips(net: str = "vgg", seed: int = 0, device=None):
    """An LPIPS module without external weights: a seeded random trunk
    (random deep features are a usable perceptual proxy) and uniform 1/C
    heads (plain unit-normalised feature MSE per tap), in eval mode on
    ``device`` (default the GPU). Replace with imported weights when
    available."""
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.nn.lpips import LPIPS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LPIPS(net)
    with torch.no_grad():
        for k in range(5):
            w = getattr(model, f"lin{k}").model[1].weight
            w.fill_(1.0 / w.shape[1])
    return model.to(resolve_device(device)).eval().requires_grad_(False)


@torch.inference_mode()
def sync_metrics(model: torch.nn.Module, crops, features,
                 mode: str = "hubert", max_offset: int = 15,
                 batch: int = 64) -> dict:
    """LSE-style audio/visual sync scoring via a SyncNet offset scan.

    The standard SyncNet protocol (Chung & Zisserman; Wav2Lip's LSE-D /
    LSE-C): embed every frame and its audio window once, then scan integer
    frame offsets ``o`` in [-max_offset, max_offset] —

        sim(o) = mean_i cos(face_emb[i], audio_emb[i + o])

    Args:
      model: a :class:`calipsync_tpu_torch.nn.syncnet.SyncNet` (or any
        module (faces, windows) -> (audio_emb, face_emb)), in eval mode.
      crops: (N, 160, 160, 3) uint8/float mouth crops, the generator's
        output convention (BGR [0,1] after /255).
      features: (T, 2, 1024) HuBERT rows (or WeNet rows); frame i's window
        is taken exactly as training does (audio/windows.py).

    Returns a dict with av_offset_frames (the argmax offset; positive =
    audio leads video), lse_c (sim(best) - the median over the scan),
    lse_d (1 - sim(best)), sim_at_zero and sim_best. Batches are not
    padded: the embeddings in eval mode do not depend on the batch.
    """
    from calipsync_tpu_torch.audio.windows import batched_windows

    crops = np.asarray(crops)
    n = len(crops)
    dev = _device_of(model)
    feats = torch.as_tensor(np.asarray(features, np.float32)).to(dev)
    a_parts, f_parts = [], []
    for start in range(0, n, batch):
        idx = torch.arange(start, min(start + batch, n), device=dev)
        windows = batched_windows(feats, idx, mode=mode)
        a_emb, f_emb = model(_to01(crops[start:start + batch], dev),
                             windows)
        a_parts.append(a_emb.double().cpu().numpy())
        f_parts.append(f_emb.double().cpu().numpy())
    a = np.concatenate(a_parts)
    f = np.concatenate(f_parts)
    a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)

    offsets = np.arange(-max_offset, max_offset + 1)
    sims = np.full(len(offsets), -np.inf)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if hi - lo < 1:
            continue
        sims[k] = float(np.mean(np.sum(f[lo:hi] * a[lo + o:hi + o],
                                       axis=1)))
    best = int(np.argmax(sims))
    finite = sims[np.isfinite(sims)]
    return {
        "n_frames": n,
        "av_offset_frames": int(offsets[best]),
        "sim_best": round(float(sims[best]), 6),
        "sim_at_zero": round(float(sims[max_offset]), 6),
        "lse_c": round(float(sims[best] - np.median(finite)), 6),
        "lse_d": round(float(1.0 - sims[best]), 6),
    }


def _generator_config(sd: dict) -> tuple:
    """(mode, n_blocks) of a reference-layout generator state_dict."""
    mode = "hubert" if "audio_model.bn7.weight" in sd else "wenet"
    n_blocks = len({k.split(".")[1] for k in sd
                    if k.startswith("attention_blocks.")})
    return mode, n_blocks


@torch.no_grad()
def generator_parity_report(reference_torch_model: torch.nn.Module,
                            batch: int = 2, seed: int = 0,
                            dtype: torch.dtype = torch.float32,
                            device=None) -> dict:
    """The same weights and inputs through a reference-layout generator and
    the port's.

    ``reference_torch_model`` is any torch module with the reference
    generator's keys: the reference ``Model`` (NCHW inputs and output), or
    a port :class:`~calipsync_tpu_torch.nn.unet.Generator` (NHWC) standing
    in for it. It runs where its parameters are, in eval mode. Its
    counterpart is the port's ``Generator(dtype=dtype)`` loaded strictly
    from its state_dict, on ``device`` (default the GPU), through the
    kernels. Returns {'psnr_db', 'max_abs_err', 'mean_abs_err'} over the
    sigmoid outputs scaled to [0, 255]: fp32 should exceed 60 dB; bf16
    gives the serving-precision cost.
    """
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.nn.unet import Generator

    rng = np.random.default_rng(seed)
    x = rng.random((batch, 6, 160, 160), dtype=np.float32)
    a = rng.standard_normal((batch, 32, 32, 32)).astype(np.float32)

    ref_model = reference_torch_model.eval()
    ref_dev = _device_of(ref_model)
    xt, at = (torch.from_numpy(v).to(ref_dev) for v in (x, a))
    if isinstance(ref_model, Generator):
        ref = ref_model(xt.permute(0, 2, 3, 1), at.permute(0, 2, 3, 1))
        ref = ref.permute(0, 3, 1, 2)
    else:
        ref = ref_model(xt, at)
    ref = ref.float().cpu().numpy()

    sd = {k: v.detach().cpu() for k, v in ref_model.state_dict().items()}
    mode, n_blocks = _generator_config(sd)
    dev = resolve_device(device)
    model = Generator(mode=mode, n_blocks=n_blocks, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    model = model.to(dev).eval()
    ours = model(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(dev),
                 torch.from_numpy(a.transpose(0, 2, 3, 1)).to(dev))
    ours = ours.float().cpu().numpy().transpose(0, 3, 1, 2)

    err = np.abs(ours - ref) * 255.0
    return {"psnr_db": psnr(ours * 255.0, ref * 255.0),
            "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean())}
