"""One-shot verification of real checkpoint files against the port's
loaders (counterpart of calipsync_tpu/verify_weights.py):

    python -m calipsync_tpu_torch.cli verify-weights --weights-dir weights/ \\
        [--generator ckpt.pth] [--syncnet syncnet.pth] [--hubert hf_dir/] \\
        [--vgg vgg19-dcbb9e9d.pth] [--lpips-trunk t.pth --lpips-heads h.pth] \\
        [--asr wav2vec2_ctc_dir/] [--device cpu]

For every file present it reads the checkpoint, builds the port's module,
loads the weights into it through a key-tracking wrapper and puts it on
the chosen device (the card unless 'cpu'), and reports: keys consumed /
unconsumed (after the JAX package's allowlists), the loaded module's
parameter count, and any loader error. A module key the file lacks is an
error, as it is a KeyError in the JAX importers.

``status`` and ``keys_unconsumed`` are those of the JAX package's report
on the same file. ``keys_consumed`` and ``imported_params`` are the
port's own counts and may differ from JAX's:

  - ``num_batches_tracked`` is read into the module's buffer (JAX never
    reads it; both allowlist it), so it counts as consumed here;
  - ``imported_params`` counts the floating-point tensors of the loaded
    module's state_dict (parameters and BatchNorm statistics), in the
    torch layout: PFLD's deploy form keeps each folded conv's bias, where
    the JAX tree carries other leaves; HuBERT's weight-norm pair is two
    tensors and ``masked_spec_embed`` one.

Expected weights-dir layout is the reference's
(utils/lip_detector/lip_detector.py:11-14, all_pipeline.py:128-131):
mean_face.txt, sfd_face.pth, checkpoint_epoch_335.pth.tar, and optionally
yolov8n_face_state_dict.pth. ``--asr`` (the slicer's recognizer, which
the port reads without ``transformers``) has no counterpart in the JAX
command.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Callable, Optional

import torch

# Keys the reference itself never loads into compute (the JAX package's
# allowlist).
_COMMON_ALLOW = ("num_batches_tracked",)
# Module keys a file may lack: the BatchNorm step counter (JAX-exported
# files carry none) and SpecAugment's embedding, unused at inference.
_OPTIONAL = ("num_batches_tracked", "masked_spec_embed")


class KeyTracker(Mapping):
    """state_dict wrapper recording which keys a loader reads (a copy of
    the JAX package's)."""

    def __init__(self, sd):
        self._sd = dict(sd)
        self.accessed: set = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return self._sd[k]

    def get(self, k, default=None):
        return self[k] if k in self._sd else default

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def unconsumed(self, allow_substrings=()):
        allow = _COMMON_ALLOW + tuple(allow_substrings)
        return sorted(k for k in self._sd
                      if k not in self.accessed
                      and not any(s in k for s in allow))


def _candidates(key: str) -> tuple:
    """The names a module key may have in a checkpoint: the positional
    conv's weight-norm pair also in HF's newer spelling."""
    for old, new in ((".weight_g", ".parametrizations.weight.original0"),
                     (".weight_v", ".parametrizations.weight.original1")):
        if key.endswith(old):
            return key, key[:-len(old)] + new
    return (key,)


def load_tracked(module: torch.nn.Module, sd: Mapping,
                 rename: Callable[[str], tuple] = _candidates
                 ) -> torch.nn.Module:
    """Read every key of ``module``'s state_dict out of ``sd`` (through the
    names ``rename`` gives, the first present), one by one so that a
    KeyTracker sees which it read, and load them strictly. A key ``sd``
    lacks raises KeyError, but for _OPTIONAL keys, which keep the module's
    own values."""
    state = {}
    for key, own in module.state_dict().items():
        src = next((c for c in rename(key) if c in sd), None)
        if src is not None:
            state[key] = torch.as_tensor(sd[src])
        elif key.endswith(_OPTIONAL):
            state[key] = own
        else:
            raise KeyError(rename(key)[0])
    module.load_state_dict(state, strict=True)
    return module


def _param_count(module: torch.nn.Module) -> int:
    return sum(v.numel() for v in module.state_dict().values()
               if v.is_floating_point())


def _check(name: str, path: str, load_sd: Callable[[], dict],
           importer: Callable[[Mapping], torch.nn.Module], device,
           allow=()) -> dict:
    if not os.path.exists(path):
        return {"artifact": name, "path": path, "status": "missing"}
    try:
        tracked = KeyTracker(load_sd())
        module = importer(tracked).to(device)
        unconsumed = tracked.unconsumed(allow)
        return {
            "artifact": name, "path": path,
            "status": "ok" if not unconsumed else "unconsumed-keys",
            "keys_total": len(tracked),
            "keys_consumed": len(tracked.accessed),
            "keys_unconsumed": unconsumed[:20],
            "imported_params": _param_count(module),
        }
    except Exception as e:  # report, don't abort the sweep
        return {"artifact": name, "path": path, "status": "error",
                "error": f"{type(e).__name__}: {e}"}


def _pfld(sd: Mapping) -> torch.nn.Module:
    """Train-form PFLD read, then folded to the deploy form the port
    runs."""
    from calipsync_tpu_torch.nn.pfld import PFLDGhostOne, fold_mobileone

    train = load_tracked(PFLDGhostOne(), sd)
    deploy = PFLDGhostOne(deploy=True)
    deploy.load_state_dict(fold_mobileone(train.state_dict()), strict=True)
    return deploy


def _vgg_names(key: str) -> tuple:
    """A trunk key ``features.N.x`` as torchvision's vgg19 stores it, or
    bare (``N.x``), as the JAX importer also takes it."""
    return key, key[len("features."):]


def verify_weights(weights_dir: Optional[str] = None,
                   generator: Optional[str] = None,
                   generator_mode: str = "hubert",
                   syncnet: Optional[str] = None,
                   hubert: Optional[str] = None,
                   vgg: Optional[str] = None,
                   lpips_trunk: Optional[str] = None,
                   lpips_heads: Optional[str] = None,
                   asr: Optional[str] = None,
                   device=None) -> list:
    """Run every applicable loader on ``device`` (the card unless 'cpu');
    returns a list of report dicts."""
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.core.weights import load_torch_state_dict

    dev = resolve_device(device)
    reports = []

    if weights_dir:
        mf = os.path.join(weights_dir, "mean_face.txt")
        if os.path.exists(mf):
            try:
                from calipsync_tpu_torch.vision.lip_detector import \
                    load_mean_face

                vals = load_mean_face(mf)
                reports.append({"artifact": "mean_face", "path": mf,
                                "status": "ok",
                                "landmarks": int(vals.shape[0])})
            except Exception as e:
                reports.append({"artifact": "mean_face", "path": mf,
                                "status": "error",
                                "error": f"{type(e).__name__}: {e}"})
        else:
            reports.append({"artifact": "mean_face", "path": mf,
                            "status": "missing"})

        from calipsync_tpu_torch.nn.s3fd import S3FDBackbone

        p = os.path.join(weights_dir, "sfd_face.pth")
        reports.append(_check(
            "s3fd", p, lambda: load_torch_state_dict(p),
            lambda sd: load_tracked(S3FDBackbone(), sd), dev))

        p2 = os.path.join(weights_dir, "checkpoint_epoch_335.pth.tar")
        # 'localization' is an STN branch the reference defines but never
        # calls in forward (pfld_mobileone.py:90)
        reports.append(_check(
            "pfld", p2,
            lambda: load_torch_state_dict(p2, key="pfld_backbone"), _pfld,
            dev, allow=("localization.",)))

        p3 = os.path.join(weights_dir, "yolov8n_face_state_dict.pth")
        if os.path.exists(p3):
            from calipsync_tpu_torch.nn.yolo import YoloV8Face

            reports.append(_check(
                "yolov8n-face", p3, lambda: load_torch_state_dict(p3),
                lambda sd: load_tracked(YoloV8Face(), sd), dev))

    if generator:
        from calipsync_tpu_torch.nn.unet import Generator

        reports.append(_check(
            "generator", generator,
            lambda: load_torch_state_dict(generator),
            lambda sd: load_tracked(Generator(mode=generator_mode), sd),
            dev))

    if syncnet:
        from calipsync_tpu_torch.nn.syncnet import SyncNet

        reports.append(_check(
            "syncnet", syncnet, lambda: load_torch_state_dict(syncnet),
            lambda sd: load_tracked(SyncNet(mode=generator_mode), sd), dev))

    if hubert:
        reports.append(_verify_hf_dir("hubert", hubert, dev))

    if vgg:
        from calipsync_tpu_torch.nn.vgg import VGG19Features

        # torchvision vgg19 ships the classifier head; the reference uses
        # only .features up to conv3_3 (step2_train_unet.py:14-25)
        reports.append(_check(
            "vgg19", vgg, lambda: load_torch_state_dict(vgg),
            lambda sd: load_tracked(VGG19Features(), sd, _vgg_names), dev,
            allow=("classifier.",)))

    if lpips_trunk and lpips_heads:
        from calipsync_tpu_torch.nn.lpips import LPIPS, import_lpips

        def _imp(sd):
            model = LPIPS()
            model.load_state_dict(import_lpips(
                sd, load_torch_state_dict(lpips_heads)), strict=True)
            return model

        reports.append(_check("lpips", lpips_trunk,
                              lambda: load_torch_state_dict(lpips_trunk),
                              _imp, dev, allow=("classifier.",)))

    if asr:
        reports.append(_verify_hf_dir("wav2vec2-ctc", asr, dev))

    return reports


def _verify_hf_dir(name: str, model_dir: str, device) -> dict:
    """A local HF checkpoint directory: ``hubert`` (a HubertModel or
    HubertForCTC, read as the port's extractor reads it) or
    ``wav2vec2-ctc`` (a Wav2Vec2ForCTC, the slicer's recognizer)."""
    if not os.path.isdir(model_dir):
        return {"artifact": name, "path": model_dir, "status": "missing"}
    try:
        from calipsync_tpu_torch.audio.hubert_pipeline import \
            _load_hf_state_dict
        from calipsync_tpu_torch.nn.hubert import HubertConfig, HubertModel

        config = HubertConfig.from_hf(os.path.join(model_dir,
                                                   "config.json"))
        tracked = KeyTracker(_load_hf_state_dict(model_dir))
        if name == "hubert":
            module = HubertModel(config)
        else:
            from calipsync_tpu_torch.audio.asr import Wav2Vec2CTC

            module = Wav2Vec2CTC(config, tracked["lm_head.weight"].shape[0])
        load_tracked(module, tracked).to(device)
        # masked_spec_embed is SpecAugment training state the eval-mode
        # extractor never applies (utils/hubert.py inference path)
        unconsumed = tracked.unconsumed(("masked_spec_embed",))
        return {"artifact": name, "path": model_dir,
                "status": "ok" if not unconsumed else "unconsumed-keys",
                "keys_total": len(tracked),
                "keys_consumed": len(tracked.accessed),
                "keys_unconsumed": unconsumed[:20],
                "imported_params": _param_count(module),
                "hidden_size": config.hidden_size,
                "layers": config.num_hidden_layers}
    except Exception as e:
        return {"artifact": name, "path": model_dir,
                "status": "error", "error": f"{type(e).__name__}: {e}"}
