"""Synthetic speaker assets for benchmarks and smoke runs (own copy of
``make_synthetic_speaker`` in the repository's root bench.py, and the
step-1 training layout), so a run of the port needs nothing outside this
package."""

import os

import cv2
import numpy as np


def _speaker_frames(n_frames: int, h: int, w: int,
                    rng: np.random.Generator):
    """Yield (frame, landmarks) pairs: a gradient background with mild
    texture, a face ellipse with a mouth, and 110 landmarks whose points
    1, 31 and 52 bound the mouth box and whose first 33 outline the face.
    Structured frames compress and decode like real video frames; random
    noise would make JPEG decode pathologically slow and large."""
    yy = np.linspace(40, 200, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 55, w, dtype=np.float32)[None, :]
    ch = yy + xx
    base = np.stack([ch, np.broadcast_to(yy * 0.8 + 30, ch.shape),
                     np.broadcast_to(230 - xx, ch.shape)], -1)
    for _ in range(n_frames):
        img = base + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
        img = np.clip(img, 0, 255).astype(np.uint8)
        xmin = w // 4 + int(rng.integers(-8, 8))
        width = w // 3 + int(rng.integers(-10, 10))
        ymin = h // 2 + int(rng.integers(-8, 8))
        cx, cy = xmin + width // 2, ymin + width // 2
        cv2.ellipse(img, (cx, cy), (width // 2, int(width * 0.6)),
                    0, 0, 360, (150, 170, 210), -1)
        cv2.ellipse(img, (cx, cy + width // 4), (width // 5, width // 8),
                    0, 0, 360, (90, 90, 160), -1)
        lms = np.zeros((110, 2), np.int64)
        theta = np.linspace(0, 2 * np.pi, 33, endpoint=False)
        lms[:33, 0] = (cx + 0.45 * width * np.cos(theta)).astype(np.int64)
        lms[:33, 1] = (cy + 0.45 * width * np.sin(theta)).astype(np.int64)
        lms[33:] = rng.integers(xmin, xmin + width, (77, 2))
        lms[1] = (xmin, cy)
        lms[31] = (xmin + width, cy)
        lms[52] = (cx, ymin)
        yield img, lms


def make_synthetic_speaker(root: str, n_frames: int = 40,
                           res: int = 480, res_w: int = None,
                           seed: int = 42) -> str:
    """Synthetic step3 assets (``infer_data``: frames, positions) of
    structured frames. ``res`` is the frame height, ``res_w`` the width
    (default square)."""
    h, w = res, res_w or res
    infer = os.path.join(root, "infer_data")
    for d in ("frames", "positions", "lips_jpg", "masks"):
        os.makedirs(os.path.join(infer, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (img, lms) in enumerate(_speaker_frames(n_frames, h, w, rng)):
        n = str(i).zfill(6)
        cv2.imwrite(os.path.join(infer, "frames", f"{n}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        np.savetxt(os.path.join(infer, "positions", f"{n}.txt"), lms)
    return infer


def make_synthetic_step1(root: str, n_frames: int = 250, res: int = 480,
                         seed: int = 42) -> str:
    """Synthetic step-1 training data, the layout ``data/dataset.py``
    reads: ``full_body_img/{i}.jpg`` (structured frames, as
    :func:`make_synthetic_speaker`'s), ``landmarks/{i}.lms`` (110 points)
    and ``aud_hu.npy``, (n_frames + 1, 2, 1024) fp32 HuBERT rows made from
    ``seed``. Returns ``root``."""
    for d in ("full_body_img", "landmarks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (img, lms) in enumerate(_speaker_frames(n_frames, res, res,
                                                   rng)):
        cv2.imwrite(os.path.join(root, "full_body_img", f"{i}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        np.savetxt(os.path.join(root, "landmarks", f"{i}.lms"), lms,
                   fmt="%d")
    np.save(os.path.join(root, "aud_hu.npy"),
            rng.standard_normal((n_frames + 1, 2, 1024)).astype(np.float32))
    return root


def make_synthetic_video(path: str, n_frames: int = 250, res: int = 480,
                         fps: int = 25, seed: int = 42) -> str:
    """A talking-head stand-in for steps 1 and 3: ``n_frames`` structured
    frames (:func:`make_synthetic_speaker`'s face and mouth) as an mp4v
    ``path`` at ``fps``, and a 16 kHz wav side-car of the same length
    beside it (``path`` with .wav; cv2 cannot demux audio): three gliding
    tones at a syllable-rate envelope with noise, made from ``seed``.
    Returns ``path``."""
    from calipsync_tpu_torch.audio.io import save_wav

    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (res, res))
    if not vw.isOpened():
        raise RuntimeError(f"cannot open a video writer for {path}")
    for img, _ in _speaker_frames(n_frames, res, res, rng):
        vw.write(img)
    vw.release()
    t = np.arange(16_000 * n_frames // fps) / 16_000
    wav = np.zeros_like(t)
    for _ in range(3):
        f0, glide = rng.uniform(100, 900), rng.uniform(-40, 40)
        wav += rng.uniform(0.05, 0.2) * np.sin(
            2 * np.pi * (f0 * t + glide * t * t / 2) + rng.uniform(0, 6))
    wav *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
    wav += rng.standard_normal(t.shape) * 0.01
    save_wav(os.path.splitext(path)[0] + ".wav", wav.astype(np.float32),
             16_000)
    return path


def mean_face(seed: int = 0) -> np.ndarray:
    """A (220,) normalized landmark template shaped as the synthetic
    speaker's: a 33-point face outline, points 1 and 31 bounding the
    mouth box at mid-height, point 52 on its top edge, the rest inside."""
    rng = np.random.default_rng(seed)
    lms = np.zeros((110, 2), np.float32)
    theta = np.linspace(0, 2 * np.pi, 33, endpoint=False)
    lms[:33, 0] = 0.5 + 0.3 * np.cos(theta)
    lms[:33, 1] = 0.55 + 0.3 * np.sin(theta)
    lms[33:] = rng.uniform(0.3, 0.7, (77, 2))
    lms[1] = (0.25, 0.62)
    lms[31] = (0.75, 0.62)
    lms[52] = (0.5, 0.45)
    return lms.reshape(-1)


def random_state_dict(module, seed: int, scale: float = 1.0) -> dict:
    """``module``'s state_dict with seeded random values: conv and linear
    weights N(0, scale^2 * 2/fan_in), biases and BN shifts N(0, 0.01),
    BN scales U(0.5, 1.5), running means N(0, 0.1), running variances
    U(0.5, 1.5); integer buffers kept."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point() or k.endswith("dfl.conv.weight"):
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("running_mean"):
            out[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.dim() == 1 and k.endswith("weight"):   # BN / L2Norm scale
            out[k] = (torch.rand(v.shape, generator=g) + 0.5) * v.abs().max()
        elif v.dim() == 1:
            out[k] = torch.randn(v.shape, generator=g) * 0.01
        else:
            fan_in = v[0].numel()
            out[k] = torch.randn(v.shape, generator=g) * (
                scale * (2.0 / fan_in) ** 0.5)
    return out


def random_pfld_state(seed: int = 0) -> dict:
    """A seeded train-form PFLD state_dict (``pfld_backbone``'s keys)
    whose landmarks stay near the mean face: at 0.3 of He's scale the
    signal keeps its size through the multi-branch blocks (at 1.0 it grows
    ~14x a block); the output layer is scaled to 5% and its bias set so
    that the mean residual over 8 seeded random crops is zero."""
    import torch

    from calipsync_tpu_torch.nn.pfld import PFLDGhostOne

    net = PFLDGhostOne().eval()
    sd = random_state_dict(net, seed, scale=0.3)
    sd["conv_out.weight"] *= 0.05
    net.load_state_dict(sd)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        sd["conv_out.bias"] -= net(torch.rand(8, 192, 192, 3,
                                              generator=g)).mean(0)
    return sd


def write_face_weights(weights_dir: str, seed: int = 0,
                       yolo: bool = False) -> str:
    """Seeded face models in the reference's weights layout, for runs
    without the real files: ``mean_face.txt`` (:func:`mean_face`),
    ``sfd_face.pth`` (S3FD), ``checkpoint_epoch_335.pth.tar`` (PFLD, train
    form under ``pfld_backbone``) and, with ``yolo``,
    ``yolov8n_face_state_dict.pth``.

    Random weights find no face, so S3FD is arranged to fire on every
    frame: its box and score heads' weights are zero, its face-class bias
    is +4 on the third source map (64-pixel priors at stride 16 of the
    scaled frame) and -10 on the others, so every prior of that map scores
    0.982 and the boxes are those priors. YOLO is arranged the same way:
    the last convs of its box and class branches are zero, the class bias
    +4 at stride 16 and -10 at strides 8 and 32, so every stride-16 anchor
    scores 0.982 with uniform DFL bins, a box of 15 strides (240 pixels of
    the 640 letterbox) around it. PFLD is :func:`random_pfld_state`: its
    landmarks move with the crop by a few pixels around the mean face.
    Returns ``weights_dir``."""
    import torch

    from calipsync_tpu_torch.nn.s3fd import S3FDBackbone
    from calipsync_tpu_torch.nn.yolo import YoloV8Face

    os.makedirs(weights_dir, exist_ok=True)
    np.savetxt(os.path.join(weights_dir, "mean_face.txt"),
               mean_face(seed)[None], fmt="%.6f")
    s3fd = random_state_dict(S3FDBackbone(), seed)
    for k in range(6):
        for head in ("loc", "conf"):
            s3fd[f"{head}.{k}.weight"].zero_()
            s3fd[f"{head}.{k}.bias"].zero_()
        s3fd[f"conf.{k}.bias"][-1] = 4.0 if k == 2 else -10.0
    torch.save(s3fd, os.path.join(weights_dir, "sfd_face.pth"))
    torch.save({"pfld_backbone": random_pfld_state(seed + 1)},
               os.path.join(weights_dir, "checkpoint_epoch_335.pth.tar"))
    if yolo:
        sd = random_state_dict(YoloV8Face(), seed + 2)
        for k in range(3):
            for branch in ("cv2", "cv3"):
                sd[f"model.22.{branch}.{k}.2.weight"].zero_()
                sd[f"model.22.{branch}.{k}.2.bias"].zero_()
            sd[f"model.22.cv3.{k}.2.bias"].fill_(4.0 if k == 1 else -10.0)
        torch.save(sd, os.path.join(weights_dir,
                                    "yolov8n_face_state_dict.pth"))
    return weights_dir


def write_eval_weights(weights_dir: str, seed: int = 0) -> dict:
    """Seeded evaluation networks in the reference layouts, for runs where
    no trained weights exist: ``syncnet.pth`` (``SyncNet_color``'s keys,
    hubert mode), and for LPIPS ``vgg16.pth`` / ``alexnet.pth``
    (torchvision ``features.N.*``) with ``lpips_vgg.pth`` /
    ``lpips_alex.pth`` (the lpips package's ``lin{k}.model.1.weight``,
    non-negative as in the released heads). Returns {name: path}."""
    import torch

    from calipsync_tpu_torch.nn.lpips import LPIPS
    from calipsync_tpu_torch.nn.syncnet import SyncNet

    os.makedirs(weights_dir, exist_ok=True)
    paths = {"syncnet": os.path.join(weights_dir, "syncnet.pth")}
    torch.save(random_state_dict(SyncNet(), seed), paths["syncnet"])
    for net, trunk_file in (("vgg", "vgg16.pth"), ("alex", "alexnet.pth")):
        sd = random_state_dict(LPIPS(net), seed + 1)
        trunk = {k[len("trunk."):]: v for k, v in sd.items()
                 if k.startswith("trunk.")}
        heads = {k: v.abs() for k, v in sd.items() if k.startswith("lin")}
        paths[f"{net}_trunk"] = os.path.join(weights_dir, trunk_file)
        paths[f"{net}_heads"] = os.path.join(weights_dir, f"lpips_{net}.pth")
        torch.save(trunk, paths[f"{net}_trunk"])
        torch.save(heads, paths[f"{net}_heads"])
    return paths


SYNC_PLANT_SHIFT = 3  # frames the planted audio leads the video


def planted_sync(state_dict: dict, face: np.ndarray, n: int) -> tuple:
    """A clip with an A/V shift planted in it, and SyncNet weights (hubert,
    avg pool) that see it: (state_dict, crops (n,160,160,3) uint8,
    features (n,2,1024) fp32).

    Frame i shows ``face`` (a 160x160x3 uint8 crop) or its negative by a
    seeded coin ``cls[i + SYNC_PLANT_SHIFT]``; feature row j is one of two
    seeded rows by ``cls[j]``, so the audio leads the video by
    SYNC_PLANT_SHIFT frames. Seeded random weights map every input to
    nearly one embedding (an offset scan over real crops is flat to
    ~1e-5), so ``state_dict`` is arranged: the audio encoder's first conv
    reads only the window's centre row (channels 16-17,
    audio/windows.py), and each encoder's last 1x1 conv becomes the
    rank-one u v^T, v the difference of that encoder's penultimate
    features (mean over space) between its two inputs, u a seeded +-1
    pattern shared by both encoders, its bias and BatchNorm set so that
    the two inputs land on the two halves of u. The planted offset then
    scores ~1 and the others ~0.5. Seed 0."""
    import torch

    from calipsync_tpu_torch.nn.syncnet import load_syncnet

    rng = np.random.default_rng(0)
    cls = rng.integers(0, 2, n + SYNC_PLANT_SHIFT)
    rows = rng.standard_normal((2, 2, 1024)).astype(np.float32)
    faces = np.stack([face, 255 - face])
    sd = dict(state_dict)
    first = "audio_encoder.0.conv_block.0.weight"
    centre = torch.zeros(sd[first].shape[1])
    centre[16:18] = 1.0
    sd[first] = sd[first] * centre[:, None, None]
    net = load_syncnet(sd, device="cpu")
    u = torch.from_numpy(rng.permutation(np.repeat([1.0, -1.0], 256)))
    windows = torch.zeros(2, 32, 32, 32)
    windows[..., 16:18] = torch.from_numpy(rows).reshape(
        2, 2, 32, 32).permute(0, 2, 3, 1)
    for name, x in (("face_encoder", torch.from_numpy(faces) / 255.0),
                    ("audio_encoder", windows)):
        enc = getattr(net, name)
        with torch.no_grad():
            p = enc[:-1](x.float().permute(0, 3, 1, 2)).mean(dim=(2, 3))
        v = p[1] - p[0]
        last = f"{name}.{len(enc) - 1}.conv_block"
        half = float(v @ v) / 2
        sd[f"{last}.0.weight"] = (u.float()[:, None] * v)[..., None, None]
        sd[f"{last}.0.bias"] = -u.float() * float(v @ (p[0] + p[1]) / 2)
        sd[f"{last}.1.weight"] = torch.ones(512)
        sd[f"{last}.1.bias"] = torch.zeros(512)
        sd[f"{last}.1.running_mean"] = torch.zeros(512)
        sd[f"{last}.1.running_var"] = torch.full((512,), half ** 2)
    return sd, faces[cls[SYNC_PLANT_SHIFT:]], rows[cls[:n]]


# The public facebook/wav2vec2-base-960h vocabulary, ids in order.
CTC_VOCAB = ("<pad>", "<s>", "</s>", "<unk>", "|", "E", "T", "A", "O", "N",
             "I", "H", "S", "R", "D", "L", "U", "M", "W", "C", "F", "G", "Y",
             "P", "B", "V", "K", "'", "X", "J", "Q", "Z")


def write_ctc_dir(path: str, seed: int = 0, config=None) -> str:
    """A seeded HF ``Wav2Vec2ForCTC`` directory, for runs without a trained
    recognizer: ``config.json``, ``pytorch_model.bin`` (``torch.save``, so
    a host without safetensors reads it), ``vocab.json``,
    ``tokenizer_config.json`` / ``special_tokens_map.json`` (``<pad>`` the
    blank, ``|`` the word delimiter) and ``preprocessor_config.json``
    (``do_normalize``). By default shaped as the public
    facebook/wav2vec2-base-960h: hidden 768, 12 layers of 12 heads,
    intermediate 3072, the 'group' extractor without conv biases,
    post-LN, a 32-token vocabulary. The trunk is
    ``core.weights.random_jax_hubert(config, seed)``; the head N(0,
    1/hidden). Returns ``path``."""
    import json

    import torch

    from calipsync_tpu_torch.core.weights import (from_jax_wav2vec2_ctc,
                                                  random_jax_hubert)
    from calipsync_tpu_torch.nn.hubert import HubertConfig

    config = config or HubertConfig.base()
    vocab = CTC_VOCAB
    rng = np.random.default_rng(seed + 1)
    head = {"kernel": (rng.standard_normal((config.hidden_size, len(vocab)))
                       * config.hidden_size ** -0.5).astype(np.float32),
            "bias": np.zeros(len(vocab), np.float32)}
    sd = from_jax_wav2vec2_ctc(random_jax_hubert(config, seed), head, config)
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    cfg = {f: (list(v) if isinstance(v, tuple) else v)
           for f, v in vars(config).items()}
    cfg.update(model_type="wav2vec2", architectures=["Wav2Vec2ForCTC"],
               vocab_size=len(vocab), pad_token_id=vocab.index("<pad>"),
               bos_token_id=1, eos_token_id=2, hidden_act="gelu",
               feat_extract_activation="gelu", layerdrop=0.0,
               ctc_loss_reduction="sum")
    files = {
        "config.json": cfg,
        "vocab.json": {t: i for i, t in enumerate(vocab)},
        "tokenizer_config.json": {
            "tokenizer_class": "Wav2Vec2CTCTokenizer", "pad_token": "<pad>",
            "unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
            "word_delimiter_token": "|", "do_lower_case": False},
        "special_tokens_map.json": {"pad_token": "<pad>",
                                    "unk_token": "<unk>",
                                    "bos_token": "<s>", "eos_token": "</s>"},
        "preprocessor_config.json": {
            "feature_extractor_type": "Wav2Vec2FeatureExtractor",
            "feature_size": 1, "sampling_rate": 16000, "padding_value": 0.0,
            "do_normalize": True, "return_attention_mask": False}}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f, indent=1)
    return path


def speech_like_wav(seconds: float, seed: int) -> np.ndarray:
    """Bursts of 0.6-2.4 s of amplitude-modulated tone mixtures (a few
    partials gliding in pitch, syllable-rate envelope) between silences of
    0.6-1.4 s, starting with a silence: what a slicer and a recognizer see
    as phrases and pauses, at 16 kHz. The silences are exact zeros, so
    every frame of one maps to the same features."""
    sample_rate = 16_000
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    wav = np.zeros(n, np.float64)
    t0 = rng.uniform(0.6, 1.4)
    while t0 < seconds - 0.6:
        dur = min(rng.uniform(0.6, 2.4), seconds - t0)
        s, e = int(t0 * sample_rate), int((t0 + dur) * sample_rate)
        t = np.arange(e - s) / sample_rate
        burst = np.zeros_like(t)
        for _ in range(3):
            f0, glide = rng.uniform(120, 900), rng.uniform(-60, 60)
            burst += rng.uniform(0.05, 0.25) * np.sin(
                2 * np.pi * (f0 * t + glide * t * t / 2)
                + rng.uniform(0, 6))
        burst *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
        wav[s:e] = burst * np.sin(np.pi * t / dur) ** 0.25
        t0 += dur + rng.uniform(0.6, 1.4)
    return wav.astype(np.float32)


def _widest_gap(values: np.ndarray, lo: float, hi: float) -> float:
    """The midpoint of the widest gap between consecutive sorted values in
    [lo, hi] (the ends counted as values)."""
    v = np.sort(np.concatenate([[lo, hi],
                                values[(values > lo) & (values < hi)]]))
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2)


CTC_PLANTED_LETTERS = ("E", "T")


def planted_ctc(model_dir: str, audio: np.ndarray) -> dict:
    """Arrange the head of the seeded recognizer in ``model_dir`` (from
    :func:`write_ctc_dir`) so that its greedy decode of ``audio`` (16 kHz)
    holds words and gaps with wide margins, and write it back. Seeded
    random weights decode noise: near-ties between classes flip with the
    last bits of the logits, and an all-blank scan shows nothing.

    On the CPU, the trunk's last states h of the clip are projected on u,
    the unit difference of their means over loud and quiet frames (frame
    RMS over the conv stack's 400-sample window); p = u.(h - m), m the
    midpoint of those means. Two thresholds cut p: t1 in the widest gap of
    p between its medians over the quiet and the loud frames, t2 in the
    widest gap of the p above t1 that leaves a tenth of them on each
    side. With the letters of CTC_PLANTED_LETTERS, the head then scores
    the word delimiter 0, the first letter s (p - t1), the second s (2p -
    t1 - t2) and every other token -4 s (max p - min p): the delimiter
    wins below t1, the first letter between t1 and t2, the second above
    t2, and a frame's margin between its top two logits is s times its
    distance to the nearer threshold. s = 10 / std(p). Returns {'min_margin':
    that least margin over the clip, 'thresholds': (t1, t2), 'scale': s,
    'logits': the planted recognizer's CPU logits of the clip (its head
    on the states above, as its forward computes it)}.
    """
    import json

    import torch

    from calipsync_tpu_torch.audio.asr import load_hf_ctc_checkpoint
    from calipsync_tpu_torch.audio.hubert_pipeline import _load_hf_state_dict

    rec = load_hf_ctc_checkpoint(model_dir, device="cpu")
    h32 = rec.hidden_states(audio)
    h = h32.astype(np.float64)
    frames = len(h)
    x = np.asarray(audio, np.float64)
    rms = np.array([np.sqrt(np.mean(x[320 * t:320 * t + 400] ** 2))
                    for t in range(frames)])
    loud = rms > 0.5 * np.median(rms[rms > np.percentile(rms, 75)])
    hi, lo = h[loud].mean(0), h[~loud].mean(0)
    u = (hi - lo) / np.linalg.norm(hi - lo)
    mid = (hi + lo) / 2
    p = (h - mid) @ u
    t1 = _widest_gap(p, np.median(p[~loud]), np.median(p[loud]))
    above = np.sort(p[p > t1])
    t2 = _widest_gap(p, above[len(above) // 10], above[-len(above) // 10])
    s = 10.0 / p.std()
    vocab = json.loads(open(os.path.join(model_dir, "vocab.json")).read())
    with open(os.path.join(model_dir, "config.json")) as f:
        n_vocab = json.load(f)["vocab_size"]
    w = np.zeros((n_vocab, len(u)))
    b = np.full(n_vocab, -4 * s * (p.max() - p.min()))
    b[vocab[rec.word_delimiter]] = 0.0
    for letter, slope, cut in zip(CTC_PLANTED_LETTERS, (1, 2),
                                  (t1, t1 + t2)):
        w[vocab[letter]] = s * slope * u
        b[vocab[letter]] = -s * (slope * (u @ mid) + cut)
    sd = _load_hf_state_dict(model_dir)
    sd["lm_head.weight"] = torch.from_numpy(w.astype(np.float32))
    sd["lm_head.bias"] = torch.from_numpy(b.astype(np.float32))
    torch.save(sd, os.path.join(model_dir, "pytorch_model.bin"))
    margin = s * np.minimum(np.abs(p - t1), np.abs(p - t2)).min()
    logits = torch.nn.functional.linear(torch.from_numpy(h32)[None],
                                        sd["lm_head.weight"],
                                        sd["lm_head.bias"])[0].numpy()
    return {"min_margin": float(margin), "thresholds": (float(t1), float(t2)),
            "scale": float(s), "logits": logits}
