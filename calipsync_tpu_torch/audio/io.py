"""Host audio IO: wav decode, polyphase resampling, A/V mux (own copy of
calipsync_tpu/audio/io.py).

wav files decode natively (scipy) and resample with
``scipy.signal.resample_poly`` (a polyphase FIR, the class of resampler
ffmpeg's swr uses); mp4/mov files carrying a PCM track (what
:func:`mux_audio` writes without ffmpeg) decode through the box-level
reader of media/mp4.py. An ffmpeg binary, where the host has one, decodes
other containers and muxes with AAC; without one those calls raise.
"""

from __future__ import annotations

import math
import shutil
import struct
import subprocess
from typing import Optional

import numpy as np

from calipsync_tpu_torch.media.mp4 import mux_pcm_audio, read_pcm_audio


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _to_float_mono(audio: np.ndarray) -> np.ndarray:
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    elif audio.dtype == np.uint8:
        audio = (audio.astype(np.float32) - 128.0) / 128.0
    else:
        audio = audio.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return audio


def resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling (kaiser-windowed FIR)."""
    if src_rate == dst_rate:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(src_rate, dst_rate)
    out = resample_poly(audio.astype(np.float64), dst_rate // g,
                        src_rate // g)
    return out.astype(np.float32)


def _try_read_pcm(path: str):
    """(rate, mono float32) from a PCM track, or None for a container
    without one."""
    try:
        return read_pcm_audio(path)
    except (ValueError, OSError, struct.error):
        return None


def load_audio(path: str, sample_rate: int = 16_000,
               channels: int = 1) -> np.ndarray:
    """Decode an audio file to float32 PCM at the given rate (mono).

    wav and PCM-in-mp4: native. Other containers need an ffmpeg binary.
    """
    if path.lower().endswith(".wav"):
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        return resample(_to_float_mono(data), sr, sample_rate)
    if path.lower().endswith((".mp4", ".mov", ".m4a")):
        pcm = _try_read_pcm(path)
        if pcm is not None:
            sr, audio = pcm
            return resample(audio, sr, sample_rate)
    if not have_ffmpeg():
        raise RuntimeError(
            f"cannot decode {path!r}: no ffmpeg on this host and native "
            "decode supports .wav and PCM-in-mp4 only")
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-vn",
           "-ar", str(sample_rate), "-ac", str(channels), "-f", "f32le",
           "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    audio = np.frombuffer(out, dtype=np.float32)
    if channels > 1:
        audio = audio.reshape(-1, channels)
    return np.array(audio)


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sample_rate, audio.astype(np.float32))


def rms_db(audio: np.ndarray) -> float:
    """Mean RMS energy in dB."""
    rms = np.sqrt(np.mean(np.square(audio.astype(np.float64))))
    return float(20.0 * np.log10(max(rms, 1e-10)))


def mux_audio(video_path: str, audio_path: str, out_path: str,
              audio_codec: str = "aac") -> Optional[str]:
    """Mux a video with an audio track into ``out_path``.

    With ffmpeg: ``-c:v copy -c:a <codec>``. Without: a box-level remux
    (media/mp4.py) that copies the video samples bit-exact and attaches
    the audio as 16-bit PCM at 24 kHz, still one playable A/V file.
    Returns None in both cases. Only when the video container cannot be
    parsed at the box level is the video copied as is and the audio
    written beside it as a wav, whose path is returned.
    """
    if have_ffmpeg():
        subprocess.run(["ffmpeg", "-v", "error", "-y", "-i", video_path,
                        "-i", audio_path, "-c:v", "copy", "-c:a",
                        audio_codec, "-shortest", out_path], check=True)
        return None
    audio = load_audio(audio_path, 24_000)
    try:
        mux_pcm_audio(video_path, audio, 24_000, out_path)
        return None
    except (ValueError, struct.error):  # struct.error: truncated mid-box
        shutil.copyfile(video_path, out_path)
        side_car = out_path + ".wav"
        save_wav(side_car, audio, 24_000)
        return side_car
