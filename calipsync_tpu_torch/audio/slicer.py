"""Audio slicing into 5-12 s speech segments (the port's own copy of
calipsync_tpu/audio/slicer.py, over the port's ``audio/io.py``).

The reference slices training audio with a funasr ASR + VAD + punctuation
stack (the reference's utils/get_srt/slice_origin_audio.py:7-122; its
pipeline caller ships disabled, step3:143-152). funasr is not a
dependency, so the same interface is provided with two backends:

  - ``asr_fn`` hook: plug in any callable returning
    [(start_s, end_s, text)] sentence spans (funasr-equivalent).
  - energy VAD fallback: frame-RMS thresholding with hangover, merged into
    random-length 5-12 s segments like the reference's grouping.

Outputs per segment: ``{out}/{i}.wav`` + ``{out}/{i}.txt`` transcript
(empty text under the VAD fallback).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

Span = Tuple[float, float, str]


def energy_vad(audio: np.ndarray, sample_rate: int,
               frame_ms: float = 30.0, threshold_db: float = -40.0,
               hangover_frames: int = 10) -> List[Tuple[float, float]]:
    """Speech spans by frame-RMS thresholding with hangover smoothing."""
    frame = int(sample_rate * frame_ms / 1000)
    n = len(audio) // frame
    if n == 0:
        return []
    x = audio[:n * frame].reshape(n, frame).astype(np.float64)
    rms_db = 20 * np.log10(np.sqrt(np.mean(x * x, axis=1)) + 1e-10)
    active = rms_db > threshold_db
    # hangover: keep active for a few frames after speech ends
    out = np.zeros_like(active)
    run = 0
    for i, a in enumerate(active):
        run = hangover_frames if a else max(0, run - 1)
        out[i] = run > 0
    spans = []
    start = None
    for i, a in enumerate(out):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append((start * frame_ms / 1000, i * frame_ms / 1000))
            start = None
    if start is not None:
        spans.append((start * frame_ms / 1000, n * frame_ms / 1000))
    return spans


def sentences_from_spans(words: List[Span],
                         sentence_punct: str = "。！？!?.;；",
                         max_gap_s: float = 0.5) -> List[Span]:
    """Merge word/clause spans into sentence spans.

    The reference gets sentence units from funasr's punctuation model +
    VAD (slice_origin_audio.py:24-46, ``sentence_info``). This rebuilds
    the same segmentation from timestamped ASR output: a sentence closes
    when its last token ends with sentence punctuation, or when the gap
    to the next token exceeds ``max_gap_s`` (the VAD role). Timestamps
    are preserved end-to-end, so the downstream grouping sees the same
    start/end structure funasr would report."""
    sentences: List[Span] = []
    cur: List[Span] = []

    def close():
        if cur:
            sentences.append((cur[0][0], cur[-1][1],
                              " ".join(t for _, _, t in cur).strip()))
            cur.clear()

    for i, (s, e, text) in enumerate(words):
        if cur and s - cur[-1][1] > max_gap_s:
            close()
        cur.append((s, e, text))
        stripped = text.rstrip()
        if stripped and stripped[-1] in sentence_punct:
            close()
    close()
    return sentences


def group_spans(spans: List[Span], min_seconds: float, max_seconds: float,
                rng: np.random.Generator) -> List[Span]:
    """Merge sentence spans into random-target-length segments, exactly
    as the reference groups funasr sentences
    (slice_origin_audio.py:55-106): per segment draw an integer target in
    [min, max] seconds (ms granularity, inclusive — ``random.randint``),
    accumulate whole sentences while the duration measured from the
    segment start stays below the target (a sentence whose end would
    reach it starts the NEXT segment; at least one sentence per segment),
    and always emit the final partial segment. Inter-sentence gaps stay
    inside a segment; gaps between segments are dropped."""
    segments: List[Span] = []
    i = 0
    while i < len(spans):
        target = int(rng.integers(int(min_seconds * 1000),
                                  int(max_seconds * 1000),
                                  endpoint=True)) / 1000.0
        start_i = i
        seg_start = spans[i][0]
        seg_end = seg_start
        text: List[str] = []
        while i < len(spans):
            s, e, t = spans[i]
            if e - seg_start >= target and i > start_i:
                break
            text.append(t)
            seg_end = e
            i += 1
        segments.append((seg_start, seg_end, " ".join(text).strip()))
    return segments


def process_and_split_audio(audio_path: str, output_dir: str,
                            min_seconds: float = 5.0,
                            max_seconds: float = 12.0,
                            asr_fn: Optional[Callable[[np.ndarray, int],
                                                      List[Span]]] = None,
                            sample_rate: int = 16_000,
                            seed: int = 0) -> List[Span]:
    """Slice an audio file into speech segments; writes wav+txt pairs.

    ``asr_fn`` spans are consumed as-is and should already be sentence
    units (funasr's ``sentence_info`` analogue) — CTCRecognizer's
    ``as_asr_fn`` produces them via ``sentences_from_spans``; wrap a
    word-level source with that helper before plugging it in."""
    from calipsync_tpu_torch.audio.io import load_audio, save_wav

    os.makedirs(output_dir, exist_ok=True)
    audio = load_audio(audio_path, sample_rate)
    if asr_fn is not None:
        spans = asr_fn(audio, sample_rate)
    else:
        spans = [(s, e, "") for s, e in energy_vad(audio, sample_rate)]
    segments = group_spans(spans, min_seconds, max_seconds,
                           np.random.default_rng(seed))
    for i, (s, e, text) in enumerate(segments):
        piece = audio[int(s * sample_rate):int(e * sample_rate)]
        save_wav(os.path.join(output_dir, f"{i}.wav"), piece, sample_rate)
        with open(os.path.join(output_dir, f"{i}.txt"), "w") as f:
            f.write(text)
    return segments
