"""ISO-BMFF (mp4/mov) box-level remuxer: add a PCM audio track (own copy
of calipsync_tpu/media/mp4.py).

cv2.VideoWriter writes video-only mp4s and a host may have no ffmpeg
binary. This module parses the cv2-written mp4 at the box level, takes
the compressed video samples and their timing verbatim, and rewrites the
file with a second track carrying the audio as 16-bit PCM (QuickTime
'sowt' sample entry, read by ffmpeg, VLC and QuickTime in .mp4 and .mov).
At 16-24 kHz mono the PCM track adds 32-48 KB/s. Pure stdlib struct work
on the host.

Layout produced::

    ftyp | mdat [video samples...][audio pcm] | moov {video trak, audio trak}

Video sample data, the stsd sample description, sample sizes and timing
(stts/stss) are copied bit-exact from the input; only the chunk maps
(stsc/stco) are rebuilt for the new single-chunk layout.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
               b"dinf", b"udta"}


# ---------------------------------------------------------------- parse

def _walk(buf: bytes, off: int, end: int):
    """Yield (type, payload_start, payload_end) for each box in range."""
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, off)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            raise ValueError(f"corrupt box {typ!r} at {off}")
        yield typ, off + hdr, off + size
        off += size


def _find(buf: bytes, start: int, end: int, *path: bytes) -> Tuple[int, int]:
    """Payload range of the first box at a nested path, or (-1, -1)."""
    for typ, p0, p1 in _walk(buf, start, end):
        if typ == path[0]:
            if len(path) == 1:
                return p0, p1
            return _find(buf, p0, p1, *path[1:])
    return -1, -1


def _find_all(buf: bytes, start: int, end: int, typ: bytes):
    return [(p0, p1) for t, p0, p1 in _walk(buf, start, end) if t == typ]


@dataclass
class Track:
    """One parsed media track: raw boxes to copy + decoded sample maps."""

    handler: bytes                    # 'vide' / 'soun'
    tkhd: bytes                       # full tkhd box, verbatim
    mdhd: bytes                       # full mdhd box, verbatim
    stsd: bytes                       # full stsd box, verbatim
    stts: bytes                       # full stts box, verbatim
    stss: Optional[bytes]             # full stss box or None (all sync)
    ctts: Optional[bytes]             # composition offsets, if present
    timescale: int
    duration: int                     # in track timescale units
    sample_sizes: List[int] = field(default_factory=list)
    sample_offsets: List[int] = field(default_factory=list)

    @property
    def codec(self) -> bytes:
        # stsd payload: ver/flags(4) entry_count(4) then first entry
        return self.stsd[8 + 8 + 4:8 + 8 + 8]


def _box_at(buf: bytes, start: int, end: int, typ: bytes) -> Optional[bytes]:
    """The complete box bytes (header included) of the first `typ` child."""
    off = start
    for t, p0, p1 in _walk(buf, start, end):
        if t == typ:
            return buf[off:p1]
        off = p1
    return None


def _parse_mdhd(mdhd: bytes) -> Tuple[int, int]:
    ver = mdhd[8]
    if ver == 1:
        ts, dur = struct.unpack_from(">IQ", mdhd, 8 + 4 + 16)
    else:
        ts, dur = struct.unpack_from(">II", mdhd, 8 + 4 + 8)
    return ts, dur


def _parse_stsz(payload: bytes) -> List[int]:
    fixed, count = struct.unpack_from(">II", payload, 4)
    if fixed:
        return [fixed] * count
    return list(struct.unpack_from(f">{count}I", payload, 12))


def _parse_entries(payload: bytes, per: int) -> List[Tuple[int, ...]]:
    (count,) = struct.unpack_from(">I", payload, 4)
    out = []
    off = 8
    for _ in range(count):
        out.append(struct.unpack_from(f">{per}I", payload, off))
        off += 4 * per
    return out


def _sample_offsets(buf: bytes, stbl0: int, stbl1: int,
                    sizes: List[int]) -> List[int]:
    """Absolute file offset of every sample, via stsc x stco/co64."""
    stco = _find(buf, stbl0, stbl1, b"stco")
    if stco[0] >= 0:
        (n,) = struct.unpack_from(">I", buf, stco[0] + 4)
        chunks = list(struct.unpack_from(f">{n}I", buf, stco[0] + 8))
    else:
        co64 = _find(buf, stbl0, stbl1, b"co64")
        if co64[0] < 0:
            raise ValueError("no stco/co64 in track")
        (n,) = struct.unpack_from(">I", buf, co64[0] + 4)
        chunks = list(struct.unpack_from(f">{n}Q", buf, co64[0] + 8))
    stsc = _find(buf, stbl0, stbl1, b"stsc")
    runs = _parse_entries(buf[stsc[0]:stsc[1]], 3)  # first_chunk, per, desc
    offsets: List[int] = []
    si = 0
    for ri, (first, per, _desc) in enumerate(runs):
        last = runs[ri + 1][0] - 1 if ri + 1 < len(runs) else len(chunks)
        for ci in range(first - 1, last):
            pos = chunks[ci]
            for _ in range(per):
                if si >= len(sizes):
                    return offsets
                offsets.append(pos)
                pos += sizes[si]
                si += 1
    return offsets


def parse_track(path: str, handler: bytes = b"vide") -> Tuple[Track, bytes]:
    """Parse the first track with the given handler. Returns (track, file
    bytes) so callers can slice sample data without re-reading."""
    with open(path, "rb") as f:
        buf = f.read()
    moov = _find(buf, 0, len(buf), b"moov")
    if moov[0] < 0:
        raise ValueError(f"{path}: no moov box (not an mp4/mov?)")
    for t0, t1 in _find_all(buf, moov[0], moov[1], b"trak"):
        hdlr = _find(buf, t0, t1, b"mdia", b"hdlr")
        if hdlr[0] < 0 or buf[hdlr[0] + 8:hdlr[0] + 12] != handler:
            continue
        md0, md1 = _find(buf, t0, t1, b"mdia")
        st0, st1 = _find(buf, md0, md1, b"minf", b"stbl")
        mdhd = _box_at(buf, md0, md1, b"mdhd")
        tkhd = _box_at(buf, t0, t1, b"tkhd")
        stsd = _box_at(buf, st0, st1, b"stsd")
        stts = _box_at(buf, st0, st1, b"stts")
        stss = _box_at(buf, st0, st1, b"stss")
        ctts = _box_at(buf, st0, st1, b"ctts")
        stsz = _find(buf, st0, st1, b"stsz")
        if None in (mdhd, tkhd, stsd, stts) or stsz[0] < 0:
            raise ValueError(f"{path}: incomplete sample tables")
        ts, dur = _parse_mdhd(mdhd)
        sizes = _parse_stsz(buf[stsz[0]:stsz[1]])
        offs = _sample_offsets(buf, st0, st1, sizes)
        if len(offs) != len(sizes):
            raise ValueError(f"{path}: stsc/stco map {len(offs)} samples, "
                             f"stsz has {len(sizes)}")
        return Track(handler=handler, tkhd=tkhd, mdhd=mdhd, stsd=stsd,
                     stts=stts, stss=stss, ctts=ctts, timescale=ts,
                     duration=dur, sample_sizes=sizes,
                     sample_offsets=offs), buf
    raise ValueError(f"{path}: no {handler!r} track")


# ---------------------------------------------------------------- build

def _box(typ: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(typ, struct.pack(">B3s", version,
                                 flags.to_bytes(3, "big")), *payload)


_MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _mvhd(duration_ms: int, next_track: int) -> bytes:
    return _full(b"mvhd", 0, 0, struct.pack(
        ">IIIIIhh8x36s24xI",
        0, 0, 1000, duration_ms, 0x00010000, 0x0100, 0, _MATRIX,
        next_track))


def _retime_tkhd(tkhd: bytes, track_id: int, duration_ms: int) -> bytes:
    """Copy a tkhd, rewriting track id + movie-timescale duration."""
    ver = tkhd[8]
    b = bytearray(tkhd)
    if ver == 1:
        struct.pack_into(">I", b, 8 + 4 + 16, track_id)
        struct.pack_into(">Q", b, 8 + 4 + 24, duration_ms)
    else:
        struct.pack_into(">I", b, 8 + 4 + 8, track_id)
        struct.pack_into(">I", b, 8 + 4 + 16, duration_ms)
    return bytes(b)


def _audio_tkhd(track_id: int, duration_ms: int) -> bytes:
    # layout: cre, mod, id, reserved(4), duration, reserved(8),
    # layer, alt_group, volume, reserved(2), matrix, width, height
    return _full(b"tkhd", 0, 3, struct.pack(
        ">IIIII8xhhhh36sII", 0, 0, track_id, 0, duration_ms,
        0, 0, 0x0100, 0, _MATRIX, 0, 0))


def _mdhd(timescale: int, duration: int) -> bytes:
    return _full(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))  # und


def _hdlr(handler: bytes, name: bytes) -> bytes:
    return _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, handler),
                 name + b"\x00")


def _dinf() -> bytes:
    return _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))


def _sowt_stsd(sample_rate: int, channels: int) -> bytes:
    if not 0 < sample_rate < 65536:
        # the v0 sound sample entry stores the rate as 16.16 fixed point;
        # >=64 kHz would silently wrap (mdhd would still be right, but
        # stsd-honoring players would mis-speed the track)
        raise ValueError(f"sample_rate {sample_rate} needs a v1 sound "
                         "sample entry; resample below 64 kHz")
    entry = _box(b"sowt", struct.pack(
        ">6xH"      # SampleEntry: reserved, data_reference_index
        "HH4x"      # version 0, revision, vendor
        "HHHHI",    # channels, bits, compression_id, packet, rate<<16
        1, 0, 0, channels, 16, 0, 0, (sample_rate & 0xFFFF) << 16))
    return _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)


def _single_chunk_maps(n_samples: int, chunk_offset: int,
                       fixed_size: int, sizes: Optional[List[int]]) -> bytes:
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n_samples, 1))
    if sizes is None:
        stsz = _full(b"stsz", 0, 0,
                     struct.pack(">II", fixed_size, n_samples))
    else:
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(sizes)),
                     struct.pack(f">{len(sizes)}I", *sizes))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    return stsc + stsz + stco


def mux_pcm_audio(video_path: str, audio: np.ndarray, sample_rate: int,
                  out_path: str) -> str:
    """Rewrite ``video_path``'s video track into ``out_path`` with
    ``audio`` (float or int16, mono or (N, C)) attached as 16-bit PCM.

    Replaces the reference's ``ffmpeg -c:v copy -c:a aac`` mux
    (reference inference.py:108-110) on ffmpeg-less hosts: video samples
    are copied bit-exact, audio stays lossless PCM.
    """
    track, buf = parse_track(video_path, b"vide")
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    channels = int(audio.shape[1])
    if audio.dtype != np.int16:
        pcm = np.clip(audio.astype(np.float32), -1.0, 1.0)
        pcm = (pcm * 32767.0).round().astype("<i2")
    else:
        pcm = audio.astype("<i2")
    pcm_bytes = pcm.tobytes()
    n_aframes = int(pcm.shape[0])
    frame_bytes = 2 * channels

    video_data = b"".join(
        buf[o:o + s]
        for o, s in zip(track.sample_offsets, track.sample_sizes))

    if len(video_data) + len(pcm_bytes) > 0xFFFFFFF0:
        raise ValueError(
            "mdat would exceed 4 GiB (32-bit box sizes/stco); split the "
            "clip or mux with ffmpeg")

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isom", b"iso2", b"mp41")
    mdat_off = len(ftyp)
    video_off = mdat_off + 8
    audio_off = video_off + len(video_data)

    video_ms = (track.duration * 1000) // max(track.timescale, 1)
    audio_ms = (n_aframes * 1000) // max(sample_rate, 1)

    v_stbl = _box(b"stbl", track.stsd, track.stts,
                  track.ctts or b"", track.stss or b"",
                  _single_chunk_maps(len(track.sample_sizes), video_off,
                                     0, track.sample_sizes))
    v_minf = _box(b"minf",
                  _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0)),
                  _dinf(), v_stbl)
    v_trak = _box(b"trak", _retime_tkhd(track.tkhd, 1, video_ms),
                  _box(b"mdia", track.mdhd, _hdlr(b"vide", b"VideoHandler"),
                       v_minf))

    a_stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n_aframes, 1))
    a_stbl = _box(b"stbl", _sowt_stsd(sample_rate, channels), a_stts,
                  _single_chunk_maps(n_aframes, audio_off, frame_bytes,
                                     None))
    a_minf = _box(b"minf", _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0)),
                  _dinf(), a_stbl)
    a_trak = _box(b"trak", _audio_tkhd(2, audio_ms),
                  _box(b"mdia", _mdhd(sample_rate, n_aframes),
                       _hdlr(b"soun", b"SoundHandler"), a_minf))

    moov = _box(b"moov", _mvhd(max(video_ms, audio_ms), 3), v_trak, a_trak)
    mdat = struct.pack(">I4s", 8 + len(video_data) + len(pcm_bytes),
                       b"mdat") + video_data + pcm_bytes

    with open(out_path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(moov)
    return out_path


# ---------------------------------------------------------------- demux

_PCM_CODECS = {b"sowt": "<i2", b"twos": ">i2"}


def read_pcm_audio(path: str) -> Tuple[int, np.ndarray]:
    """Read a PCM ('sowt'/'twos') audio track back as (rate, float32 mono
    in [-1, 1]). Round-trip companion of :func:`mux_pcm_audio`."""
    track, buf = parse_track(path, b"soun")
    fmt = _PCM_CODECS.get(track.codec)
    if fmt is None:
        raise ValueError(
            f"{path}: audio codec {track.codec!r} is not PCM; decoding "
            "compressed audio needs an ffmpeg binary")
    # channel count from the stsd audio sample entry: full-box header(8)
    # + ver/flags(4) + entry_count(4) + entry size/type(8) = 24, then
    # reserved(6) + dref_index(2) + ver/rev/vendor(8) = body offset 16
    channels = struct.unpack_from(">H", track.stsd, 24 + 16)[0]
    data = b"".join(
        buf[o:o + s]
        for o, s in zip(track.sample_offsets, track.sample_sizes))
    pcm = np.frombuffer(data, dtype=fmt).astype(np.float32) / 32768.0
    if channels > 1:
        pcm = pcm.reshape(-1, channels).mean(axis=1)
    return track.timescale, pcm


def has_pcm_audio(path: str) -> bool:
    try:
        track, _ = parse_track(path, b"soun")
    except (ValueError, OSError, struct.error):
        # struct.error: truncated/corrupt container mid-box
        return False
    return track.codec in _PCM_CODECS
