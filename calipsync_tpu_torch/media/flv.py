"""Native FLV muxer: Screen-Video (FSV1) frames + linear-PCM audio (own
copy of calipsync_tpu/media/flv.py; its output is byte-identical).

The reference's third stream player pushes FLV over RTMP through an
ffmpeg + NVENC subprocess (reference
image_infer_v1/tools/frame_player/player_rtmp_windows.py:65-93). A host
may have no ffmpeg binary, so, as the box-level mp4 remuxer
(media/mp4.py) does for offline mux, the container and codec layers are
implemented here:

- **Video**: FLV codec 3, "Screen Video" (FSV1): the frame is tiled
  into blocks (bottom-up rows, left-to-right), each block's BGR24
  pixels zlib-deflated independently. Inter frames may mark unchanged
  blocks with a zero-length body, so a mostly-static avatar stream
  costs a fraction of the keyframe rate. The format is pure zlib +
  bit-packing and decodes with stock ffmpeg/libavcodec ("flashsv"),
  which is what cv2.VideoCapture uses.
- **Audio**: FLV sound format 3 (linear PCM little-endian). FLV's
  audio tag header only advertises 44.1/22.05/11.025/5.5125 kHz, so
  callers resample to one of those (serve/players.py uses the same
  polyphase resampler as the wav path) and the onMetaData script tag
  repeats the exact rate.

Pure host-side stdlib byte work (struct + zlib); the GPU never touches
delivery framing.
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional

import numpy as np

TAG_AUDIO = 8
TAG_VIDEO = 9
TAG_SCRIPT = 18

_FLV_RATES = {44100: 3, 22050: 2, 11025: 1, 5512: 0}


# ------------------------------------------------------------- container

def flv_header(has_audio: bool = True, has_video: bool = True) -> bytes:
    """9-byte FLV file header + the leading PreviousTagSize0 word."""
    flags = (0x04 if has_audio else 0) | (0x01 if has_video else 0)
    return b"FLV\x01" + bytes([flags]) + struct.pack(">I", 9) + b"\0\0\0\0"


def flv_tag(tag_type: int, timestamp_ms: int, payload: bytes) -> bytes:
    """One complete FLV tag: 11-byte header, payload, PreviousTagSize."""
    ts = timestamp_ms & 0xFFFFFFFF
    hdr = struct.pack(">B", tag_type) + struct.pack(
        ">I", len(payload))[1:] + struct.pack(
        ">I", ts & 0xFFFFFF)[1:] + bytes([(ts >> 24) & 0xFF]) + b"\0\0\0"
    return hdr + payload + struct.pack(">I", 11 + len(payload))


# ------------------------------------------------------------------ AMF0

def amf0_number(v: float) -> bytes:
    return b"\x00" + struct.pack(">d", float(v))


def amf0_boolean(v: bool) -> bytes:
    return b"\x01" + (b"\x01" if v else b"\x00")


def amf0_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return b"\x02" + struct.pack(">H", len(b)) + b


def _amf0_props(props: dict) -> bytes:
    out = b""
    for k, v in props.items():
        kb = k.encode("utf-8")
        out += struct.pack(">H", len(kb)) + kb + amf0_value(v)
    return out + b"\x00\x00\x09"


def amf0_object(props: dict) -> bytes:
    return b"\x03" + _amf0_props(props)


def amf0_ecma_array(props: dict) -> bytes:
    return b"\x08" + struct.pack(">I", len(props)) + _amf0_props(props)


def amf0_value(v) -> bytes:
    if isinstance(v, bool):
        return amf0_boolean(v)
    if isinstance(v, (int, float)):
        return amf0_number(v)
    if isinstance(v, str):
        return amf0_string(v)
    if isinstance(v, dict):
        return amf0_object(v)
    if v is None:
        return b"\x05"
    raise TypeError(f"no AMF0 encoding for {type(v)}")


def amf0_decode(buf: bytes, off: int = 0):
    """Decode one AMF0 value -> (value, next_offset). Supports the types
    the RTMP command plane uses (number/bool/string/object/null/ecma)."""
    marker = buf[off]
    off += 1
    if marker == 0x00:
        return struct.unpack_from(">d", buf, off)[0], off + 8
    if marker == 0x01:
        return bool(buf[off]), off + 1
    if marker == 0x02:
        n = struct.unpack_from(">H", buf, off)[0]
        return buf[off + 2:off + 2 + n].decode("utf-8"), off + 2 + n
    if marker in (0x03, 0x08):
        if marker == 0x08:
            off += 4  # approximate count, trailer is authoritative
        out = {}
        while True:
            n = struct.unpack_from(">H", buf, off)[0]
            key = buf[off + 2:off + 2 + n].decode("utf-8")
            off += 2 + n
            if n == 0 and buf[off] == 0x09:
                return out, off + 1
            out[key], off = amf0_decode(buf, off)
    if marker == 0x05:
        return None, off
    if marker == 0x06:  # undefined
        return None, off
    raise ValueError(f"unsupported AMF0 marker 0x{marker:02x}")


def metadata_tag(width: int, height: int, fps: float,
                 audio_rate: Optional[int], videodatarate: float = 0.0,
                 encoder: str = "calipsync_tpu") -> bytes:
    """The onMetaData script tag players/demuxers read dimensions and the
    exact audio sample rate from."""
    props = {
        "width": float(width), "height": float(height),
        "framerate": float(fps), "videocodecid": 3.0,
        "videodatarate": videodatarate, "encoder": encoder,
    }
    if audio_rate:
        props.update({"audiocodecid": 3.0,
                      "audiosamplerate": float(audio_rate),
                      "audiosamplesize": 16.0, "stereo": False})
    payload = amf0_string("onMetaData") + amf0_ecma_array(props)
    return flv_tag(TAG_SCRIPT, 0, payload)


# ---------------------------------------------------- Screen Video codec

class ScreenVideoEncoder:
    """FSV1 (FLV codec id 3) encoder.

    Bitstream (Adobe FLV spec, SCREENVIDEOPACKET): a 4-byte header of
    4-bit-coded block width ((bw/16)-1), 12-bit image width, 4-bit-coded
    block height, 12-bit image height; then per block — bottom-up block
    rows, left-to-right — a UI16 length and a zlib-deflated BGR24 body
    whose pixel rows run bottom-up. A zero length marks the block as
    unchanged from the previous frame (inter frame).

    ``encode`` returns the complete VIDEODATA payload including the
    frame-type/codec nibble byte. Keyframes are forced every
    ``keyframe_interval`` frames and whenever dimensions change.
    """

    def __init__(self, block: int = 64, keyframe_interval: int = 48,
                 zlib_level: int = 1):
        if block % 16 or not 16 <= block <= 256:
            raise ValueError("block must be a multiple of 16 in [16,256]")
        self.block = block
        self.keyframe_interval = keyframe_interval
        self.zlib_level = zlib_level
        self._prev: Optional[np.ndarray] = None
        self._since_key = 0

    def _blocks(self, frame: np.ndarray):
        """Yield (y0, y1, x0, x1) in FSV1 order: bottom row of blocks
        first, left to right; y measured from the BOTTOM edge."""
        h, w = frame.shape[:2]
        for by in range(0, h, self.block):
            for bx in range(0, w, self.block):
                y1 = h - by
                y0 = max(0, y1 - self.block)
                yield y0, y1, bx, min(bx + self.block, w)

    def encode(self, frame_bgr: np.ndarray) -> bytes:
        """BGR uint8 (H, W, 3) -> VIDEODATA payload bytes."""
        f = np.ascontiguousarray(frame_bgr)
        h, w = f.shape[:2]
        if f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3:
            raise ValueError("expected uint8 BGR (H, W, 3)")
        key = (self._prev is None or self._prev.shape != f.shape
               or self._since_key >= self.keyframe_interval)
        parts = [struct.pack(">HH",
                             ((self.block // 16 - 1) << 12) | (w & 0xFFF),
                             ((self.block // 16 - 1) << 12) | (h & 0xFFF))]
        for y0, y1, x0, x1 in self._blocks(f):
            blk = f[y0:y1, x0:x1]
            if (not key and self._prev is not None
                    and np.array_equal(blk, self._prev[y0:y1, x0:x1])):
                parts.append(b"\x00\x00")  # unchanged
                continue
            body = zlib.compress(blk[::-1].tobytes(), self.zlib_level)
            parts.append(struct.pack(">H", len(body)) + body)
        self._prev = f.copy()
        self._since_key = 0 if key else self._since_key + 1
        frame_type = 1 if key else 2
        return bytes([(frame_type << 4) | 3]) + b"".join(parts)


def decode_screen_video(payload: bytes,
                        prev: Optional[np.ndarray] = None) -> np.ndarray:
    """Reference FSV1 decoder (tests + the mini RTMP server's capture
    validation): VIDEODATA payload -> BGR uint8 (H, W, 3)."""
    if payload[0] & 0x0F != 3:
        raise ValueError("not Screen Video")
    head_w, head_h = struct.unpack_from(">HH", payload, 1)
    block_w = ((head_w >> 12) + 1) * 16
    block_h = ((head_h >> 12) + 1) * 16
    w, h = head_w & 0xFFF, head_h & 0xFFF
    out = (prev.copy() if prev is not None
           else np.zeros((h, w, 3), np.uint8))
    off = 5
    for by in range(0, h, block_h):
        for bx in range(0, w, block_w):
            (n,) = struct.unpack_from(">H", payload, off)
            off += 2
            y1 = h - by
            y0 = max(0, y1 - block_h)
            x1 = min(bx + block_w, w)
            if n:
                raw = zlib.decompress(payload[off:off + n])
                blk = np.frombuffer(raw, np.uint8).reshape(
                    y1 - y0, x1 - bx, 3)
                out[y0:y1, bx:x1] = blk[::-1]
                off += n
    return out


# ------------------------------------------------------------ audio tags

def pcm_audio_payload(samples_s16: np.ndarray, rate: int) -> bytes:
    """AUDIODATA payload: linear PCM little-endian, mono 16-bit.
    ``rate`` must be an FLV-representable rate (see _FLV_RATES)."""
    if rate not in _FLV_RATES:
        raise ValueError(f"FLV cannot signal {rate} Hz; resample to one "
                         f"of {sorted(_FLV_RATES)}")
    hdr = (3 << 4) | (_FLV_RATES[rate] << 2) | (1 << 1) | 0  # 16-bit mono
    return bytes([hdr]) + np.asarray(samples_s16, "<i2").tobytes()


# ------------------------------------------------------------ file writer

class FLVWriter:
    """Sequential FLV file writer (the capture side of the mini RTMP
    server, and a standalone file sink for the native player backend)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 audio_rate: Optional[int] = None):
        self._f = open(path, "wb")
        self._f.write(flv_header(has_audio=audio_rate is not None))
        self._f.write(metadata_tag(width, height, fps, audio_rate))

    def write_tag(self, tag_type: int, timestamp_ms: int,
                  payload: bytes) -> None:
        self._f.write(flv_tag(tag_type, timestamp_ms, payload))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_flv_tags(path: str) -> Iterable[tuple]:
    """Parse an FLV file -> (tag_type, timestamp_ms, payload) triples."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"FLV":
        raise ValueError("not an FLV file")
    off = struct.unpack_from(">I", buf, 5)[0] + 4
    while off + 11 <= len(buf):
        typ = buf[off]
        size = int.from_bytes(buf[off + 1:off + 4], "big")
        ts = int.from_bytes(buf[off + 4:off + 7], "big") | (
            buf[off + 7] << 24)
        payload = buf[off + 11:off + 11 + size]
        if len(payload) < size:
            break
        yield typ, ts, payload
        off += 11 + size + 4
