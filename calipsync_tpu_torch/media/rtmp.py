"""Minimal native RTMP: a publishing client and a capture server (own copy
of calipsync_tpu/media/rtmp.py).

The reference pushes its stream to an RTMP ingest by piping frames into
an ffmpeg subprocess (reference
image_infer_v1/tools/frame_player/player_rtmp_windows.py:65-93). A host
may have no ffmpeg, so the wire protocol itself is implemented here, as
media/mp4.py does for mux and media/flv.py for the codec layer:

- :class:`RTMPPublisher` — client side: C0/C1/C2 handshake (plain,
  non-digest — what librtmp calls "simple handshake"; nginx-rtmp and
  friends accept it), chunk-stream framing, AMF0
  connect/createStream/publish command plane, then timestamped
  audio/video/data messages. Payloads are FLV tag bodies (media/flv.py
  builds them), which is exactly what RTMP carries.
- :class:`MiniRTMPServer` — a loopback ingest for tests and soaks: it
  speaks the real protocol (handshake, chunk parsing across chunk-size
  changes, command responses) and captures the published stream to an
  .flv file that stock decoders (cv2/ffmpeg) read back.

Only the protocol surface the publish path exercises is implemented;
this is a delivery shim, not a general RTMP stack.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from calipsync_tpu_torch.media import flv

# RTMP message type ids
MSG_SET_CHUNK_SIZE = 1
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

_CSID_CONTROL = 2
_CSID_COMMAND = 3
_CSID_AUDIO = 4
_CSID_VIDEO = 6
_CSID_DATA = 5


def _handshake_client(sock: socket.socket) -> None:
    """C0/C1 -> S0/S1/S2 -> C2 (plain handshake, 1536-byte randoms)."""
    c1 = struct.pack(">II", int(time.time()) & 0x7FFFFFFF, 0) + os.urandom(
        1528)
    sock.sendall(b"\x03" + c1)
    s0 = _read_exact(sock, 1)
    if s0 != b"\x03":
        raise ConnectionError(f"unexpected RTMP version {s0!r}")
    s1 = _read_exact(sock, 1536)
    _read_exact(sock, 1536)  # s2 (echo of c1) — not verified
    sock.sendall(s1)  # c2


def _handshake_server(sock: socket.socket) -> None:
    c0 = _read_exact(sock, 1)
    if c0 != b"\x03":
        raise ConnectionError(f"unsupported RTMP version {c0!r}")
    c1 = _read_exact(sock, 1536)
    s1 = struct.pack(">II", int(time.time()) & 0x7FFFFFFF, 0) + os.urandom(
        1528)
    sock.sendall(b"\x03" + s1 + c1)  # s0 s1 s2(echo c1)
    _read_exact(sock, 1536)  # c2


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("RTMP peer closed")
        buf += chunk
    return buf


class ChunkWriter:
    """Serialize messages into RTMP chunks (fmt0 head + fmt3 tails)."""

    def __init__(self, sock: socket.socket, chunk_size: int = 128):
        self.sock = sock
        self.chunk_size = chunk_size

    def set_chunk_size(self, n: int) -> None:
        self.send_message(_CSID_CONTROL, MSG_SET_CHUNK_SIZE, 0, 0,
                          struct.pack(">I", n))
        self.chunk_size = n

    def send_message(self, csid: int, msg_type: int, timestamp: int,
                     stream_id: int, payload: bytes) -> None:
        ts = max(0, int(timestamp))
        ext = ts >= 0xFFFFFF
        hdr = bytes([(0 << 6) | csid])
        hdr += struct.pack(">I", 0xFFFFFF if ext else ts)[1:]
        hdr += struct.pack(">I", len(payload))[1:]
        hdr += bytes([msg_type])
        hdr += struct.pack("<I", stream_id)
        if ext:
            hdr += struct.pack(">I", ts)
        out = [hdr, payload[:self.chunk_size]]
        off = self.chunk_size
        while off < len(payload):
            out.append(bytes([(3 << 6) | csid]))
            if ext:
                out.append(struct.pack(">I", ts))
            out.append(payload[off:off + self.chunk_size])
            off += self.chunk_size
        self.sock.sendall(b"".join(out))


class ChunkReader:
    """Reassemble RTMP chunks into complete messages.

    Tracks per-chunk-stream header state (fmt1/2/3 compression), the
    peer's chunk size, and emits window acknowledgements when the peer
    asked for them (real ingests stall a publisher that never acks)."""

    def __init__(self, sock: socket.socket,
                 writer: Optional[ChunkWriter] = None):
        self.sock = sock
        self.writer = writer
        self.chunk_size = 128
        self.window = 0
        self._received = 0
        self._acked = 0
        self._streams: Dict[int, dict] = {}

    def read_message(self) -> Tuple[int, int, int, int, bytes]:
        """-> (csid, msg_type, timestamp, stream_id, payload)."""
        while True:
            first = _read_exact(self.sock, 1)[0]
            fmt, csid = first >> 6, first & 0x3F
            if csid == 0:
                csid = 64 + _read_exact(self.sock, 1)[0]
            elif csid == 1:
                ext = _read_exact(self.sock, 2)
                csid = 64 + ext[0] + (ext[1] << 8)
            st = self._streams.setdefault(
                csid, {"ts": 0, "len": 0, "type": 0, "sid": 0,
                       "buf": b"", "delta": 0})
            if fmt == 0:
                h = _read_exact(self.sock, 11)
                ts = int.from_bytes(h[0:3], "big")
                st["len"] = int.from_bytes(h[3:6], "big")
                st["type"] = h[6]
                st["sid"] = struct.unpack("<I", h[7:11])[0]
                if ts == 0xFFFFFF:
                    ts = struct.unpack(">I", _read_exact(self.sock, 4))[0]
                st["ts"], st["delta"] = ts, 0
            elif fmt == 1:
                h = _read_exact(self.sock, 7)
                delta = int.from_bytes(h[0:3], "big")
                st["len"] = int.from_bytes(h[3:6], "big")
                st["type"] = h[6]
                if delta == 0xFFFFFF:
                    delta = struct.unpack(
                        ">I", _read_exact(self.sock, 4))[0]
                st["delta"] = delta
                if not st["buf"]:
                    st["ts"] += delta
            elif fmt == 2:
                delta = int.from_bytes(_read_exact(self.sock, 3), "big")
                if delta == 0xFFFFFF:
                    delta = struct.unpack(
                        ">I", _read_exact(self.sock, 4))[0]
                st["delta"] = delta
                if not st["buf"]:
                    st["ts"] += delta
            else:  # fmt 3: continuation or repeat of last header
                if st["len"] and not st["buf"]:
                    st["ts"] += st["delta"]
                if st["ts"] >= 0xFFFFFF:
                    # peers that sent an extended timestamp repeat it on
                    # every fmt3 chunk of the message
                    st["ts"] = struct.unpack(
                        ">I", _read_exact(self.sock, 4))[0]
            need = min(self.chunk_size, st["len"] - len(st["buf"]))
            st["buf"] += _read_exact(self.sock, need)
            self._received += need
            self._maybe_ack()
            if len(st["buf"]) < st["len"]:
                continue
            payload, st["buf"] = st["buf"], b""
            if st["type"] == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
                self.chunk_size = struct.unpack(">I", payload[:4])[0]
                continue
            if st["type"] == MSG_WINDOW_ACK_SIZE and len(payload) >= 4:
                self.window = struct.unpack(">I", payload[:4])[0]
                continue
            if st["type"] == MSG_ACK:
                continue
            return csid, st["type"], st["ts"], st["sid"], payload

    def _maybe_ack(self) -> None:
        if (self.writer is not None and self.window
                and self._received - self._acked >= self.window):
            self.writer.send_message(
                _CSID_CONTROL, MSG_ACK, 0, 0,
                struct.pack(">I", self._received & 0xFFFFFFFF))
            self._acked = self._received


def parse_rtmp_url(url: str) -> Tuple[str, int, str, str]:
    """rtmp://host[:port]/app[/...]/stream -> (host, port, app, stream).
    The stream key is the last path segment; the app is everything in
    between (reference pushers use rtmp://host/live/<key>)."""
    if not url.startswith("rtmp://"):
        raise ValueError(f"not an rtmp url: {url}")
    rest = url[len("rtmp://"):]
    hostport, _, path = rest.partition("/")
    host, _, port = hostport.partition(":")
    parts = [p for p in path.split("/") if p]
    if len(parts) < 2:
        raise ValueError(f"rtmp url needs /app/stream: {url}")
    return host, int(port or 1935), "/".join(parts[:-1]), parts[-1]


class RTMPPublisher:
    """Publish-side RTMP session: connect once, then send FLV tag
    payloads as timestamped messages."""

    def __init__(self, url: str, timeout: float = 10.0,
                 chunk_size: int = 4096):
        self.url = url
        host, port, self.app, self.stream = parse_rtmp_url(url)
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _handshake_client(self.sock)
        self.writer = ChunkWriter(self.sock)
        self.reader = ChunkReader(self.sock, self.writer)
        self.writer.set_chunk_size(chunk_size)
        self.stream_id = 0
        self._txn = 0
        self._connect()

    def _command(self, payload: bytes, await_name: str,
                 stream_id: int = 0) -> list:
        self.writer.send_message(_CSID_COMMAND, MSG_COMMAND_AMF0, 0,
                                 stream_id, payload)
        while True:
            _, typ, _, _, body = self.reader.read_message()
            if typ != MSG_COMMAND_AMF0:
                continue  # window-ack/peer-bw/user-control chatter
            name, off = flv.amf0_decode(body)
            if name == await_name:
                vals = []
                while off < len(body):
                    v, off = flv.amf0_decode(body, off)
                    vals.append(v)
                return vals
            if name in ("_error", "onStatus"):
                raise ConnectionError(f"RTMP {name}: {body[:200]!r}")

    def _connect(self) -> None:
        self._txn += 1
        tc_url = f"rtmp://{self.url.split('/')[2]}/{self.app}"
        payload = (flv.amf0_string("connect")
                   + flv.amf0_number(self._txn)
                   + flv.amf0_object({
                       "app": self.app, "type": "nonprivate",
                       "flashVer": "FMLE/3.0 (calipsync_tpu)",
                       "tcUrl": tc_url}))
        self._command(payload, "_result")
        self._txn += 1
        payload = (flv.amf0_string("createStream")
                   + flv.amf0_number(self._txn) + b"\x05")
        vals = self._command(payload, "_result")
        self.stream_id = int(vals[-1]) if vals else 1
        payload = (flv.amf0_string("publish") + flv.amf0_number(0)
                   + b"\x05" + flv.amf0_string(self.stream)
                   + flv.amf0_string("live"))
        self.writer.send_message(_CSID_COMMAND, MSG_COMMAND_AMF0, 0,
                                 self.stream_id, payload)
        # wait for NetStream.Publish.Start
        deadline = time.time() + 10.0
        while time.time() < deadline:
            _, typ, _, _, body = self.reader.read_message()
            if typ != MSG_COMMAND_AMF0:
                continue
            name, off = flv.amf0_decode(body)
            if name == "onStatus":
                _, off = flv.amf0_decode(body, off)      # transaction id
                _, off = flv.amf0_decode(body, off)      # command object
                info, _ = flv.amf0_decode(body, off)     # info object
                code = info.get("code", "") if isinstance(info,
                                                          dict) else ""
                if "Publish.Start" in code:
                    return
                raise ConnectionError(f"publish rejected: {code}")
        raise TimeoutError("no publish confirmation")

    # -- media plane --

    def send_metadata(self, width: int, height: int, fps: float,
                      audio_rate: Optional[int]) -> None:
        body = (flv.amf0_string("@setDataFrame")
                + flv.amf0_string("onMetaData")
                + flv.amf0_ecma_array({
                    "width": float(width), "height": float(height),
                    "framerate": float(fps), "videocodecid": 3.0,
                    **({"audiocodecid": 3.0,
                        "audiosamplerate": float(audio_rate),
                        "audiosamplesize": 16.0, "stereo": False}
                       if audio_rate else {})}))
        self.writer.send_message(_CSID_DATA, MSG_DATA_AMF0, 0,
                                 self.stream_id, body)

    def send_video(self, timestamp_ms: int, payload: bytes) -> None:
        self.writer.send_message(_CSID_VIDEO, MSG_VIDEO,
                                 int(timestamp_ms), self.stream_id,
                                 payload)

    def send_audio(self, timestamp_ms: int, payload: bytes) -> None:
        self.writer.send_message(_CSID_AUDIO, MSG_AUDIO,
                                 int(timestamp_ms), self.stream_id,
                                 payload)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class MiniRTMPServer:
    """Loopback RTMP ingest: accepts one publisher, answers the command
    plane, and captures the published A/V stream to ``capture_path`` as
    a standard .flv file (decodable by cv2/ffmpeg)."""

    def __init__(self, capture_path: str, host: str = "127.0.0.1",
                 port: int = 0,
                 on_tag: Optional[Callable[[int, int, bytes],
                                           None]] = None,
                 accept_timeout: float = 3600.0):
        """``accept_timeout``: backstop on waiting for the publisher to
        connect. Very generous by default — soak harnesses construct
        the ingest before a warmup that can cold-compile for tens of
        minutes; the accept loop also exits promptly on :meth:`stop`."""
        self.capture_path = capture_path
        self.on_tag = on_tag
        self.accept_timeout = accept_timeout
        self._closing = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self.published = threading.Event()
        self.finished = threading.Event()
        self.tags: list = []          # (type, ts, payload) in arrival order
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"rtmp://127.0.0.1:{self.port}/live/test"

    def _serve(self) -> None:
        try:
            # poll-accept so stop() interrupts the wait promptly while
            # the backstop deadline still bounds an abandoned server
            self._lsock.settimeout(1.0)
            deadline = time.time() + self.accept_timeout
            while True:
                try:
                    conn, _ = self._lsock.accept()
                    break
                except socket.timeout:
                    if self._closing.is_set() or time.time() > deadline:
                        raise
            conn.settimeout(30.0)
            _handshake_server(conn)
            writer = ChunkWriter(conn)
            reader = ChunkReader(conn, writer)
            while True:
                try:
                    _, typ, ts, sid, body = reader.read_message()
                except (ConnectionError, socket.timeout):
                    break
                if typ == MSG_COMMAND_AMF0:
                    self._handle_command(writer, body)
                elif typ in (MSG_AUDIO, MSG_VIDEO):
                    self.tags.append((typ, ts, body))
                    if self.on_tag:
                        self.on_tag(typ, ts, body)
                elif typ == MSG_DATA_AMF0:
                    self.tags.append((flv.TAG_SCRIPT, ts, body))
            conn.close()
        except BaseException as e:  # surfaced by tests via .error
            self.error = e
        finally:
            self._write_capture()
            self.finished.set()

    def _handle_command(self, writer: ChunkWriter, body: bytes) -> None:
        name, off = flv.amf0_decode(body)
        txn, _ = flv.amf0_decode(body, off)
        if name == "connect":
            writer.send_message(_CSID_CONTROL, MSG_WINDOW_ACK_SIZE, 0, 0,
                                struct.pack(">I", 5_000_000))
            writer.send_message(_CSID_CONTROL, MSG_SET_PEER_BW, 0, 0,
                                struct.pack(">IB", 5_000_000, 2))
            resp = (flv.amf0_string("_result") + flv.amf0_number(txn)
                    + flv.amf0_object({"fmsVer": "FMS/3,5,7,7009",
                                       "capabilities": 31.0})
                    + flv.amf0_object({
                        "level": "status",
                        "code": "NetConnection.Connect.Success",
                        "description": "Connection succeeded."}))
            writer.send_message(_CSID_COMMAND, MSG_COMMAND_AMF0, 0, 0,
                                resp)
        elif name == "createStream":
            resp = (flv.amf0_string("_result") + flv.amf0_number(txn)
                    + b"\x05" + flv.amf0_number(1))
            writer.send_message(_CSID_COMMAND, MSG_COMMAND_AMF0, 0, 0,
                                resp)
        elif name == "publish":
            resp = (flv.amf0_string("onStatus") + flv.amf0_number(0)
                    + b"\x05" + flv.amf0_object({
                        "level": "status",
                        "code": "NetStream.Publish.Start",
                        "description": "Publishing."}))
            writer.send_message(_CSID_COMMAND, MSG_COMMAND_AMF0, 0, 1,
                                resp)
            self.published.set()

    def _write_capture(self) -> None:
        """Persist captured tags as a standard FLV file."""
        meta = next(((t, ts, p) for t, ts, p in self.tags
                     if t == flv.TAG_SCRIPT), None)
        has_audio = any(t == MSG_AUDIO for t, _, _ in self.tags)
        with open(self.capture_path, "wb") as f:
            f.write(flv.flv_header(has_audio=has_audio))
            for typ, ts, payload in self.tags:
                if typ == flv.TAG_SCRIPT:
                    # strip the RTMP-only @setDataFrame wrapper
                    name, off = flv.amf0_decode(payload)
                    if name == "@setDataFrame":
                        payload = payload[off:]
                f.write(flv.flv_tag(typ, ts, payload))
        del meta

    def stop(self, timeout: float = 10.0) -> None:
        self._closing.set()
        self.finished.wait(timeout)
        try:
            self._lsock.close()
        except OSError:
            pass
