"""A minimal RFC 6455 WebSocket server on ``socket`` and ``threading``.

The JAX package's web viewer serves through ``websockets.sync.server.serve
(handler, ip, port, max_size=None, compression=None)``; this module gives
the port the same shape with the standard library only: a ``Server``'s
``serve_forever`` accepts connections, each on a thread of its own, and
calls ``handler(connection)`` after the opening handshake;
``connection.send`` / ``recv`` exchange whole messages and raise
``ConnectionClosed`` once the connection is closed.

What it speaks: the HTTP/1.1 Upgrade handshake (``Sec-WebSocket-Accept`` =
base64(SHA-1(key + GUID))); masked client frames and unmasked server
frames; text and binary messages with 7-, 16- and 64-bit lengths;
fragmented messages on receive; ping (answered by pong) and pong; the
close handshake.  No extension is negotiated (the JAX server turns
compression off) and messages have no size limit (``max_size=None``).
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading

import numpy as np

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
MAX_HEADER_BYTES = 65536
CLOSE_TIMEOUT_S = 2.0


class ConnectionClosed(Exception):
    """The connection is closed; ``code`` and ``reason`` are the close
    frame's (1006 when the peer went away without one)."""

    def __init__(self, code: int = 1006, reason: str = ""):
        super().__init__(f"connection closed: {code} {reason}".rstrip())
        self.code, self.reason = code, reason


class ProtocolError(Exception):
    pass


def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """One unfragmented, unmasked (server) frame."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def apply_mask(payload: bytes, mask: bytes) -> bytes:
    if not payload:
        return b""
    data = np.frombuffer(payload, np.uint8)
    return (data ^ np.resize(np.frombuffer(mask, np.uint8), data.size)).tobytes()


class Connection:
    """The server side of one WebSocket connection."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self._close_sent = False
        self.close_code = None

    # -- bytes in ----------------------------------------------------------
    def _read(self, n: int) -> bytes:
        chunks, got = [], 0
        while got < n:
            try:
                chunk = self.sock.recv(min(n - got, 1 << 20))
            except OSError:
                chunk = b""
            if not chunk:
                raise ConnectionClosed(1006, "the peer went away")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def _read_frame(self) -> tuple:
        b0, b1 = self._read(2)
        if b0 & 0x70:
            raise ProtocolError("reserved bits set (no extension was negotiated)")
        if not b1 & 0x80:
            raise ProtocolError("unmasked client frame")
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        mask = self._read(4)
        return bool(b0 & 0x80), b0 & 0x0F, apply_mask(self._read(n), mask)

    # -- bytes out ---------------------------------------------------------
    def _send_frame(self, opcode: int, payload: bytes) -> None:
        with self._send_lock:
            if self._close_sent:
                raise ConnectionClosed(self.close_code or 1006, "closed")
            if opcode == OP_CLOSE:
                self._close_sent = True
            try:
                self.sock.sendall(encode_frame(opcode, payload))
            except OSError as e:
                raise ConnectionClosed(1006, str(e)) from None

    def send(self, message) -> None:
        """A text (``str``) or binary (``bytes``) message."""
        if isinstance(message, str):
            self._send_frame(OP_TEXT, message.encode("utf-8"))
        else:
            self._send_frame(OP_BINARY, bytes(message))

    def recv(self):
        """The next whole message (``str`` or ``bytes``); pings are answered
        on the way.  A close frame is answered and raises
        ``ConnectionClosed``; a protocol error closes with 1002."""
        parts, kind = [], None
        while True:
            try:
                fin, op, payload = self._read_frame()
                if op >= OP_CLOSE and (not fin or len(payload) > 125):
                    raise ProtocolError("fragmented or long control frame")
            except ProtocolError as e:
                self.close(1002, str(e))
                raise ConnectionClosed(1002, str(e)) from None
            except ConnectionClosed:
                self._drop()
                raise
            if op == OP_PING:
                self._send_frame(OP_PONG, payload)
            elif op == OP_PONG:
                pass
            elif op == OP_CLOSE:
                code = struct.unpack(">H", payload[:2])[0] if len(payload) >= 2 else 1005
                reason = payload[2:].decode("utf-8", "replace")
                self.close_code = code
                if not self._close_sent:
                    try:
                        self._send_frame(OP_CLOSE, payload[:2])
                    except ConnectionClosed:
                        pass
                self._drop()
                raise ConnectionClosed(code, reason)
            elif op in (OP_TEXT, OP_BINARY) and kind is None:
                kind, parts = op, [payload]
            elif op == OP_CONT and kind is not None:
                parts.append(payload)
            else:
                self.close(1002, "unexpected frame")
                raise ConnectionClosed(1002, f"unexpected opcode {op}")
            if kind is not None and fin and op in (OP_TEXT, OP_BINARY, OP_CONT):
                data = b"".join(parts)
                return data.decode("utf-8") if kind == OP_TEXT else data

    def close(self, code: int = 1000, reason: str = "") -> None:
        """The close handshake: send a close frame, wait up to
        ``CLOSE_TIMEOUT_S`` for the peer's, then close the socket."""
        try:
            self._send_frame(OP_CLOSE, struct.pack(">H", code) + reason.encode()[:123])
        except ConnectionClosed:
            self._drop()
            return
        self.close_code = code
        self.sock.settimeout(CLOSE_TIMEOUT_S)
        try:
            while True:
                _, op, _ = self._read_frame()
                if op == OP_CLOSE:
                    break
        except (ConnectionClosed, ProtocolError, OSError):
            pass
        self._drop()

    def abort(self, code: int = 1001) -> None:
        """Send a close frame without waiting for the answer and close the
        socket: a thread blocked in ``recv`` then gets ``ConnectionClosed``."""
        try:
            self._send_frame(OP_CLOSE, struct.pack(">H", code))
        except ConnectionClosed:
            pass
        self._drop()

    def _drop(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _handshake(sock: socket.socket) -> bool:
    """Read the client's Upgrade request and answer it: 101 and True, or
    400 and False."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk or len(data) > MAX_HEADER_BYTES:
            return False
        data += chunk
    lines = data.split(b"\r\n\r\n", 1)[0].decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    ok = (lines[0].startswith("GET ")
          and headers.get("upgrade", "").lower() == "websocket"
          and "upgrade" in headers.get("connection", "").lower()
          and headers.get("sec-websocket-version") == "13"
          and "sec-websocket-key" in headers)
    if not ok:
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n")
        return False
    sock.sendall(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\nSec-WebSocket-Accept: "
                  f"{accept_key(headers['sec-websocket-key'])}\r\n\r\n").encode())
    return True


class Server:
    """Accepts connections on (host, port); ``port`` 0 takes a free one
    (``self.port`` holds the bound port)."""

    def __init__(self, handler, host: str, port: int):
        self.handler = handler
        self.sock = socket.create_server((host, port))
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set = set()
        self._lock = threading.Lock()

    def serve_forever(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                sock, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.settimeout(None)
            threading.Thread(target=self._serve, args=(sock,), daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            if not _handshake(sock):
                sock.close()
                return
        except OSError:
            sock.close()
            return
        conn = Connection(sock)
        with self._lock:
            self._conns.add(conn)
        try:
            self.handler(conn)
        finally:
            conn.close(1000)
            with self._lock:
                self._conns.discard(conn)

    def shutdown(self) -> None:
        """Stop accepting, close the listening socket and every open
        connection (code 1001, going away)."""
        self._stop.set()
        self.sock.close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.abort(1001)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
