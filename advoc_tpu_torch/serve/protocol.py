"""Wire protocol of the streaming vocoder server.

The port's copy of ``advoc_tpu.serve.protocol``, byte for byte the same
format, so a client of either package talks to a server of the other.
Length-prefixed binary frames over TCP: a 4-byte big-endian length N
followed by N bytes, of which the first is the opcode and the rest the
payload. One mel chunk goes up and one PCM chunk comes down; the fixed
shapes are negotiated once at connect time by the CONFIG frame (JSON),
because a :class:`StreamingVocoder` push has one fixed shape.
"""

from __future__ import annotations

import asyncio
import socket
import struct

# server → client
OP_CONFIG = 0  # JSON utf-8: slot, shapes, dtypes, latency contract
OP_PCM = 2  # emitted samples for the client's last PUSH (emit_dtype)
OP_ERR = 4  # utf-8 error text; the server closes after sending

# client → server
OP_PUSH = 1  # one mel chunk, raw (chunk_frames, n_mels) in mel_dtype
OP_RESET = 3  # start a new utterance in this client's slot (no reply)
OP_BYE = 5  # polite close
OP_FLUSH = 6  # end of utterance: reply = one PCM frame with the stream's
#               pending flush_samples (see CONFIG), then the slot is reset;
#               without it a client's final samples are lost (the engine
#               holds the overlap tail)

_LEN = struct.Struct(">I")
MAX_FRAME = 64 << 20  # sanity bound: no legitimate frame approaches 64 MB


def pack(op: int, payload: bytes = b"") -> bytes:
    return _LEN.pack(1 + len(payload)) + bytes([op]) + payload


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    """Read one frame; raises IncompleteReadError on EOF."""
    (n,) = _LEN.unpack(await reader.readexactly(4))
    if not 1 <= n <= MAX_FRAME:
        raise ValueError(f"bad frame length {n}")
    body = await reader.readexactly(n)
    return body[0], body[1:]


def read_frame_sync(sock: socket.socket) -> tuple[int, bytes]:
    """Blocking counterpart of :func:`read_frame` for the sync client."""
    head = _recv_exactly(sock, 4)
    (n,) = _LEN.unpack(head)
    if not 1 <= n <= MAX_FRAME:
        raise ValueError(f"bad frame length {n}")
    body = _recv_exactly(sock, n)
    return body[0], body[1:]


def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("server closed the connection")
        buf.extend(part)
    return bytes(buf)
