"""Blocking client of the streaming vocoder server.

The port's copy of ``advoc_tpu.serve.client`` (framework-free; it works
with a server of either package). One socket leases one stream slot on the
server. The client is synchronous, one outstanding push per connection, the
server's per-slot contract; run many clients from threads or processes for
concurrency.
"""

from __future__ import annotations

import json
import socket

import numpy as np

from advoc_tpu_torch.serve import protocol as pr


class VocodeClient:
    """Connect, lease a slot, and vocode mel chunks over TCP.

    ``config`` (from the server's CONFIG frame) carries the serving
    contract: chunk_frames × n_mels input in ``mel_dtype``,
    ``emit_samples`` output samples per push in ``emit_dtype``, plus the
    stream-start fields (``preroll_samples``, ``latency_frames``,
    ``flush_samples``) the caller drops once per utterance, as with
    :class:`advoc_tpu_torch.infer.StreamingVocoder`.
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        op, payload = pr.read_frame_sync(self._sock)
        if op == pr.OP_ERR:
            raise ConnectionError(payload.decode())
        if op != pr.OP_CONFIG:
            raise ConnectionError(f"expected CONFIG, got op {op}")
        self.config = json.loads(payload.decode())
        self._mel_dtype = np.dtype(self.config["mel_dtype"])
        self._emit_dtype = np.dtype(self.config["emit_dtype"])

    @property
    def slot(self) -> int:
        return self.config["slot"]

    def _pcm_reply(self) -> np.ndarray:
        op, payload = pr.read_frame_sync(self._sock)
        if op == pr.OP_ERR:
            raise RuntimeError(payload.decode())
        if op != pr.OP_PCM:
            raise RuntimeError(f"expected PCM, got op {op}")
        return np.frombuffer(payload, self._emit_dtype)

    def vocode(self, mel_chunk: np.ndarray) -> np.ndarray:
        """(chunk_frames, n_mels) mel → (emit_samples,) waveform samples."""
        mel = np.ascontiguousarray(mel_chunk, dtype=self._mel_dtype)
        want = (self.config["chunk_frames"], self.config["n_mels"])
        if mel.shape != want:
            raise ValueError(f"mel chunk must be {want}, got {mel.shape}")
        self._sock.sendall(pr.pack(pr.OP_PUSH, mel.tobytes()))
        return self._pcm_reply()

    def flush(self) -> np.ndarray:
        """End the current utterance: the stream's pending
        ``config["flush_samples"]`` samples; the slot is then reset. A whole
        utterance is ``concat(pushes) + flush()`` with the first
        ``flush_samples`` dropped, cropped to the true length."""
        self._sock.sendall(pr.pack(pr.OP_FLUSH))
        return self._pcm_reply()

    def reset(self) -> None:
        """Start a new utterance in this slot (applies before the next
        push; no reply frame)."""
        self._sock.sendall(pr.pack(pr.OP_RESET))

    def close(self) -> None:
        try:
            self._sock.sendall(pr.pack(pr.OP_BYE))
        except OSError:
            pass
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
