"""Audio I/O: decode WAV (whole or a slice) to float32 mono, read a
header's length and rate, resample, save float samples as 16-bit WAV.

The port of ``advoc_tpu.data.audioio``. Reads and writes go through the
native codec (:mod:`advoc_tpu_torch.data.native`, the port's copy of
``wavio.cc``, built with g++ at first use), which also reads IEEE float
WAVs; where it is unavailable, or cannot parse a file, through the stdlib
``wave`` module and numpy, as the JAX package falls back. The same samples
either way, ``k / 32768`` for PCM16. :func:`save_as_wav` writes the JAX
package's bytes: the 44-byte PCM header and ``round(clip(x, -1, 1) ·
32767)`` samples, the convention of the streaming vocoder's int16 emit.
"""

from __future__ import annotations

import ctypes
import pathlib
import wave
from math import gcd

import numpy as np

from advoc_tpu_torch.data import native


def _float_p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _native_info(path: str) -> tuple[int, int]:
    """(n_frames, sample_rate) from the native parser; ValueError if it
    cannot parse the file."""
    sr, ch, nf, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    rc = native.load().advoc_wav_info(path.encode(), sr, ch, nf, bits)
    if rc != 0:
        raise ValueError(f"cannot parse wav {path!r} (rc={rc})")
    return nf.value, sr.value


def _decode_native(path: str, start: int, count: int | None) -> tuple[np.ndarray, int]:
    n, sr = _native_info(path)
    start = min(start, n)
    count = n - start if count is None else min(count, n - start)
    out = np.empty(count, dtype=np.float32)
    got = native.load().advoc_wav_decode_slice(path.encode(), start, count, _float_p(out))
    if got < 0:
        raise ValueError(f"decode failed for {path!r} (rc={got})")
    return out[:got], sr


def _decode(path: str, start: int = 0, count: int | None = None) -> tuple[np.ndarray, int]:
    """Frames [start, start + count) (all from ``start`` when count is None)."""
    try:
        return _decode_native(path, start, count)
    except (native.NativeUnavailable, ValueError):
        return _decode_wave(path, start, count)


def _decode_wave(path: str, start: int, count: int | None) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        n = w.getnframes()
        start = min(start, n)
        w.setpos(start)
        raw = w.readframes(n - start if count is None else min(count, n - start))
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v & 0x800000, v - (1 << 24), v)
        x = v.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path!r}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy)."""
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def decode_audio(path: str | pathlib.Path, target_sample_rate: int | None = None,
                 normalize: bool = False) -> np.ndarray:
    """Decode a WAV file to mono float32 in [-1, 1], resampled to
    ``target_sample_rate`` if given; ``normalize`` rescales to a 0.95 peak
    (a silent file stays silent)."""
    x, sr = _decode(str(path))
    if target_sample_rate is not None and sr != target_sample_rate:
        x = resample(x, sr, target_sample_rate)
    if normalize:
        peak = np.abs(x).max()
        if peak > 0:
            x = x * (0.95 / peak)
    return np.ascontiguousarray(x, dtype=np.float32)


def decode_audio_slice(path: str | pathlib.Path, start: int, count: int) -> np.ndarray:
    """Frames [start, start + count) as float32 mono, zero-padded past the
    end of the file; only those frames are read."""
    x, _ = _decode(str(path), start, count)
    out = np.zeros(count, dtype=np.float32)
    out[: len(x)] = x
    return out


def wav_num_frames(path: str | pathlib.Path) -> tuple[int, int]:
    """(n_frames, sample_rate) from the header, without decoding samples."""
    try:
        return _native_info(str(path))
    except (native.NativeUnavailable, ValueError):
        with wave.open(str(path), "rb") as w:
            return w.getnframes(), w.getframerate()


def save_as_wav(x, path: str | pathlib.Path, sample_rate: int = 22050) -> None:
    """Save mono float32 samples as 16-bit PCM WAV, each the nearest of
    ``clip(x, -1, 1) · 32767`` (ties to even, as C's ``lrintf``)."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32).reshape(-1))
    try:
        if native.load().advoc_wav_write(str(path).encode(), _float_p(x), len(x),
                                         sample_rate) == 0:
            return
    except native.NativeUnavailable:
        pass
    pcm = np.round(np.clip(x, -1.0, 1.0) * np.float32(32767.0)).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
