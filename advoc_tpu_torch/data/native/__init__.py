"""ctypes bindings of the native WAV codec (``wavio.cc``), built with g++.

The port's counterpart of ``advoc_tpu.data.native``. :func:`load` compiles
``wavio.cc`` on first use into ``advoc_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source and the compile
command, and returns the library. It raises :class:`NativeUnavailable`
where there is no ``g++``, the build fails, or ``ADVOC_TPU_NO_NATIVE`` is
set; :mod:`advoc_tpu_torch.data.audioio` then reads and writes with the
stdlib ``wave`` module, as the JAX package falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_SRC = pathlib.Path(__file__).resolve().parent / "wavio.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("native wavio unavailable: no g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *FLAGS, "-o", tmp, str(_SRC)], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"native wavio unavailable: g++ failed:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """Build (if needed) and return the library."""
    global _LIB
    if os.environ.get("ADVOC_TPU_NO_NATIVE"):
        raise NativeUnavailable("ADVOC_TPU_NO_NATIVE is set")
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"native wavio unavailable: {e}") from e
        c_int_p, c_long_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)
        c_float_p = ctypes.POINTER(ctypes.c_float)
        lib.advoc_wav_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_long_p, c_int_p]
        lib.advoc_wav_info.restype = ctypes.c_int
        lib.advoc_wav_decode.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long]
        lib.advoc_wav_decode.restype = ctypes.c_long
        lib.advoc_wav_decode_slice.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                               c_float_p]
        lib.advoc_wav_decode_slice.restype = ctypes.c_long
        lib.advoc_wav_write.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long, ctypes.c_int]
        lib.advoc_wav_write.restype = ctypes.c_int
        _LIB = lib
        return _LIB
