"""Build the CUDA sources under ``advoc_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``. The library goes
into ``advoc_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the sources and the compile command, so an edited source
is rebuilt and an unchanged one is loaded as it is. Only the repository's own
sources are built. :func:`check` turns a launch's error code into an
exception; :func:`refuse_grad` refuses a call that autograd would record
through a kernel without a backward; :func:`traced` tells a wrapper to call
its registered operator (:mod:`.registered`) instead of launching.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return [src, *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; raise with the
    compiler's output on a failure. Returns the library's path."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaGetLastError()``.
    Every library exports ``error_string(code)`` for the message."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def refuse_grad(tensors, kernel: str, instead: str) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and any of
    ``tensors`` (a tensor or a list) requires it: ``kernel`` has no backward
    (no more than the JAX package's Pallas kernel, which has no
    ``custom_vjp``), so the gradient would stop there without an error.
    ``instead`` names the differentiable path to use."""
    tensors = [tensors] if isinstance(tensors, torch.Tensor) else tensors
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} runs a CUDA kernel that has no backward: call it under no_grad or "
            f"on tensors that need no gradient, or differentiate {instead}")


def traced() -> bool:
    """True while the caller is traced (``torch.export``, ``torch.compile``;
    ``torch.compiler.is_compiling()`` reports both): a wrapper then calls
    its ``torch.ops.advoc`` operator, which a trace can record, instead of
    a ctypes launch."""
    return torch.compiler.is_compiling()
