"""Build, load and launch the CUDA sources under ``advoc_tpu_torch/csrc``,
and choose for each call which implementation of a hand-written kernel runs.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``, into
``advoc_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the sources and the compile command: an edited source is rebuilt.

A kernel is wired in by two declarations in its module, and nowhere else: a
:class:`Library` (the source, its entry points' argument types, the key its
launches are counted under in :data:`launches`; built and loaded at its
first launch) and a :func:`kernel` (its plain PyTorch version, its launch,
its registered operator, :mod:`.registered`, and whether it stands for a
Pallas kernel of the JAX package). A call goes, in this order:

1. while traced (:func:`traced`), to the registered operator; inside
   :func:`plain_when_traced` a kernel that stands for no Pallas kernel
   traces as its plain version instead;
2. on the CPU, to the plain version;
3. on the card, to a refusal where autograd would record the call
   (:func:`records`: no kernel has a backward, so the gradient would stop
   there silently), else to the launch.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
PTR, INT, INT64, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# By each Library's counter key; and "conv_bias_folded", the GroupNorm pairs
# launched with a convolution's bias (ops/kernels/group_norm.py, at the launch).
launches: collections.Counter = collections.Counter()
_plain_traced = False


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


def bind(lib: ctypes.CDLL, **entries: list) -> dict:
    """Each of ``entries`` (name → argument types before the stream) and
    ``error_string`` of ``lib``, typed, by name."""
    lib.error_string.argtypes = [INT]
    lib.error_string.restype = ctypes.c_char_p
    for entry, args in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = [*args, PTR]
        fn.restype = INT
    return {e: getattr(lib, e) for e in (*entries, "error_string")}


class Library:
    """``csrc/<name>.cu``: each call of an entry point adds ``per_call``
    kernels to ``launches[counter]``; ``entries``: entry point → its argument
    types. Every entry point takes the stream last (left out here) and
    returns ``cudaGetLastError()``. Loaded at the first launch."""

    def __init__(self, name: str, counter: str, per_call: int = 1, **entries: list):
        self.name, self.counter, self.per_call, self.entries = name, counter, per_call, entries
        self._fns: dict | None = None  # :func:`bind`'s, at the first launch

    def _load(self) -> dict:
        """Built first if needed (:func:`build` is safe to race)."""
        self._fns = bind(ctypes.CDLL(str(build(self.name))), **self.entries)
        return self._fns

    def launch(self, device: torch.device, entry: str, *args) -> None:
        """Launch ``entry`` once on ``device``'s current raw stream, the device
        made current only where it is not; raise on a nonzero code; count."""
        fns = self._fns or self._load()
        index = device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch.cuda.current_device():
            code = fns[entry](*args, stream)
        else:  # the launchers launch on the current device
            with torch.cuda.device(index):
                code = fns[entry](*args, stream)
        if code:
            raise _failed(fns, entry, code)
        launches[self.counter] += self.per_call

    def on(self, device: torch.device) -> Callable[..., None]:
        """:meth:`launch` for a loop of launches (G-L's 2·n_iters + 1):
        ``go(entry, *args)``, with the stream and the device read once here,
        costs one frame a launch."""
        fns = self._fns or self._load()
        index = device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        switch = index != torch.cuda.current_device()
        counter, per_call = self.counter, self.per_call

        def go(entry: str, *args) -> None:
            if switch:
                with torch.cuda.device(index):
                    code = fns[entry](*args, stream)
            else:
                code = fns[entry](*args, stream)
            if code:
                raise _failed(fns, entry, code)
            launches[counter] += per_call

        return go


def _failed(fns: dict, entry: str, code: int) -> RuntimeError:
    return RuntimeError(f"{entry} failed: CUDA error {code} ({fns['error_string'](code).decode()})")


def kernel(name: str, *, plain: Callable, launch: Callable, op: Callable, pallas: bool,
           instead: str) -> Callable:
    """A kernel's dispatch by the rule above: the function its wrapper calls
    with its arguments, the first the tensor whose device decides.
    ``plain``, ``launch`` and ``op`` (the call of its registered operator)
    take those arguments; ``pallas`` is a constant of the kernel; ``name``
    and ``instead`` (the differentiable path) word the refusal."""

    def dispatch(*args):
        if torch.compiler.is_compiling():
            return op(*args) if pallas or not _plain_traced else plain(*args)
        if not args[0].is_cuda:
            return plain(*args)
        if torch.is_grad_enabled() and records(args):
            raise NotImplementedError(
                f"{name} runs a CUDA kernel that has no backward: call it under no_grad or on "
                f"tensors that need no gradient, or differentiate {instead}")
        return launch(*args)

    return dispatch


def records(tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (tensors or tuples
    of them; anything else is skipped): grad on and one requires it."""
    return torch.is_grad_enabled() and any(
        records(t) if isinstance(t, tuple) else isinstance(t, torch.Tensor) and t.requires_grad
        for t in tensors)


def traced() -> bool:
    """True while the caller is traced (``torch.export``, ``torch.compile``):
    a trace records an operator, never a ctypes launch."""
    return torch.compiler.is_compiling()


@contextlib.contextmanager
def plain_when_traced():
    """Inside, a traced :func:`kernel` that stands for no Pallas kernel (the
    U-Net's GroupNorm, WaveGAN's epilogue) records its plain aten ops, so a
    program traced on the card loads without the operators (``export_vocoder``
    without ``allow_custom_calls``). Eager calls still launch."""
    global _plain_traced
    before, _plain_traced = _plain_traced, True
    try:
        yield
    finally:
        _plain_traced = before
