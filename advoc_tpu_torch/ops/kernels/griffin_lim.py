"""Fast Griffin-Lim on the whole utterance: a CUDA kernel and its plain version.

Replaces the two Pallas kernels of the JAX package's main path:

* ``advoc_tpu/ops/pallas/griffin_lim.py:griffin_lim_pallas`` (B1), the whole
  fast-G-L loop for one chunk of up to 256 frames per grid step, every carry
  resident in VMEM;
* ``advoc_tpu/ops/pallas/griffin_lim.py:griffin_lim_pallas_tiled`` (B2), the
  same iteration on 256-frame tiles with 32-frame halos, which exists only to
  bound VMEM; its tile centers equal B1's whole-utterance iteration.

Both compute one function: fast G-L on the *uncropped* overlap-add signal.
Each iteration synthesizes through the windowed inverse-DFT maps,
overlap-adds in hop blocks with the NOLA norm, re-analyzes as four banded
matmuls over shifted block views, takes the momentum step (none on iteration
0) and projects onto the magnitude with ``rsqrt(u_re² + u_im² + 1e-12)``.
After ``n_iters`` one more synthesis gives blocks [2, 2 + T) of the signal,
i.e. (B, T·hop) samples. Rows outside [0, T) have zero magnitude and norm 0
in B2's halos, so iterating on the whole utterance at once is B2's function
as well as B1's, for any T, with or without ``init_phase``.

Design on Hopper (``csrc/griffin_lim.cu``): a chunk's state (four (T, F)
fp32 carries, 2 MB at T=256, F=512, plus 8 MB of maps) does not fit one SM's
227 KB of shared memory, so the carries live in device memory and each
iteration is two GEMM-shaped launches over all SMs, ``gl_synth_ola`` and
``gl_analyze_project`` (fused momentum and projection epilogue). The kernels
are plain fp32 FMA with shared-memory tiling. Keeping the carries resident
in L2 or shared memory across iterations, and moving the products onto the
tensor cores, is left to a later change.

The kernels take any ``n_fft == 4 · hop`` (hop is a launch argument), the
same AudioParams the Pallas kernels take.

Bound: the work is operations, not bytes. Per iteration and row, synthesis
is 2·(2·T·F·n_fft) FLOP and analysis 4·2·(2·T·hop·F); at B=128 × 256 frames,
F=512 and 30 iterations plus the final synthesis that is ≈4.15 TFLOP, against
a few hundred MB of carries read and written per iteration. On an H100 SXM
that is ≈4.2 ms at the 989 TFLOP/s dense bf16 rate of the tensor cores, the
card's bound for this work; the fp32 CUDA cores that these kernels use
(67 TFLOP/s) cap them at ≈62 ms.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor


@functools.lru_cache(maxsize=16)
def _gl_norm(params: AudioParams, t_frames: int) -> np.ndarray:
    """1 / window-sum of the UNcropped overlap-add signal of ``t_frames``
    windows, as (t_frames + r − 1, hop) blocks (float64 → float32)."""
    n_fft, hop = params.n_fft, params.hop_length
    n_blocks = t_frames + n_fft // hop - 1
    wsq = spectral._consts(params)["window_sq"]
    wsum = np.zeros(n_blocks * hop, np.float64)
    for i in range(t_frames):
        wsum[i * hop : i * hop + n_fft] += wsq
    return (1.0 / np.maximum(wsum, 1e-11)).reshape(n_blocks, hop).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _maps(params: AudioParams, n_bins: int, device: torch.device) -> tuple:
    """(fwd_re, fwd_im) (n_fft, F) and (inv_re, inv_im) (F, n_fft), contiguous
    float32 on ``device``, cut to the first ``n_bins`` bins."""
    c = spectral._dft_consts(params)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(m), device=device)
        for m in (c["fwd_re"][:, :n_bins], c["fwd_im"][:, :n_bins],
                  c["inv_re"][:n_bins], c["inv_im"][:n_bins])
    )


def _init_carries(mag: Tensor, init_phase) -> tuple[Tensor, Tensor]:
    if init_phase is None:
        return mag.clone(), torch.zeros_like(mag)
    cos0, sin0 = (torch.broadcast_to(p.to(mag), mag.shape) for p in init_phase)
    return mag * cos0, mag * sin0


def _check_shapes(mag: Tensor, params: AudioParams) -> None:
    if mag.ndim != 3:
        raise ValueError(f"mag must be (B, T, F), got {tuple(mag.shape)}")
    if mag.shape[-1] not in (params.n_freq, params.n_freq - 1):
        raise ValueError(f"F must be {params.n_freq} or {params.n_freq - 1}")
    if params.n_fft % params.hop_length or params.n_fft // params.hop_length != 4:
        raise ValueError("fast G-L needs n_fft == 4 · hop_length")


def griffin_lim_plain(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
) -> Tensor:
    """The kernel's function in plain PyTorch fp32: (B, T, F) → (B, T·hop).

    Batched matmuls in frames form: frames = re @ inv_re + im @ inv_im, a
    4-block overlap-add times the NOLA norm, four banded analysis matmuls,
    then the kernel's momentum and projection epilogue. The CPU path of
    :func:`griffin_lim_kernel` and the reference the kernel is held to.
    """
    _check_shapes(mag, params)
    if mag.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("griffin_lim_plain needs allow_tf32 False (true fp32)")
    mag = mag.to(torch.float32)
    b, t, f = mag.shape
    hop, r = params.hop_length, params.n_fft // params.hop_length
    fwd_re, fwd_im, inv_re, inv_im = _maps(params, f, mag.device)
    norm = torch.as_tensor(_gl_norm(params, t), device=mag.device)

    def synth(re: Tensor, im: Tensor) -> Tensor:
        frames = (re @ inv_re + im @ inv_im).reshape(b, t, r, hop)
        y = mag.new_zeros((b, t + r - 1, hop))
        for k in range(r):
            y[:, k : k + t] += frames[:, :, k]
        return y * norm

    re, im = _init_carries(mag, init_phase)
    pre, pim = re, im
    for i in range(n_iters):
        y = synth(re, im)
        ar = sum(y[:, k : k + t] @ fwd_re[k * hop : (k + 1) * hop] for k in range(r))
        ai = sum(y[:, k : k + t] @ fwd_im[k * hop : (k + 1) * hop] for k in range(r))
        m = 0.0 if i == 0 else momentum
        ur = ar + m * (ar - pre)
        ui = ai + m * (ai - pim)
        pre, pim = ar, ai
        scale = mag * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        re, im = ur * scale, ui * scale
    pad_blocks = (params.n_fft // 2) // hop
    return synth(re, im)[:, pad_blocks : pad_blocks + t].reshape(b, t * hop)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("griffin_lim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gl_synth_ola.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.gl_synth_ola.restype = i
    lib.gl_analyze_project.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.gl_analyze_project.restype = i
    return lib


def griffin_lim_kernel(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
) -> Tensor:
    """Fast G-L, (B, T, F) float32 magnitudes → (B, T·hop) waveform.

    On a CUDA tensor: the CUDA kernels, 2·n_iters + 1 launches on the current
    stream, each counted in ``griffin_lim_kernel.launches``; it raises on a
    tensor the kernels do not take or a failed launch. On a CPU tensor: the
    plain version, :func:`griffin_lim_plain`.
    """
    _check_shapes(mag, params)
    if not mag.is_cuda:
        return griffin_lim_plain(mag, n_iters, momentum, init_phase, params)
    if mag.dtype != torch.float32 or not mag.is_contiguous():
        raise ValueError("griffin_lim_kernel needs a contiguous float32 tensor")
    b, t, f = mag.shape
    hop = params.hop_length
    if b * (t + 3) * max(f, hop) >= 2**31:
        raise ValueError("griffin_lim_kernel indexes with 32-bit offsets")
    lib = _lib()
    dev = mag.device
    fwd_re, fwd_im, inv_re, inv_im = _maps(params, f, dev)
    norm = torch.as_tensor(_gl_norm(params, t), device=dev)
    re, im = (x.contiguous() for x in _init_carries(mag, init_phase))
    pre, pim = re.clone(), im.clone()
    y = torch.empty((b, t + 3, hop), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def synth() -> None:
        code = lib.gl_synth_ola(
            re.data_ptr(), im.data_ptr(), inv_re.data_ptr(), inv_im.data_ptr(),
            norm.data_ptr(), y.data_ptr(), b, t, f, hop, stream,
        )
        _build.check(lib, code, "gl_synth_ola")
        griffin_lim_kernel.launches += 1

    for i in range(n_iters):
        synth()
        code = lib.gl_analyze_project(
            y.data_ptr(), fwd_re.data_ptr(), fwd_im.data_ptr(), mag.data_ptr(),
            re.data_ptr(), im.data_ptr(), pre.data_ptr(), pim.data_ptr(),
            b, t, f, hop, 0.0 if i == 0 else momentum, stream,
        )
        _build.check(lib, code, "gl_analyze_project")
        griffin_lim_kernel.launches += 1
    synth()
    pad_blocks = (params.n_fft // 2) // hop
    return y[:, pad_blocks : pad_blocks + t].reshape(b, t * hop)


griffin_lim_kernel.launches = 0
