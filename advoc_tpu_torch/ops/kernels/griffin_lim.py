"""Fast Griffin-Lim on the whole utterance: CUDA kernels and their plain version.

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

Two precisions, the JAX package's two modes (``precision``):

* ``"highest"``: ``loop_dtype="float32"`` at HIGHEST, fp32 products
  throughout. ``csrc/griffin_lim.cu``: two GEMM-shaped launches an
  iteration over all SMs, ``gl_synth_ola`` and ``gl_analyze_project``
  (fused momentum and projection epilogue), fp32 FMA on the CUDA cores.
* ``"default"``: ``loop_dtype="split_synth"``, what the JAX Vocoder runs by
  default. Synthesis rounds ``re``/``im`` to bf16 against bf16 (hi, lo)
  pairs of the inverse maps, analysis rounds ``y`` and the forward maps to
  bf16, every product accumulates in f32; the momentum and projection stay
  f32. ``csrc/griffin_lim_tc.cu``: the same two launches an iteration on
  the tensor cores (``wgmma`` fed by TMA). The final synthesis follows
  JAX's dispatch: split for T ≤ 256 without ``init_phase`` (B1), else the
  fp32 synthesis of the f32 spectrum (B2's HIGHEST tail), one launch of
  ``gl_synth_ola``.

The kernels take any ``n_fft == 4 · hop`` (hop is a launch argument), the
same AudioParams the Pallas kernels take.

Bound: the work is operations, not bytes. Per iteration and row, synthesis
is 2·(2·T·F·n_fft) FLOP and analysis 4·2·(2·T·hop·F); at B=128 × 256 frames,
F=512 and 30 iterations plus the final synthesis that is ≈4.15 TFLOP, against
a few hundred MB of carries read and written per iteration. On an H100 SXM
that is ≈4.2 ms at the 989 TFLOP/s dense bf16 rate of the tensor cores, the
card's bound for this work (split synthesis does 1.5× it); the fp32 CUDA
cores cap the ``"highest"`` kernels at ≈62 ms.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.cache import device_cache
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor

PRECISIONS = ("default", "highest")
# The JAX single-tile kernel's largest T (griffin_lim.py:60): up to it, and
# without an init phase, the split mode's final synthesis is split too.
MAX_SINGLE_TILE_FRAMES = 256


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


@device_cache(maxsize=8)
def _maps(params: AudioParams, n_bins: int, device: torch.device) -> tuple:
    """(fwd_re, fwd_im) (n_fft, F) and (inv_re, inv_im) (F, n_fft), contiguous
    float32 on ``device``, cut to the first ``n_bins`` bins."""
    c = spectral._dft_consts(params)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(m), device=device)
        for m in (c["fwd_re"][:, :n_bins], c["fwd_im"][:, :n_bins],
                  c["inv_re"][:n_bins], c["inv_im"][:n_bins])
    )


@device_cache(maxsize=16)
def _norm(params: AudioParams, t_frames: int, width: int, device: torch.device) -> Tensor:
    """:func:`_gl_norm` on ``device``, zero-padded to ``width`` columns."""
    norm = _gl_norm(params, t_frames)
    out = np.zeros((norm.shape[0], width), np.float32)
    out[:, : norm.shape[1]] = norm
    return torch.as_tensor(out, device=device)


def _bf16(x: Tensor) -> Tensor:
    """Round to bf16 (to nearest even, as JAX's cast) and back to float32."""
    return x.to(torch.bfloat16).float()


def _split(m: Tensor) -> tuple[Tensor, Tensor]:
    """The (hi, lo) bf16 pair of an f32 map, as ``_gl_maps._split``."""
    hi = _bf16(m)
    return hi, _bf16(m - hi)


@device_cache(maxsize=8)
def _split_maps(params: AudioParams, n_bins: int, device: torch.device) -> tuple:
    """The split mode's maps as float32 tensors of bf16 values: bf16 fwd_re,
    fwd_im and the (hi, lo) pairs of inv_re and inv_im."""
    fwd_re, fwd_im, inv_re, inv_im = _maps(params, n_bins, device)
    return (_bf16(fwd_re), _bf16(fwd_im), *_split(inv_re), *_split(inv_im))


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


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _split_final(t_frames: int, init_phase) -> bool:
    """JAX's dispatch (griffin_lim.py:406-418): B1's final synthesis is
    split; B2's (T > 256 or an init phase) is f32 at HIGHEST."""
    return t_frames <= MAX_SINGLE_TILE_FRAMES and init_phase is None


def griffin_lim_plain(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
    precision: str = "highest",
) -> Tensor:
    """The kernels' function in plain PyTorch: (B, T, F) → (B, T·hop).

    Batched matmuls in frames form: frames = re @ inv_re + im @ inv_im, a
    4-block overlap-add times the NOLA norm, four banded analysis matmuls,
    then the kernels' momentum and projection epilogue. ``"default"`` rounds
    the operands as the split mode does (module docstring) and keeps every
    matmul fp32: a product of two bf16 values is exact in fp32. The CPU path
    of :func:`griffin_lim_kernel` and the reference the kernels are held to.
    """
    _check_shapes(mag, params)
    _check_precision(precision)
    if mag.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("griffin_lim_plain needs allow_tf32 False (true fp32)")
    mag = mag.to(torch.float32)
    b, t, f = mag.shape
    hop, r = params.hop_length, params.n_fft // params.hop_length
    fwd_re, fwd_im, inv_re, inv_im = _maps(params, f, mag.device)
    norm = _norm(params, t, hop, mag.device)

    def ola(frames: Tensor) -> Tensor:
        frames = frames.reshape(b, t, r, hop)
        y = mag.new_zeros((b, t + r - 1, hop))
        for k in range(r):
            y[:, k : k + t] += frames[:, :, k]
        return y * norm

    def synth_f32(re: Tensor, im: Tensor) -> Tensor:
        return ola(re @ inv_re + im @ inv_im)

    if precision == "highest":
        synth, cast = synth_f32, (lambda x: x)
    else:
        fwd_re, fwd_im, re_hi, re_lo, im_hi, im_lo = _split_maps(params, f, mag.device)

        def synth(re: Tensor, im: Tensor) -> Tensor:
            rb, ib = _bf16(re), _bf16(im)
            return ola(rb @ re_hi + rb @ re_lo + ib @ im_hi + ib @ im_lo)

        cast = _bf16

    re, im = _init_carries(mag, init_phase)
    pre, pim = re, im
    for i in range(n_iters):
        y = cast(synth(re, im))
        ar = sum(y[:, k : k + t] @ fwd_re[k * hop : (k + 1) * hop] for k in range(r))
        ai = sum(y[:, k : k + t] @ fwd_im[k * hop : (k + 1) * hop] for k in range(r))
        m = 0.0 if i == 0 else momentum
        ur = ar + m * (ar - pre)
        ui = ai + m * (ai - pim)
        pre, pim = ar, ai
        scale = mag * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        re, im = ur * scale, ui * scale
    if precision == "default" and not _split_final(t, init_phase):
        synth = synth_f32
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


@functools.lru_cache(maxsize=1)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("griffin_lim_tc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gl_tc_synth.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.gl_tc_synth.restype = i
    lib.gl_tc_analyze.argtypes = [p] * 9 + [i, i, i, i, ctypes.c_float, p]
    lib.gl_tc_analyze.restype = i
    return lib


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


@device_cache(maxsize=8)
def _tc_maps(params: AudioParams, n_bins: int, device: torch.device) -> tuple[Tensor, Tensor]:
    """The tensor-core kernel's bf16 maps, zero-padded to F_pad and hop_pad
    (multiples of 64), both K-major:

    * ``ws`` (4, 2, 2, hop_pad, F_pad): ws[k, part, hl, s, f] is the hi (hl 0)
      or lo (hl 1) half of inv_re (part 0) or inv_im (part 1) at [f, k·hop + s];
    * ``wa`` (F_pad / 64, 2, 64, 4, hop_pad): wa[g, part, c, k, s] is
      bf16(fwd_re or fwd_im)[k·hop + s, 64 g + c], so each 128-row tile holds
      64 real bins then the same 64 imaginary ones.
    """
    hop, f = params.hop_length, n_bins
    fp, hp = _pad64(f), _pad64(hop)
    fwd_re, fwd_im, re_hi, re_lo, im_hi, im_lo = _split_maps(params, f, device)
    ws = torch.zeros((4, 2, 2, hp, fp), dtype=torch.float32, device=device)
    for part, pair in enumerate(((re_hi, re_lo), (im_hi, im_lo))):
        for hl, m in enumerate(pair):
            ws[:, part, hl, :hop, :f] = m.reshape(f, 4, hop).permute(1, 2, 0)
    wa = torch.zeros((fp, 2, 4, hp), dtype=torch.float32, device=device)  # (bin, part, k, s)
    for part, m in enumerate((fwd_re, fwd_im)):
        wa[:f, part, :, :hop] = m.reshape(4, hop, f).permute(2, 0, 1)
    wa = wa.reshape(fp // 64, 64, 2, 4, hp).transpose(1, 2)
    return (ws.to(torch.bfloat16).contiguous(), wa.to(torch.bfloat16).contiguous())


def _carry(x: Tensor, b: int, t: int, fp: int, dtype: torch.dtype) -> Tensor:
    """(B, T, F) → the kernel's (3 + B(T+3), F_pad) layout: three zero rows
    before each utterance, zero padded bins."""
    out = torch.zeros((3 + b * (t + 3), fp), dtype=dtype, device=x.device)
    out[3:].view(b, t + 3, fp)[:, :t, : x.shape[-1]] = x
    return out


def _uncarry(x: Tensor, b: int, t: int, f: int) -> Tensor:
    """The inverse of :func:`_carry`: (B, T, F), contiguous."""
    fp = x.shape[-1]
    return x[3:].view(b, t + 3, fp)[:, :t, :f].contiguous()


def _fp32_synth(re: Tensor, im: Tensor, params: AudioParams) -> Tensor:
    """One ``gl_synth_ola`` launch: (B, T, F) f32 spectrum → (B, T + 3, hop)."""
    b, t, f = re.shape
    hop = params.hop_length
    lib = _lib()
    _, _, inv_re, inv_im = _maps(params, f, re.device)
    norm = _norm(params, t, hop, re.device)
    y = torch.empty((b, t + 3, hop), dtype=torch.float32, device=re.device)
    code = lib.gl_synth_ola(
        re.data_ptr(), im.data_ptr(), inv_re.data_ptr(), inv_im.data_ptr(),
        norm.data_ptr(), y.data_ptr(), b, t, f, hop,
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(lib, code, "gl_synth_ola")
    griffin_lim_kernel.launches += 1
    return y


def _run_fp32(mag: Tensor, n_iters: int, momentum: float, init_phase, params: AudioParams) -> Tensor:
    b, t, f = mag.shape
    hop = params.hop_length
    lib = _lib()
    fwd_re, fwd_im, _, _ = _maps(params, f, mag.device)
    re, im = (x.contiguous() for x in _init_carries(mag, init_phase))
    pre, pim = re.clone(), im.clone()
    stream = torch.cuda.current_stream(mag.device).cuda_stream
    for i in range(n_iters):
        y = _fp32_synth(re, im, params)
        code = lib.gl_analyze_project(
            y.data_ptr(), fwd_re.data_ptr(), fwd_im.data_ptr(), mag.data_ptr(),
            re.data_ptr(), im.data_ptr(), pre.data_ptr(), pim.data_ptr(),
            b, t, f, hop, 0.0 if i == 0 else momentum, stream,
        )
        _build.check(lib, code, "gl_analyze_project")
        griffin_lim_kernel.launches += 1
    pad_blocks = (params.n_fft // 2) // hop
    return _fp32_synth(re, im, params)[:, pad_blocks : pad_blocks + t].reshape(b, t * hop)


def _run_tc(mag: Tensor, n_iters: int, momentum: float, init_phase, params: AudioParams) -> Tensor:
    b, t, f = mag.shape
    hop = params.hop_length
    fp, hp = _pad64(f), _pad64(hop)
    m_rows = b * (t + 3)
    if -(-m_rows // 128) > 65535:  # the launch grid's y limit, 128 rows a CTA
        raise ValueError("griffin_lim_kernel: too many rows for one launch")
    lib = _lib_tc()
    dev = mag.device
    ws, wa = _tc_maps(params, f, dev)
    norm = _norm(params, t, hp, dev)
    re0, im0 = _init_carries(mag, init_phase)
    re, im = _carry(re0, b, t, fp, torch.bfloat16), _carry(im0, b, t, fp, torch.bfloat16)
    magp = _carry(mag, b, t, fp, torch.float32)
    pre, pim = torch.zeros_like(magp), torch.zeros_like(magp)
    split_final = _split_final(t, init_phase)
    re32 = im32 = None
    if not split_final and n_iters > 0:
        re32, im32 = torch.zeros_like(magp), torch.zeros_like(magp)
    y = torch.empty((m_rows, hp), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def synth(out: Tensor) -> None:
        code = lib.gl_tc_synth(
            re.data_ptr(), im.data_ptr(), ws.data_ptr(), norm.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), b, t, fp, hp, stream,
        )
        _build.check(lib, code, "gl_tc_synth")
        griffin_lim_kernel.tc_launches += 1

    for i in range(n_iters):
        synth(y)
        last = i == n_iters - 1
        code = lib.gl_tc_analyze(
            y.data_ptr(), wa.data_ptr(), magp.data_ptr(), pre.data_ptr(), pim.data_ptr(),
            re.data_ptr(), im.data_ptr(),
            re32.data_ptr() if last and re32 is not None else None,
            im32.data_ptr() if last and im32 is not None else None,
            b, t, fp, hp, 0.0 if i == 0 else momentum, stream,
        )
        _build.check(lib, code, "gl_tc_analyze")
        griffin_lim_kernel.tc_launches += 1
    pad_blocks = (params.n_fft // 2) // hop
    if split_final:
        out = torch.empty((m_rows, hp), dtype=torch.float32, device=dev)
        synth(out)
        blocks = out.view(b, t + 3, hp)[:, :, :hop]
    elif n_iters == 0:
        blocks = _fp32_synth(re0.contiguous(), im0.contiguous(), params)
    else:
        blocks = _fp32_synth(_uncarry(re32, b, t, f), _uncarry(im32, b, t, f), params)
    return blocks[:, pad_blocks : pad_blocks + t].reshape(b, t * hop)


def griffin_lim_kernel(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
    precision: str = "highest",
) -> Tensor:
    """Fast G-L, (B, T, F) float32 magnitudes → (B, T·hop) waveform.

    On a CUDA tensor: ``"highest"`` runs the fp32 kernels of
    ``csrc/griffin_lim.cu``, 2·n_iters + 1 launches counted in
    ``griffin_lim_kernel.launches``; ``"default"`` runs the tensor-core
    kernels of ``csrc/griffin_lim_tc.cu``, counted in
    ``griffin_lim_kernel.tc_launches``: 2·n_iters + 1 for T ≤ 256 without
    ``init_phase``, else 2·n_iters and one fp32 ``gl_synth_ola`` (counted in
    ``launches``). All launch on ``mag``'s device, on its current stream; the wrapper raises on a
    tensor the kernels do not take or a failed launch. The kernels have no
    backward (nor has the Pallas kernel), so under grad a ``mag`` or
    ``init_phase`` that requires grad raises rather than lose its
    gradient. On a CPU tensor: the plain version, :func:`griffin_lim_plain`.
    """
    _check_shapes(mag, params)
    _check_precision(precision)
    if not mag.is_cuda:
        return griffin_lim_plain(mag, n_iters, momentum, init_phase, params, precision)
    _build.refuse_grad([mag, *(init_phase or ())], "griffin_lim_kernel",
                'spectral.griffin_lim(fft_impl="matmul")')
    if mag.dtype != torch.float32 or not mag.is_contiguous():
        raise ValueError("griffin_lim_kernel needs a contiguous float32 tensor")
    b, t, f = mag.shape
    if precision != "default" and b * (t + 3) * max(f, params.hop_length) >= 2**31:
        raise ValueError("griffin_lim_kernel indexes with 32-bit offsets")
    # The launchers set their shared-memory attribute and launch on the
    # current device: make it the tensor's.
    with torch.cuda.device(mag.device):
        run = _run_tc if precision == "default" else _run_fp32
        return run(mag, n_iters, momentum, init_phase, params)


griffin_lim_kernel.launches = 0
griffin_lim_kernel.tc_launches = 0
