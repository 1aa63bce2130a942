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

The JAX package's five loop modes (``loop_dtype``; ``precision`` names the
two that ``spectral.griffin_lim`` selects, "highest" = "float32" and
"default" = "split_synth"):

* ``"float32"``: fp32 products throughout (JAX's HIGHEST, 3-pass MXU
  products). ``csrc/griffin_lim.cu``: two launches an iteration,
  ``gl_synth_ola`` and ``gl_analyze_project`` (fused momentum and
  projection epilogue), each product 3xTF32 on the tensor cores (``wgmma``
  fed by TMA; the maps split once into TF32 big and small halves,
  :func:`_tf32_maps`, the f32 carries split in registers).
* ``"split_synth"``, ``"split"``, ``"split_anal"``, ``"bfloat16"``:
  synthesis rounds ``re``/``im`` to bf16 and analysis rounds ``y`` to bf16;
  each side's maps are either a bf16 (hi, lo) pair of the f32 map, two
  products (split), or bf16 alone (plain): split_synth splits the inverse
  maps, split both, split_anal the forward maps, bfloat16 neither. Every
  product accumulates in f32; the momentum and projection stay f32.
  ``csrc/griffin_lim_tc.cu``: the same two launches an iteration on the
  tensor cores (``wgmma`` fed by TMA), the split flag a template argument
  of each. The final synthesis follows JAX's dispatch: the loop's synthesis
  for T ≤ 256 without ``init_phase`` (B1), else the fp32 synthesis of the
  f32 spectrum (B2's HIGHEST tail), one launch of ``gl_synth_ola`` on the
  f32 copies of the carries that the last analysis writes.

The kernels take any ``n_fft == 4 · hop`` (hop is a launch argument), the
same AudioParams the Pallas kernels take.

Bound: the work is operations, not bytes. Per iteration and row, synthesis
is 2·(2·T·F·n_fft) FLOP and analysis 4·2·(2·T·hop·F); at B=128 × 256 frames,
F=512 and 30 iterations plus the final synthesis that is ≈4.15 TFLOP, against
a few hundred MB of carries read and written per iteration. On an H100 SXM
that is ≈4.2 ms at the 989 TFLOP/s dense bf16 rate of the tensor cores, the
card's bound for this work (split synthesis does 1.5× it); 3xTF32 does it
three times at the 495 TFLOP/s TF32 rate, a ceiling of ≈25 ms for the
``"float32"`` kernels (the fp32 CUDA cores would cap them at ≈62 ms).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.cache import device_cache
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels.featurizer import _tf32_split
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor

PRECISIONS = ("default", "highest")
LOOP_DTYPES = ("float32", "split_synth", "split", "split_anal", "bfloat16")
# (split analysis, split synthesis) of each bf16 mode (griffin_lim.py:165-172).
_SPLIT = {"split_synth": (False, True), "split": (True, True),
          "split_anal": (True, False), "bfloat16": (False, False)}
# The JAX single-tile kernel's largest T (griffin_lim.py:60): up to it, and
# without an init phase, the final synthesis is the loop mode's own.
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


@device_cache(maxsize=8)
def _fwd_lo(params: AudioParams, n_bins: int, device: torch.device) -> tuple[Tensor, Tensor]:
    """The lo halves of the forward maps' (hi, lo) pairs; the hi halves are
    :func:`_split_maps`' bf16 fwd_re and fwd_im."""
    fwd_re, fwd_im, _, _ = _maps(params, n_bins, device)
    return _split(fwd_re)[1], _split(fwd_im)[1]


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


def loop_mode(precision: str = "highest", loop_dtype: str | None = None) -> str:
    """The loop mode a call runs: ``loop_dtype`` where given, else the one
    ``precision`` names ("highest" → "float32", "default" → "split_synth")."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if loop_dtype is None:
        return "float32" if precision == "highest" else "split_synth"
    if loop_dtype not in LOOP_DTYPES:
        raise ValueError(f"loop_dtype must be one of {LOOP_DTYPES}, got {loop_dtype!r}")
    return loop_dtype


def _loop_final(t_frames: int, init_phase) -> bool:
    """JAX's dispatch (griffin_lim.py:406-418): B1's final synthesis is the
    loop's own; B2's (T > 256 or an init phase) is f32 at HIGHEST."""
    return t_frames <= MAX_SINGLE_TILE_FRAMES and init_phase is None


def griffin_lim_plain(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
    precision: str = "highest",
    loop_dtype: str | None = None,
) -> Tensor:
    """The kernels' function in plain PyTorch: (B, T, F) → (B, T·hop).

    Batched matmuls in frames form: frames = re @ inv_re + im @ inv_im, a
    4-block overlap-add times the NOLA norm, four banded analysis matmuls,
    then the kernels' momentum and projection epilogue. The bf16 modes
    (:func:`loop_mode`) round the operands as JAX's do (module docstring)
    and keep every matmul fp32, one for each map half: a product of two
    bf16 values is exact in fp32. The CPU path of
    :func:`griffin_lim_kernel` and the reference the kernels are held to.
    """
    _check_shapes(mag, params)
    mode = loop_mode(precision, loop_dtype)
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

    fwd = ((fwd_re,), (fwd_im,))
    if mode == "float32":
        synth, cast = synth_f32, (lambda x: x)
    else:
        split_anal, split_synth = _SPLIT[mode]
        fre, fim, re_hi, re_lo, im_hi, im_lo = _split_maps(params, f, mag.device)
        fwd = ((fre,), (fim,))
        if split_anal:
            fre_lo, fim_lo = _fwd_lo(params, f, mag.device)
            fwd = ((fre, fre_lo), (fim, fim_lo))

        def synth(re: Tensor, im: Tensor) -> Tensor:
            rb, ib = _bf16(re), _bf16(im)
            if split_synth:
                return ola(rb @ re_hi + rb @ re_lo + ib @ im_hi + ib @ im_lo)
            return ola(rb @ re_hi + ib @ im_hi)

        cast = _bf16

    def analyze(y: Tensor, maps: tuple) -> Tensor:
        return sum(y[:, k : k + t] @ m[k * hop : (k + 1) * hop] for k in range(r) for m in maps)

    re, im = _init_carries(mag, init_phase)
    pre, pim = re, im
    for i in range(n_iters):
        y = cast(synth(re, im))
        ar, ai = analyze(y, fwd[0]), analyze(y, fwd[1])
        m = 0.0 if i == 0 else momentum
        ur = ar + m * (ar - pre)
        ui = ai + m * (ai - pim)
        pre, pim = ar, ai
        scale = mag * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        re, im = ur * scale, ui * scale
    if not _loop_final(t, init_phase):
        synth = synth_f32
    pad_blocks = (params.n_fft // 2) // hop
    return synth(re, im)[:, pad_blocks : pad_blocks + t].reshape(b, t * hop)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("griffin_lim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gl_synth_ola.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.gl_synth_ola.restype = i
    lib.gl_analyze_project.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float, p]
    lib.gl_analyze_project.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("griffin_lim_tc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gl_tc_synth.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.gl_tc_synth.restype = i
    lib.gl_tc_analyze.argtypes = [p] * 10 + [i, i, i, i, i, ctypes.c_float, p]
    lib.gl_tc_analyze.restype = i
    return lib


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


@device_cache(maxsize=8)
def _tc_maps(params: AudioParams, n_bins: int,
             device: torch.device) -> tuple[Tensor, Tensor, Tensor]:
    """The tensor-core kernel's bf16 maps, zero-padded to F_pad and hop_pad
    (multiples of 64), all K-major:

    * ``ws`` (4, 2, 2, hop_pad, F_pad): ws[k, part, hl, s, f] is the hi (hl 0)
      or lo (hl 1) half of inv_re (part 0) or inv_im (part 1) at [f, k·hop + s];
      a plain synthesis reads the hi halves alone;
    * ``wa`` (F_pad / 64, 2, 64, 4, hop_pad): wa[g, part, c, k, s] is the hi
      half, bf16(fwd_re or fwd_im), at [k·hop + s, 64 g + c], so each 128-row
      tile holds 64 real bins then the same 64 imaginary ones;
    * ``wa_lo``: the lo halves in ``wa``'s layout, read by a split analysis.
    """
    hop, f = params.hop_length, n_bins
    fp, hp = _pad64(f), _pad64(hop)
    fwd_re, fwd_im, re_hi, re_lo, im_hi, im_lo = _split_maps(params, f, device)
    ws = torch.zeros((4, 2, 2, hp, fp), dtype=torch.float32, device=device)
    for part, pair in enumerate(((re_hi, re_lo), (im_hi, im_lo))):
        for hl, m in enumerate(pair):
            ws[:, part, hl, :hop, :f] = m.reshape(f, 4, hop).permute(1, 2, 0)

    def analysis_layout(re_map: Tensor, im_map: Tensor) -> Tensor:
        wa = torch.zeros((fp, 2, 4, hp), dtype=torch.float32, device=device)  # (bin, part, k, s)
        for part, m in enumerate((re_map, im_map)):
            wa[:f, part, :, :hop] = m.reshape(4, hop, f).permute(2, 0, 1)
        wa = wa.reshape(fp // 64, 64, 2, 4, hp).transpose(1, 2)
        return wa.to(torch.bfloat16).contiguous()

    return (ws.to(torch.bfloat16).contiguous(), analysis_layout(fwd_re, fwd_im),
            analysis_layout(*_fwd_lo(params, f, device)))


@device_cache(maxsize=8)
def _tf32_maps(params: AudioParams, n_bins: int, device: torch.device) -> tuple[Tensor, Tensor]:
    """The fp32 kernels' maps, each split into its TF32 (big, small) pair
    (``featurizer._tf32_split``: ``cvt.rna``'s rounding), zero-padded to
    F_pad and hop_pad, all K-major f32:

    * ``ws`` (4, 2, 2, hop_pad, F_pad): ws[k, part, bs, s, f] is the big (bs
      0) or small (bs 1) half of inv_re (part 0) or inv_im (part 1) at
      [f, k·hop + s], :func:`_tc_maps`' layout;
    * ``wa`` (2, F_pad / 64, 2, 64, 4, hop_pad): wa[bs, g, part, c, k, s] is
      the big or small half of fwd_re or fwd_im at [k·hop + s, 64 g + c], so
      each 128-row tile holds 64 real bins then the same 64 imaginary ones.
    """
    c = spectral._dft_consts(params)
    hop, f = params.hop_length, n_bins
    fp, hp = _pad64(f), _pad64(hop)
    ws = np.zeros((4, 2, 2, hp, fp), np.float32)
    wa = np.zeros((2, fp, 2, 4, hp), np.float32)  # (bs, bin, part, k, s)
    for part, name in enumerate(("re", "im")):
        for bs, m in enumerate(_tf32_split(c[f"inv_{name}"][:f])):
            ws[:, part, bs, :hop, :f] = m.reshape(f, 4, hop).transpose(1, 2, 0)
        for bs, m in enumerate(_tf32_split(c[f"fwd_{name}"][:, :f])):
            wa[bs, :f, part, :, :hop] = m.reshape(4, hop, f).transpose(2, 0, 1)
    wa = wa.reshape(2, fp // 64, 64, 2, 4, hp).transpose(0, 1, 3, 2, 4, 5)
    return (torch.as_tensor(ws, device=device),
            torch.as_tensor(np.ascontiguousarray(wa), device=device))


def _carry(x: Tensor, b: int, t: int, fp: int, dtype: torch.dtype) -> Tensor:
    """(B, T, F) → the kernel's (3 + B(T+3), F_pad) layout: three zero rows
    before each utterance, zero padded bins."""
    out = torch.zeros((3 + b * (t + 3), fp), dtype=dtype, device=x.device)
    out[3:].view(b, t + 3, fp)[:, :t, : x.shape[-1]] = x
    return out


def _fp32_synth(re: Tensor, im: Tensor, y: Tensor, n_bins: int, b: int, t: int,
                params: AudioParams) -> Tensor:
    """One ``gl_synth_ola`` launch: the f32 (3 + B(T+3), F_pad) carries
    ``re`` and ``im`` → ``y``, (B(T+3), hop_pad) f32; returns ``y``."""
    lib = _lib()
    ws, _ = _tf32_maps(params, n_bins, re.device)
    hp = y.shape[-1]
    norm = _norm(params, t, hp, re.device)
    code = lib.gl_synth_ola(re.data_ptr(), im.data_ptr(), ws.data_ptr(), norm.data_ptr(),
                            y.data_ptr(), b, t, re.shape[-1], hp,
                            torch.cuda.current_stream(re.device).cuda_stream)
    _build.check(lib, code, "gl_synth_ola")
    griffin_lim_kernel.launches += 1
    return y


def _blocks(y: Tensor, b: int, t: int, params: AudioParams) -> Tensor:
    """The (B, T·hop) waveform in a synthesis' (B(T+3), hop_pad) blocks."""
    hop = params.hop_length
    pad_blocks = (params.n_fft // 2) // hop
    return y.view(b, t + 3, -1)[:, pad_blocks : pad_blocks + t, :hop].reshape(b, t * hop)


def _run_fp32(mag: Tensor, n_iters: int, momentum: float, init_phase, params: AudioParams) -> Tensor:
    b, t, f = mag.shape
    fp, hp = _pad64(f), _pad64(params.hop_length)
    lib = _lib()
    dev = mag.device
    _, wa = _tf32_maps(params, f, dev)
    re, im = (_carry(x, b, t, fp, torch.float32) for x in _init_carries(mag, init_phase))
    magp = _carry(mag, b, t, fp, torch.float32)
    pre, pim = torch.zeros_like(magp), torch.zeros_like(magp)
    y = torch.empty((b * (t + 3), hp), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(n_iters):
        _fp32_synth(re, im, y, f, b, t, params)
        code = lib.gl_analyze_project(
            y.data_ptr(), wa.data_ptr(), magp.data_ptr(), pre.data_ptr(), pim.data_ptr(),
            re.data_ptr(), im.data_ptr(), b, t, fp, hp, 0.0 if i == 0 else momentum, stream,
        )
        _build.check(lib, code, "gl_analyze_project")
        griffin_lim_kernel.launches += 1
    return _blocks(_fp32_synth(re, im, y, f, b, t, params), b, t, params)


def _run_tc(mag: Tensor, n_iters: int, momentum: float, init_phase, params: AudioParams,
            mode: str) -> Tensor:
    b, t, f = mag.shape
    fp, hp = _pad64(f), _pad64(params.hop_length)
    m_rows = b * (t + 3)
    lib = _lib_tc()
    dev = mag.device
    split_anal, split_synth = _SPLIT[mode]
    ws, wa, wa_lo = _tc_maps(params, f, dev)
    norm = _norm(params, t, hp, dev)
    re0, im0 = _init_carries(mag, init_phase)
    re, im = _carry(re0, b, t, fp, torch.bfloat16), _carry(im0, b, t, fp, torch.bfloat16)
    magp = _carry(mag, b, t, fp, torch.float32)
    pre, pim = torch.zeros_like(magp), torch.zeros_like(magp)
    loop_final = _loop_final(t, init_phase)
    re32 = im32 = None
    if not loop_final:  # the fp32 tail's spectrum: the last analysis overwrites it
        re32, im32 = _carry(re0, b, t, fp, torch.float32), _carry(im0, b, t, fp, torch.float32)
    y = torch.empty((m_rows, hp), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def synth(out: Tensor) -> None:
        code = lib.gl_tc_synth(
            re.data_ptr(), im.data_ptr(), ws.data_ptr(), norm.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), int(split_synth), b, t, fp, hp, stream,
        )
        _build.check(lib, code, "gl_tc_synth")
        griffin_lim_kernel.tc_launches += 1

    for i in range(n_iters):
        synth(y)
        last = i == n_iters - 1
        code = lib.gl_tc_analyze(
            y.data_ptr(), wa.data_ptr(), wa_lo.data_ptr(), magp.data_ptr(), pre.data_ptr(),
            pim.data_ptr(), re.data_ptr(), im.data_ptr(),
            re32.data_ptr() if last and re32 is not None else None,
            im32.data_ptr() if last and im32 is not None else None,
            int(split_anal), b, t, fp, hp, 0.0 if i == 0 else momentum, stream,
        )
        _build.check(lib, code, "gl_tc_analyze")
        griffin_lim_kernel.tc_launches += 1
    out = torch.empty((m_rows, hp), dtype=torch.float32, device=dev)
    if loop_final:
        synth(out)
    else:
        _fp32_synth(re32, im32, out, f, b, t, params)
    return _blocks(out, b, t, params)


def griffin_lim_kernel(
    mag: Tensor,
    n_iters: int = 30,
    momentum: float = 0.99,
    init_phase: tuple[Tensor, Tensor] | None = None,
    params: AudioParams = DEFAULT_PARAMS,
    precision: str = "highest",
    loop_dtype: str | None = None,
) -> Tensor:
    """Fast G-L, (B, T, F) float32 magnitudes → (B, T·hop) waveform, in the
    loop mode :func:`loop_mode` picks from ``precision`` and ``loop_dtype``.

    On a CUDA tensor: ``"float32"`` runs the fp32 kernels of
    ``csrc/griffin_lim.cu`` (3xTF32), 2·n_iters + 1 launches counted in
    ``griffin_lim_kernel.launches``; each bf16 mode runs the tensor-core
    kernels of ``csrc/griffin_lim_tc.cu``, counted in
    ``griffin_lim_kernel.tc_launches``: 2·n_iters + 1 for T ≤ 256 without
    ``init_phase``, else 2·n_iters and one fp32 ``gl_synth_ola`` (counted in
    ``launches``). All launch on ``mag``'s device, on its current stream; the wrapper raises on a
    tensor the kernels do not take or a failed launch. The kernels have no
    backward (nor has the Pallas kernel), so under grad a ``mag`` or
    ``init_phase`` that requires grad raises rather than lose its
    gradient. On a CPU tensor: the plain version, :func:`griffin_lim_plain`.
    Traced (:func:`~advoc_tpu_torch.ops.kernels._build.traced`), it is the
    registered operator ``advoc::griffin_lim``.
    """
    _check_shapes(mag, params)
    mode = loop_mode(precision, loop_dtype)
    if _build.traced():
        from advoc_tpu_torch.ops.kernels import registered

        cos0 = sin0 = None
        if init_phase is not None:
            cos0, sin0 = (torch.broadcast_to(p.to(mag), mag.shape).contiguous()
                          for p in init_phase)
        return registered.griffin_lim_op(mag.contiguous(), cos0, sin0, n_iters, momentum, mode,
                                         registered.params_list(params))
    if not mag.is_cuda:
        return griffin_lim_plain(mag, n_iters, momentum, init_phase, params, loop_dtype=mode)
    _build.refuse_grad([mag, *(init_phase or ())], "griffin_lim_kernel",
                'spectral.griffin_lim(fft_impl="matmul")')
    return _launch(mag, n_iters, momentum, init_phase, params, mode)


def _launch(mag: Tensor, n_iters: int, momentum: float, init_phase, params: AudioParams,
            mode: str) -> Tensor:
    """The kernels of ``mode`` on a CUDA tensor (``advoc::griffin_lim``'s
    CUDA implementation, and the eager wrapper's)."""
    if mag.dtype != torch.float32 or not mag.is_contiguous():
        raise ValueError("griffin_lim_kernel needs a contiguous float32 tensor")
    b, t, _ = mag.shape
    if -(-(b * (t + 3)) // 128) > 65535:  # both libraries' grid y limit, 128 rows a CTA
        raise ValueError("griffin_lim_kernel: too many rows for one launch")
    # The launchers set their shared-memory attribute and launch on the
    # current device: make it the tensor's.
    with torch.cuda.device(mag.device):
        if mode == "float32":
            return _run_fp32(mag, n_iters, momentum, init_phase, params)
        return _run_tc(mag, n_iters, momentum, init_phase, params, mode)


griffin_lim_kernel.launches = 0
griffin_lim_kernel.tc_launches = 0
