"""Spectral core in PyTorch: STFT, r9y9 mel, heuristic inversion, fast G-L.

The port of ``advoc_tpu.ops.spectral``. Host constants (Hann window, mel
filterbank and its pseudo-inverse, DFT maps, NOLA norm) are built in float64
numpy exactly as the JAX package builds them and moved to the input's device
as float32. Every matrix product here is true fp32 (on the card that needs
``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default, matching
the JAX package's ``Precision.HIGHEST``), except the loop of
``griffin_lim(fft_impl="matmul", precision="default")``, which takes bf16
operands with fp32 accumulation, JAX's single-pass ``Precision.DEFAULT``.

Phase recovery (:func:`griffin_lim`) has three forms:

* ``fft_impl="matmul"``: the twin of the JAX scan. Each iteration
  synthesizes through the windowed inverse-DFT maps, overlap-adds, crops to
  the signal, reflect-pads and re-analyzes; no momentum on iteration 0.
* ``fft_impl="fft"``: the same iteration through :func:`istft` and
  :func:`stft` (cuFFT on the card, as ``jnp.fft`` is in the JAX package).
* ``fft_impl="kernel"``: the CUDA fast-G-L kernels of
  :mod:`advoc_tpu_torch.ops.kernels.griffin_lim` (their plain version on the
  CPU), the counterpart of the JAX ``fft_impl="pallas"``: they iterate on
  the uncropped overlap-add signal, optionally on 512 bins
  (``drop_nyquist``), at ``precision`` "default" (JAX's split_synth, the
  tensor-core kernel) unless "highest" (fp32 throughout) is asked for.

Only the matmul form returns the final phase (``return_final_phase``), as
in the JAX package: the streaming engine carries it from chunk to chunk.
:func:`pghi_init_phase` is the magnitude-only starting phase of
``Vocoder(phase_init="pghi")``.

LWS (Local Weighted Sums, Le Roux 2010) updates each frame's phase to that
of its truncated consistency sum over the 2Q−1 frames around it (Q = n_fft
// hop), magnitude pinned: :func:`lws` (Gauss-Seidel sweeps over the whole
utterance, sequential or on the chromatic schedule), :func:`lws_online` and
:func:`lws_online_push` (frames arriving one at a time, ``look_ahead``
frames of latency), and :func:`lws_block_push` (a whole chunk per arrival,
multicolor sweeps). The streaming forms hand their frames to the streaming
iSTFT (:func:`istft_stream_push`). The one-call vocoders
(:func:`r9y9_melspec_to_waveform` and the ``magspec_to_waveform_*``
functions) compose these.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from advoc_tpu_torch.ops import reference as ref
from advoc_tpu_torch.ops.cache import device_cache
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Host constants (float64 numpy; float32 tensors on the caller's device).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _consts(params: AudioParams) -> dict:
    win = ref.hann_window(params.win_length)
    if params.win_length < params.n_fft:
        lpad = (params.n_fft - params.win_length) // 2
        win = np.pad(win, (lpad, params.n_fft - params.win_length - lpad))
    fb = ref.create_mel_filterbank(params)  # (M, F)
    inv = np.linalg.pinv(fb)  # (F, M)
    return {
        "window": win,
        "window_sq": win * win,
        "mel_fb_t": fb.T.copy(),  # (F, M)
        "mel_pinv_t": inv.T.copy(),  # (M, F)
        "mel_colsum": fb.sum(axis=0),  # (F,) filterbank weight per bin
    }


@functools.lru_cache(maxsize=8)
def _dft_consts(params: AudioParams) -> dict:
    """Windowed DFT maps, float32: fwd_re/fwd_im (n_fft, F) take windowed
    frames to the spectrum; inv_re/inv_im (F, n_fft) take the spectrum to
    windowed time frames (irfft applied to unit vectors, synthesis window
    folded in)."""
    n_fft = params.n_fft
    n_freq = params.n_freq
    win = np.asarray(_consts(params)["window"])
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    fwd_re = (win[:, None] * np.cos(ang)).astype(np.float32)
    fwd_im = (win[:, None] * -np.sin(ang)).astype(np.float32)
    eye = np.eye(n_freq)
    inv_re = np.fft.irfft(eye, n=n_fft, axis=1)
    inv_im = np.fft.irfft(1j * eye, n=n_fft, axis=1)
    inv_re = (inv_re * win[None, :]).astype(np.float32)
    inv_im = (inv_im * win[None, :]).astype(np.float32)
    return {"fwd_re": fwd_re, "fwd_im": fwd_im, "inv_re": inv_re, "inv_im": inv_im}


@functools.lru_cache(maxsize=64)
def _nola_norm(params: AudioParams, n_frames: int, length: int) -> np.ndarray:
    """1 / window-sum of the cropped overlap-add signal (float64 → float32)."""
    wsq = _consts(params)["window_sq"]
    total = params.n_fft + (n_frames - 1) * params.hop_length
    wsum = np.zeros(total, dtype=np.float64)
    for i in range(n_frames):
        wsum[i * params.hop_length : i * params.hop_length + params.n_fft] += wsq
    pad = params.n_fft // 2
    wsum = wsum[pad : pad + length]
    return (1.0 / np.maximum(wsum, 1e-11)).astype(np.float32)


@device_cache(maxsize=64)
def _nola_norm_on(params: AudioParams, n_frames: int, length: int, device: torch.device) -> Tensor:
    """:func:`_nola_norm` on ``device``, moved there once: a copy from the
    host on every overlap-add would make the host wait for the card."""
    return torch.as_tensor(_nola_norm(params, n_frames, length), device=device)


@device_cache(maxsize=64)
def _const(params: AudioParams, name: str, device: torch.device) -> Tensor:
    """A named entry of :func:`_consts` / :func:`_dft_consts` as float32 on
    ``device``, moved there once."""
    table = {**_consts(params), **_dft_consts(params)}
    return torch.as_tensor(table[name], dtype=torch.float32, device=device)


@device_cache(maxsize=64)
def _const_bf16(params: AudioParams, name: str, device: torch.device) -> Tensor:
    """:func:`_const` rounded to bfloat16 (to nearest even), moved once: in
    bfloat16 on the card, as float32 holding the rounded values on the CPU
    (see :func:`_dft_matmul`)."""
    w = _const(params, name, device).to(torch.bfloat16)
    return w if device.type == "cuda" else w.float()


@device_cache(maxsize=64)
def _stream_wsum(params: AudioParams, c: int, device: torch.device) -> Tensor:
    """Window-sum of ``c`` overlap-added frames (float64 → float32): the
    static per-push profile of :func:`istft_stream_push`, moved once."""
    hop = params.hop_length
    wstat = np.zeros(((c + params.n_fft // hop - 1) * hop,), np.float64)
    for i in range(c):
        wstat[i * hop : i * hop + params.n_fft] += _consts(params)["window_sq"]
    return torch.as_tensor(wstat, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Framing / overlap-add (batched over one leading dim).
# ---------------------------------------------------------------------------


def _frame(xp: Tensor, params: AudioParams, n_frames: int) -> Tensor:
    """(B, L_padded) → (B, n_frames, n_fft)."""
    hop, n_fft = params.hop_length, params.n_fft
    if n_fft % hop == 0:
        r = n_fft // hop
        needed = (n_frames - 1) * hop + n_fft
        blocks = xp[:, :needed].reshape(xp.shape[0], n_frames - 1 + r, hop)
        return torch.cat([blocks[:, k : k + n_frames] for k in range(r)], dim=-1)
    return xp.unfold(-1, n_fft, hop)[:, :n_frames]


def _overlap_add(windowed: Tensor, params: AudioParams, length: int) -> Tensor:
    """(B, n_frames, n_fft) windowed frames → (B, length), NOLA-normalized."""
    hop, n_fft = params.hop_length, params.n_fft
    b, n, _ = windowed.shape
    assert n_fft % hop == 0, "overlap-add needs hop | n_fft"
    r = n_fft // hop
    blocks = windowed.reshape(b, n, r, hop)
    y = windowed.new_zeros((b, n + r - 1, hop))
    for k in range(r):
        y[:, k : k + n] += blocks[:, :, k]
    pad = n_fft // 2
    y = y.reshape(b, (n + r - 1) * hop)[:, pad : pad + length]
    return y * _nola_norm_on(params, n, length, y.device)


# ---------------------------------------------------------------------------
# STFT / iSTFT.
# ---------------------------------------------------------------------------


def frame_local_stft(xp: Tensor, params: AudioParams = DEFAULT_PARAMS,
                     n_frames: int | None = None) -> Tensor:
    """The STFT of an already padded signal, the framing, window and rfft
    that :func:`stft` and the time-sharded featurizer
    (:mod:`advoc_tpu_torch.parallel.halo`) share: frame t covers
    ``xp[..., t·hop : t·hop + n_fft)``, no padding is added (the caller owns
    it: :func:`stft` reflect-pads, the halo exchange brings the neighbours'
    samples). (..., L_padded) → (..., n_frames, n_freq) complex64;
    ``n_frames`` defaults to the most that fit, 1 + (L_padded − n_fft)//hop."""
    lead = xp.shape[:-1]
    xb = xp.reshape(-1, xp.shape[-1]).to(torch.float32)
    if n_frames is None:
        n_frames = 1 + (xp.shape[-1] - params.n_fft) // params.hop_length
    frames = _frame(xb, params, n_frames)
    spec = torch.fft.rfft(frames * _const(params, "window", xb.device), n=params.n_fft)
    return spec.reshape(lead + spec.shape[1:])


def frame_local_stft_mag(xp: Tensor, params: AudioParams = DEFAULT_PARAMS,
                         n_frames: int | None = None) -> Tensor:
    """|:func:`frame_local_stft`|: (..., L_padded) → (..., n_frames, n_freq)
    float32, the counterpart of the JAX package's function of this name."""
    return torch.abs(frame_local_stft(xp, params, n_frames))


def stft(x: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Centered STFT: (..., L) → (..., 1 + L//hop, n_freq) complex64
    (reflect padding, periodic Hann)."""
    length = x.shape[-1]
    pad = params.n_fft // 2
    xp = F.pad(x.reshape(-1, length).to(torch.float32), (pad, pad), mode="reflect")
    return frame_local_stft(xp.reshape(x.shape[:-1] + xp.shape[-1:]), params,
                            1 + length // params.hop_length)


def istft(spec: Tensor, length: int, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Inverse STFT with NOLA normalization: (..., T, n_freq) → (..., length)."""
    lead = spec.shape[:-2]
    sb = spec.reshape((-1,) + spec.shape[-2:])
    frames = torch.fft.irfft(sb, n=params.n_fft)
    y = _overlap_add(frames * _const(params, "window", frames.device), params, length)
    return y.reshape(lead + (length,))


def istft_stream_init(n_streams: int, params: AudioParams = DEFAULT_PARAMS, device=None):
    """Fresh carry for :func:`istft_stream_push`: (ola_tail, wsum_tail), each
    (n_streams, (r−1)·hop) zeros with r = n_fft // hop, the pending
    overlap-add past the last emitted sample and its running window-sum.
    The window-sum is carried per stream, so the partial normalization at a
    stream's start stays exact when one slot is reset mid-batch."""
    hop, n_fft = params.hop_length, params.n_fft
    assert n_fft % hop == 0, "streaming iSTFT needs hop | n_fft"
    z = torch.zeros((n_streams, (n_fft // hop - 1) * hop), device=device)
    return z, torch.zeros_like(z)


def istft_stream_push(spec_chunk: Tensor, carry, params: AudioParams = DEFAULT_PARAMS):
    """Overlap-add C frames into a live iSTFT stream and emit C·hop samples:
    (B, C, n_freq) complex + carry → ((B, C·hop), carry).

    Emission is in padded coordinates: a stream's first ``n_fft // 2``
    samples precede t = 0 (the center-padding pre-roll, for the caller to
    drop once); after that the samples equal :func:`istft` of the same frame
    stream, including the partial window-sum at the stream start. The last
    (r−1)·hop samples stay in the carry until more frames arrive or
    :func:`istft_stream_flush` emits them.
    """
    hop, n_fft = params.hop_length, params.n_fft
    r = n_fft // hop
    ola_tail, wsum_tail = carry
    b, c, _ = spec_chunk.shape
    frames = torch.fft.irfft(spec_chunk, n=n_fft)
    blocks = (frames * _const(params, "window", frames.device)).reshape(b, c, r, hop)
    y = frames.new_zeros((b, c + r - 1, hop))
    for k in range(r):
        y[:, k : k + c] += blocks[:, :, k]
    y = y.reshape(b, (c + r - 1) * hop)
    y[:, : (r - 1) * hop] += ola_tail
    # The static per-push profile (all C frames present) plus the tail.
    wsum = _stream_wsum(params, c, y.device)[None] + F.pad(wsum_tail, (0, c * hop))
    emit = y[:, : c * hop] / torch.clamp(wsum[:, : c * hop], min=1e-11)
    return emit, (y[:, c * hop :], wsum[:, c * hop :])


def istft_stream_flush(carry, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """A stream's pending (r−1)·hop tail samples, normalized by the carried
    partial window-sum, as :func:`istft` normalizes past the last frame."""
    ola_tail, wsum_tail = carry
    return ola_tail / torch.clamp(wsum_tail, min=1e-11)


# ---------------------------------------------------------------------------
# r9y9 mel extraction + heuristic inversion.
# ---------------------------------------------------------------------------


def amp_to_db(x: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=params.amp_floor))


def db_to_amp(x: Tensor) -> Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(s: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    return torch.clamp((s - params.min_level_db) / -params.min_level_db, 0.0, 1.0)


def denormalize_db(s: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    return torch.clamp(s, 0.0, 1.0) * -params.min_level_db + params.min_level_db


def waveform_to_magspec(x: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    return torch.abs(stft(x, params))


def magspec_to_r9y9_melspec(mag: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """(..., T, n_freq) magnitude → (..., T, n_mels) normalized mel."""
    mel = torch.matmul(mag, _const(params, "mel_fb_t", mag.device))
    return normalize_db(amp_to_db(mel, params) - params.ref_level_db, params)


def waveform_to_r9y9_melspec(
    x: Tensor, params: AudioParams = DEFAULT_PARAMS, impl: str = "xla"
) -> Tensor:
    """(..., L) waveform → (..., T, n_mels) r9y9 normalized mel.

    impl="xla" (default): the STFT path, T = 1 + L//hop. impl="kernel": the
    fused featurizer of :mod:`advoc_tpu_torch.ops.kernels.featurizer` (the
    CUDA kernel on a CUDA tensor, its plain version on the CPU), the
    counterpart of the JAX ``impl="pallas"``: T = L//hop.
    """
    if impl == "kernel":
        from advoc_tpu_torch.ops.kernels.featurizer import fused_melspec_kernel

        return fused_melspec_kernel(x, params)
    if impl == "pallas":
        raise ValueError("the port spells the fused featurizer impl='kernel'")
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")
    return magspec_to_r9y9_melspec(waveform_to_magspec(x, params), params)


def r9y9_melspec_to_magspec(mel: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Heuristic inversion: normalized mel → magnitude ≥ 0 (pinv estimate)."""
    amp = db_to_amp(denormalize_db(mel, params) + params.ref_level_db)
    pinv_t = _const(params, "mel_pinv_t", amp.device)
    return torch.clamp(torch.matmul(amp, pinv_t), min=0.0)


def mel_consistency_project(
    mag: Tensor,
    mel: Tensor,
    params: AudioParams = DEFAULT_PARAMS,
    strength: float = 1.0,
    max_gain: float = 4.0,
    n_iters: int = 1,
) -> Tensor:
    """Pull a magnitude back onto the conditioning mel's band envelopes.

    Per frame and mel band, the ratio of the conditioning mel's amplitude to
    the mel the magnitude implies (clipped to [1/max_gain, max_gain]) is
    spread back over the linear bins as a filterbank-weighted gain; bins the
    filterbank does not cover keep their value. See the JAX package's
    ``mel_consistency_project`` for why the Vocoder applies it.
    """
    fb_t = _const(params, "mel_fb_t", mag.device)  # (F, M)
    colsum = _const(params, "mel_colsum", mag.device)  # (F,)
    covered = colsum > 1e-6
    mel_amp = db_to_amp(denormalize_db(mel, params) + params.ref_level_db)
    out = mag
    for _ in range(n_iters):
        implied = torch.matmul(out, fb_t)
        ratio = mel_amp / torch.clamp(implied, min=1e-8)
        ratio = torch.clamp(ratio, 1.0 / max_gain, max_gain)
        num = torch.matmul(ratio, fb_t.T)
        gain = torch.where(covered, num / torch.clamp(colsum, min=1e-6), 1.0)
        out = out * (1.0 + strength * (gain - 1.0))
    return out


# ---------------------------------------------------------------------------
# Phase recovery.
# ---------------------------------------------------------------------------


def _dft_matmul(x: Tensor, params: AudioParams, name: str, precision: str) -> Tensor:
    """``x`` @ the DFT map ``name`` of :func:`_dft_consts`, float32 out.

    "highest": fp32 products. "default": bf16 operands with fp32
    accumulation, JAX's single-pass DEFAULT: one cuBLAS bf16 GEMM with an
    fp32 result on the card. The CPU has no such GEMM; there the rounded
    operands are multiplied in fp32, which gives the same products (a bf16 ×
    bf16 product is exact in fp32) summed in fp32.
    """
    if precision == "highest":
        return torch.matmul(x, _const(params, name, x.device))
    w = _const_bf16(params, name, x.device)
    x16 = x.to(torch.bfloat16)
    if x.is_cuda:
        y = torch.mm(x16.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(x.shape[:-1] + w.shape[-1:])
    return torch.matmul(x16.float(), w)


def griffin_lim(
    mag: Tensor,
    length: int | None = None,
    n_iters: int = 60,
    momentum: float = 0.0,
    params: AudioParams = DEFAULT_PARAMS,
    fft_impl: str = "matmul",
    init_phase: tuple[Tensor, Tensor] | None = None,
    drop_nyquist: bool = False,
    precision: str | None = None,
    return_final_phase: bool = False,
):
    """Griffin-Lim phase recovery: (..., T, n_freq) → (..., length) waveform.

    momentum=0 is classic G-L, ≈0.99 fast G-L. Zero-phase start unless
    ``init_phase`` = (cos φ, sin φ), broadcastable to the magnitude (matmul
    and kernel forms). ``fft_impl`` selects the form (module docstring);
    ``drop_nyquist`` runs the kernel form on the first n_freq − 1 bins, for
    callers whose Nyquist bin is known to be negligible. ``precision``
    ("default" or "highest") is each form's JAX precision: for the kernel
    form None means "default" (JAX's split_synth, the tensor-core kernel),
    "highest" the fp32 kernels; for the matmul form None means "highest"
    (fp32 throughout), and "default" runs the loop's DFT products with bf16
    operands and fp32 accumulation, JAX's single-pass DEFAULT, with the
    final synthesis in fp32 either way; the fft form ignores it.
    ``return_final_phase`` (matmul form only) also returns the unit phase
    (cos, sin) of the last update, shaped like ``mag``: the waveform and
    that pair.
    """
    if length is None:
        length = mag.shape[-2] * params.hop_length
    mag = mag.to(torch.float32)
    n_frames = mag.shape[-2]
    if init_phase is not None and fft_impl not in ("matmul", "kernel"):
        raise ValueError("init_phase needs fft_impl='matmul' or 'kernel'")
    if drop_nyquist and fft_impl != "kernel":
        raise ValueError("drop_nyquist is a kernel-path option")
    if return_final_phase and fft_impl != "matmul":
        raise ValueError("return_final_phase needs fft_impl='matmul'")
    if precision not in (None, "default", "highest"):
        raise ValueError(f"precision must be None, 'default' or 'highest', got {precision!r}")

    if fft_impl == "fft":
        spec = prev = mag.to(torch.complex64)  # zero phase
        for i in range(n_iters):
            rebuilt = stft(istft(spec, length, params), params)[..., :n_frames, :]
            # No momentum on iteration 0: there is no previous rebuild yet.
            m = 0.0 if i == 0 else momentum
            update = rebuilt + m * (rebuilt - prev)
            spec = mag * (update / torch.clamp(update.abs(), min=1e-16))
            prev = rebuilt
        return istft(spec, length, params)

    if fft_impl == "kernel":
        from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel

        if mag.ndim != 3 or length != n_frames * params.hop_length:
            raise ValueError(
                "fft_impl='kernel' needs (B, T, F) magnitudes and the default length"
            )
        if drop_nyquist:
            mag = mag[..., : params.n_freq - 1]
            if init_phase is not None:
                init_phase = tuple(p[..., : params.n_freq - 1] for p in init_phase)
        return griffin_lim_kernel(
            mag.contiguous(), n_iters=n_iters, momentum=momentum,
            init_phase=init_phase, params=params,
            precision="default" if precision is None else precision,
        )
    if fft_impl != "matmul":
        raise ValueError(f"unknown fft_impl {fft_impl!r}")

    loop_prec = "highest" if precision is None else precision
    lead = mag.shape[:-2]
    magb = mag.reshape((-1,) + mag.shape[-2:])  # (B, T, F)
    pad = params.n_fft // 2
    n_frames_re = 1 + length // params.hop_length

    def synth(re: Tensor, im: Tensor, prec: str) -> Tensor:
        frames_w = (_dft_matmul(re, params, "inv_re", prec)
                    + _dft_matmul(im, params, "inv_im", prec))
        return _overlap_add(frames_w, params, length)

    def analyze(x: Tensor) -> tuple[Tensor, Tensor]:
        xp = F.pad(x, (pad, pad), mode="reflect")
        frames = _frame(xp, params, n_frames_re)[:, :n_frames]
        return (_dft_matmul(frames, params, "fwd_re", loop_prec),
                _dft_matmul(frames, params, "fwd_im", loop_prec))

    if init_phase is not None:
        cos0, sin0 = (torch.broadcast_to(p.to(mag), mag.shape).reshape(magb.shape)
                      for p in init_phase)
        re, im = magb * cos0, magb * sin0
    else:
        re, im = magb, torch.zeros_like(magb)
    prev_re, prev_im = re, im
    for i in range(n_iters):
        nre, nim = analyze(synth(re, im, loop_prec))
        # No momentum on iteration 0: there is no previous rebuild yet.
        m = 0.0 if i == 0 else momentum
        ure = nre + m * (nre - prev_re)
        uim = nim + m * (nim - prev_im)
        scale = magb / torch.clamp(torch.sqrt(ure * ure + uim * uim), min=1e-16)
        re, im, prev_re, prev_im = ure * scale, uim * scale, nre, nim
    y = synth(re, im, "highest").reshape(lead + (length,))
    if return_final_phase:
        inv_mag = 1.0 / torch.clamp(torch.sqrt(re * re + im * im), min=1e-16)
        shape = lead + mag.shape[-2:]
        return y, ((re * inv_mag).reshape(shape), (im * inv_mag).reshape(shape))
    return y


def pghi_init_phase(
    mag: Tensor, params: AudioParams = DEFAULT_PARAMS, grad_coef: float = 0.0
) -> tuple[Tensor, Tensor]:
    """Magnitude-only phase estimate to seed Griffin-Lim (PGHI-style): the
    per-bin phase advance 2π·hop·f/n_fft plus ``grad_coef`` × the
    log-magnitude frequency gradient (central differences, one-sided at the
    edges), summed over frames. (..., T, F) → (cos φ, sin φ), same shape."""
    f = mag.shape[-1]
    freqs = torch.arange(f, dtype=torch.float32, device=mag.device)
    base = 2.0 * math.pi * params.hop_length * freqs / params.n_fft
    tgrad = torch.broadcast_to(base, mag.shape)
    if grad_coef:
        log_m = torch.log(torch.clamp(mag.to(torch.float32), min=1e-10))
        tgrad = tgrad + grad_coef * torch.gradient(log_m, dim=-1)[0]
    phase = torch.cumsum(tgrad, dim=-2)
    return torch.cos(phase), torch.sin(phase)


def magspec_to_waveform_griffin_lim(
    mag: Tensor, n_iters: int = 60, params: AudioParams = DEFAULT_PARAMS
) -> Tensor:
    """Classic Griffin-Lim (momentum 0, zero-phase start), the reference's
    API name: (..., T, n_freq) → (..., T·hop)."""
    return griffin_lim(mag, n_iters=n_iters, momentum=0.0, params=params)


# ---------------------------------------------------------------------------
# LWS (Local Weighted Sums) phase recovery.
# ---------------------------------------------------------------------------


def _split_ab(A: np.ndarray, B: np.ndarray, include_self: bool) -> np.ndarray:
    """The consistency kernels (A, B), each (2Q−1, F, F) complex, split into
    real and imaginary parts and folded into one real matrix K of
    ((2Q−1)·F·2, F·2) float32, so that one LWS frame update is one product.

    With w the update's source window (2Q−1 frames around frame m) and A_rev
    = A[::-1] (the source frame at window index j has offset dm = (Q−1) − j),
    the update's sum is acc[a] = Σ_{j,b} A_rev[j,a,b]·w[j,b] + B_rev[j,a,b]·
    conj(w[j,b]). Row (j, b, c) of K takes part c (0 real, 1 imaginary) of
    w[j, b], the layout of ``torch.view_as_real(w)`` flattened; column
    (a, c') gives part c' of acc[a]. The JAX package keeps the band of A and
    the corner blocks of B apart and sums them as 2·band+1 shifted products
    and two corner products; the masked kernels are zero elsewhere, so the
    one product is the same sum. ``include_self=False`` zeroes the centre
    frame's own bin (j = Q−1, b = a) in A and B: the term the JAX package
    subtracts after the sum.
    """
    nj, f, _ = A.shape
    a_rev = A[::-1].transpose(0, 2, 1).copy()  # (j, b, a)
    b_rev = B[::-1].transpose(0, 2, 1).copy()
    if not include_self:
        q1, idx = (nj - 1) // 2, np.arange(f)
        a_rev[q1, idx, idx] = 0.0
        b_rev[q1, idx, idx] = 0.0
    k = np.empty((nj, f, 2, f, 2), np.float64)
    k[:, :, 0, :, 0] = a_rev.real + b_rev.real
    k[:, :, 1, :, 0] = b_rev.imag - a_rev.imag
    k[:, :, 0, :, 1] = a_rev.imag + b_rev.imag
    k[:, :, 1, :, 1] = a_rev.real - b_rev.real
    return k.reshape(nj * f * 2, f * 2).astype(np.float32)


@device_cache(maxsize=8)
def _lws_consts(
    params: AudioParams, band: int, corner: int, include_self: bool, device: torch.device
) -> Tensor:
    """The interior kernels (``reference.lws_kernels``: A banded to |Δn| ≤
    ``band``, B on the DC and Nyquist corners) as :func:`_split_ab`'s matrix
    on ``device``, moved once."""
    A, B = ref.lws_kernels(params, band, corner)
    return torch.as_tensor(_split_ab(A, B, include_self), device=device)


@device_cache(maxsize=8)
def _lws_online_consts(
    params: AudioParams, band: int, corner: int, look_ahead: int, asymmetric: bool,
    include_self: bool, device: torch.device,
) -> tuple[Tensor, ...]:
    """Entry d: the matrix that updates a frame at distance d from the stream
    head. The interior one for d ≥ Q−1 (or always, without ``asymmetric``);
    the measured end-edge kernels (``reference.lws_edge_kernels``) for d ≤
    Q−2: banded for d ≥ 1, dense for the head frame (its window overlaps the
    reflect re-analysis pad, so its kernels are not band-local)."""
    interior = _lws_consts(params, band, corner, include_self, device)
    q = params.n_fft // params.hop_length
    if not asymmetric:
        return (interior,) * (look_ahead + 1)
    Ae, Be = ref.lws_edge_kernels(params, band, corner)
    return tuple(
        interior if d >= q - 1
        else torch.as_tensor(_split_ab(Ae[d], Be[d], include_self), device=device)
        for d in range(look_ahead + 1)
    )


def _lws_update(win: Tensor, mg: Tensor, k: Tensor, out: Tensor | None = None) -> Tensor:
    """One LWS frame update: the (n, 2Q−1, F) complex source windows of n
    frames → their centre frames' new values (n, F), magnitude ``mg`` and
    the phase of the truncated consistency sum (``k`` from
    :func:`_lws_consts` or :func:`_lws_online_consts`). One GEMM and four
    elementwise launches, all on real views (a complex ``abs`` would copy
    its result once more, and a complex-by-real product would cast);
    ``out``, a view of a buffer the caller created, receives the result in
    place."""
    n, nj, f = win.shape
    acc = (torch.view_as_real(win).reshape(n, nj * f * 2) @ k).view(n, f, 2)
    scale = torch.hypot(acc[..., 0], acc[..., 1]).clamp_(min=1e-16)
    torch.div(mg, scale, out=scale)
    if out is None:
        return torch.view_as_complex(acc * scale[..., None])
    torch.mul(acc, scale[..., None], out=torch.view_as_real(out))
    return out


def _lws_multicolor_sweep(reg: Tensor, mags: Tensor, first: int, nc: int, k: Tensor) -> None:
    """One multicolor Gauss-Seidel sweep over the frames first, first+1, … of
    the contiguous region buffer ``reg`` (B, R, F) complex, in place: frames
    of equal index mod ``nc`` update together as one batched
    :func:`_lws_update`, colors in ascending order. ``mags`` (B, n, F) are
    the n updated frames' magnitudes; every window stays inside ``reg``."""
    b, r, f = reg.shape
    n = mags.shape[1]
    nj = k.shape[0] // (2 * f)
    for g in range(nc):
        count = (n - g + nc - 1) // nc
        lo = first + g  # the color's first frame
        # (B, count, 2Q−1, F): the window of each frame of the color.
        win = reg.as_strided((b, count, nj, f), (r * f, nc * f, f, 1),
                             reg.storage_offset() + (lo - (nj - 1) // 2) * f)
        up = _lws_update(win.reshape(b * count, nj, f), mags[:, g::nc].reshape(b * count, f), k)
        reg[:, lo : lo + (count - 1) * nc + 1 : nc] = up.view(b, count, f)


def lws(
    mag: Tensor,
    length: int | None = None,
    n_sweeps: int = 10,
    band: int = 3,
    corner: int = 8,
    include_self: bool = False,
    colors: int = 1,
    params: AudioParams = DEFAULT_PARAMS,
) -> Tensor:
    """Batch LWS phase recovery: (..., T, n_freq) magnitudes → (..., length).

    Zero-phase start; each of ``n_sweeps`` Gauss-Seidel sweeps visits frames
    0 … T−1 in order and sets each frame's phase to that of its truncated
    consistency sum over frames m−(Q−1) … m+(Q−1) (already-visited frames
    contribute their new values; frames outside the signal are zeros).
    ``include_self=False`` leaves out the frame's own bin (Le Roux 2010's
    accelerated variant). ``colors=c > 1`` is the chromatic schedule: frames
    of equal index mod c update together as one batched update, colors in
    ascending order, so a sweep is c dependent updates instead of T; for c ≥
    Q same-color frames do not couple, and c ≥ T visits the frames one by one
    in the sequential order, bit for bit.
    """
    if length is None:
        length = mag.shape[-2] * params.hop_length
    q = params.n_fft // params.hop_length
    nj = 2 * q - 1
    lead = mag.shape[:-2]
    magb = mag.reshape((-1,) + mag.shape[-2:]).to(torch.float32)
    bn, t, f = magb.shape
    k = _lws_consts(params, band, corner, include_self, magb.device)
    spad = magb.new_zeros((bn, t + 2 * (q - 1), f), dtype=torch.complex64)
    spad[:, q - 1 : q - 1 + t] = magb  # zero phase
    for _ in range(n_sweeps):
        if colors > 1:
            _lws_multicolor_sweep(spad, magb, q - 1, min(colors, t), k)
            continue
        for m in range(t):
            _lws_update(spad[:, m : m + nj], magb[:, m], k, out=spad[:, m + q - 1])
    return istft(spad[:, q - 1 : q - 1 + t], length, params).reshape(lead + (length,))


def lws_online_init(
    n_streams: int, look_ahead: int = 2, params: AudioParams = DEFAULT_PARAMS, device=None
):
    """Fresh carry of :func:`lws_online_push` and :func:`lws_block_push`,
    all zeros: (s_re, s_im) of the rolling window (n_streams, look_ahead +
    2Q−1, F), head at index look_ahead + Q−1 and Q−1 future slots, and the
    magnitudes (n_streams, look_ahead+1, F) of the frames still refining."""
    q = params.n_fft // params.hop_length
    z = torch.zeros((n_streams, look_ahead + 2 * q - 1, params.n_freq), device=device)
    return z, torch.zeros_like(z), torch.zeros((n_streams, look_ahead + 1, params.n_freq),
                                               device=device)


def lws_online_drain(carry, look_ahead: int = 2, params: AudioParams = DEFAULT_PARAMS):
    """End of stream: the ``look_ahead`` frames still refining in a
    :func:`lws_online_push` / :func:`lws_block_push` carry, (re, im) each
    (B, look_ahead, F), taken as they are, as :func:`lws_online` takes its
    buffer tail."""
    s_re, s_im, _ = carry
    h = look_ahead + params.n_fft // params.hop_length - 1
    return s_re[:, h - look_ahead + 1 : h + 1], s_im[:, h - look_ahead + 1 : h + 1]


def lws_online_push(
    mag_chunk: Tensor,
    carry,
    n_sweeps: int = 2,
    look_ahead: int = 2,
    asymmetric: bool = True,
    band: int = 3,
    corner: int = 8,
    include_self: bool = False,
    params: AudioParams = DEFAULT_PARAMS,
):
    """C frames arrive, one at a time, into a live online-LWS stream:
    (B, C, F) magnitudes + carry → ((emit_re, emit_im), carry).

    Each arrival enters at zero phase at the head; then ``n_sweeps``
    Gauss-Seidel passes refine the frames at distance look_ahead … 0 from
    the head (oldest first), with the end-edge kernels near the head when
    ``asymmetric``. The frame leaving the window is final and emitted: emit
    frame c is global frame (frames pushed so far) − C + c − look_ahead, and
    a stream's first ``look_ahead`` emitted frames are zeros. Every arrival
    is the same string of operations on tensors of the same shapes, so the
    emitted frames do not depend on how the signal is cut into chunks (bit
    for bit) and equal one :func:`lws_online` over the whole signal.
    """
    q = params.n_fft // params.hop_length
    la = look_ahead
    h = la + q - 1  # the head's index in the window
    magb = mag_chunk.to(torch.float32)
    bn, c, f = magb.shape
    ks = _lws_online_consts(params, band, corner, la, asymmetric, include_self, magb.device)
    s_re, s_im, mbuf = carry
    s = torch.complex(s_re, s_im)
    zero = s.new_zeros((bn, 1, f))
    mags = torch.cat([mbuf, magb], dim=1)  # after arrival i, distance d is i + 1 + la − d
    emits = []
    for i in range(c):
        s = torch.cat([s[:, 1:], zero], dim=1)  # a new tensor: the carry is never written
        s[:, h] = magb[:, i]  # zero-phase arrival
        for _ in range(n_sweeps):
            for d in range(la, -1, -1):
                kk = h - d
                _lws_update(s[:, kk - q + 1 : kk + q], mags[:, i + 1 + la - d], ks[d],
                            out=s[:, kk])
        emits.append(s[:, h - la])
    em = torch.stack(emits, dim=1)
    return (em.real, em.imag), (s.real, s.imag, mags[:, c:])


def lws_online(
    mag: Tensor,
    length: int | None = None,
    n_sweeps: int = 2,
    look_ahead: int = 2,
    asymmetric: bool = True,
    band: int = 3,
    corner: int = 8,
    include_self: bool = False,
    params: AudioParams = DEFAULT_PARAMS,
) -> Tensor:
    """Online (causal) LWS phase recovery of a whole signal: (..., T, n_freq)
    → (..., length). Frames arrive one at a time through
    :func:`lws_online_push`; frame m is final once the head is
    ``look_ahead`` frames past it, and the last ``look_ahead`` frames are
    taken from the window as they are (:func:`lws_online_drain`)."""
    if length is None:
        length = mag.shape[-2] * params.hop_length
    la = look_ahead
    lead = mag.shape[:-2]
    magb = mag.reshape((-1,) + mag.shape[-2:]).to(torch.float32)
    bn, t, _ = magb.shape
    if t <= la:
        raise ValueError(f"need T > look_ahead (got T={t}, la={la})")
    (em_re, em_im), carry = lws_online_push(
        magb, lws_online_init(bn, la, params, magb.device), n_sweeps, la, asymmetric, band,
        corner, include_self, params)
    tail_re, tail_im = lws_online_drain(carry, la, params)
    spec = torch.complex(torch.cat([em_re[:, la:], tail_re], 1),
                         torch.cat([em_im[:, la:], tail_im], 1))
    return istft(spec, length, params).reshape(lead + (length,))


@device_cache(maxsize=16)
def _hop_ramp(params: AudioParams, c: int, device: torch.device) -> Tensor:
    """(C, F) complex e^{i·2π·hop·k·o/n_fft} for frame offsets o = 1 … C and
    bins k (float64 → complex64), moved once."""
    theta = 2.0 * np.pi * params.hop_length / params.n_fft * np.arange(params.n_freq)
    ang = np.arange(1, c + 1, dtype=np.float64)[:, None] * theta
    return torch.complex(torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
                         torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def lws_block_push(
    mag_chunk: Tensor,
    carry,
    n_sweeps: int = 3,
    look_ahead: int = 2,
    colors: int = 4,
    init: str = "advance",
    band: int = 3,
    corner: int = 8,
    include_self: bool = False,
    params: AudioParams = DEFAULT_PARAMS,
):
    """Block-parallel streaming LWS: the whole chunk arrives at once.

    The stream contract of :func:`lws_online_push` ((B, C, F) magnitudes +
    a carry from :func:`lws_online_init` → ((emit_re, emit_im), carry), C
    frames emitted, the first ``look_ahead`` of a stream zeros), with
    ``n_sweeps`` multicolor Gauss-Seidel sweeps over the look_ahead + C
    mutable frames: a sweep is ``colors`` batched updates, not C·(la+1).
    ``colors=1`` is Jacobi. ``init`` seeds the arriving frames: "zero" phase,
    or "advance", the carried head frame's phase advanced by 2π·hop·k/n_fft
    per bin k and frame. Near-head frames take the interior kernels over the
    zero future, and chunking is not free of meaning: the schedule sees the
    chunk boundaries.
    """
    if colors < 1:
        raise ValueError(f"colors must be ≥ 1 (got {colors})")
    if init not in ("zero", "advance"):
        raise ValueError(f"unknown init {init!r}")
    q = params.n_fft // params.hop_length
    la = look_ahead
    h = la + q - 1  # the head (frame t) in the carried window
    magb = mag_chunk.to(torch.float32)
    bn, c, f = magb.shape
    k = _lws_consts(params, band, corner, include_self, magb.device)
    s_re, s_im, mbuf = carry
    if init == "advance":
        head = torch.complex(s_re[:, h], s_im[:, h])  # zero at a stream's start
        nrm = head.abs()
        unit = torch.where(nrm > 1e-12, head / torch.clamp(nrm, min=1e-12), 1.0)
        new = magb * (unit[:, None] * _hop_ramp(params, c, magb.device))
    else:
        new = magb.to(torch.complex64)
    # The region: frames t−(la+Q−1) … t, the C new ones, Q−1 zero future
    # frames. Created here, so the sweeps write into no carry.
    reg = torch.cat([torch.complex(s_re[:, : h + 1], s_im[:, : h + 1]), new,
                     new.new_zeros((bn, q - 1, f))], dim=1)
    # The mutable frames' magnitudes: the carried ones (frames t−la+1 … t)
    # then the chunk's.
    mags = torch.cat([mbuf[:, 1:], magb], dim=1)
    first = h - la + 1
    for _ in range(n_sweeps):
        _lws_multicolor_sweep(reg, mags, first, min(colors, la + c), k)
    em, rest = reg[:, first : first + c], reg[:, c:]
    return (em.real, em.imag), (rest.real, rest.imag, mags[:, -(la + 1) :])


def magspec_to_waveform_lws(
    mag: Tensor, n_iters: int = 30, params: AudioParams = DEFAULT_PARAMS
) -> Tensor:
    """The shipped LWS-quality phase recovery: fast G-L (momentum 0.99, the
    fp32 matmul form), as in the JAX package, which measured it ahead of
    true LWS at matched time; true LWS is ``phase_method="lws_exact"`` of
    :func:`r9y9_melspec_to_waveform`."""
    return griffin_lim(mag, n_iters=n_iters, momentum=0.99, params=params)


def r9y9_melspec_to_waveform(
    mel: Tensor,
    n_iters: int = 60,
    phase_method: str = "lws",
    params: AudioParams = DEFAULT_PARAMS,
) -> Tensor:
    """The heuristic vocoder in one call: (..., T, n_mels) normalized mel →
    (..., T·hop), the pinv estimate then phase recovery.

    ``phase_method``: "lws" fast G-L (:func:`magspec_to_waveform_lws`);
    "lws_exact" :func:`lws`, ``n_iters`` sweeps; "lws_chromatic" the same on
    the 4-color schedule; "lws_online" :func:`lws_online`, ``n_iters``
    sweeps per arrival; "griffin_lim" classic G-L.
    """
    mag = r9y9_melspec_to_magspec(mel, params)
    if phase_method == "lws":
        return magspec_to_waveform_lws(mag, n_iters=n_iters, params=params)
    if phase_method == "lws_exact":
        return lws(mag, n_sweeps=n_iters, params=params)
    if phase_method == "lws_chromatic":
        return lws(mag, n_sweeps=n_iters, colors=4, params=params)
    if phase_method == "lws_online":
        return lws_online(mag, n_sweeps=n_iters, params=params)
    if phase_method == "griffin_lim":
        return magspec_to_waveform_griffin_lim(mag, n_iters=n_iters, params=params)
    raise ValueError(f"unknown phase_method: {phase_method!r}")
