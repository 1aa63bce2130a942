"""Spectral core in PyTorch: STFT, r9y9 mel, heuristic inversion, fast G-L.

The port of ``advoc_tpu.ops.spectral``. Host constants (Hann window, mel
filterbank and its pseudo-inverse, DFT maps, NOLA norm) are built in float64
numpy exactly as the JAX package builds them and moved to the input's device
as float32. Every matrix product here is true fp32: on the card that needs
``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default, matching
the JAX package's ``Precision.HIGHEST``.

Phase recovery (:func:`griffin_lim`) has two forms:

* ``fft_impl="matmul"``: the twin of the JAX scan. Each iteration
  synthesizes through the windowed inverse-DFT maps, overlap-adds, crops to
  the signal, reflect-pads and re-analyzes; no momentum on iteration 0.
* ``fft_impl="kernel"``: the CUDA fast-G-L kernel of
  :mod:`advoc_tpu_torch.ops.kernels.griffin_lim` (its plain version on the
  CPU), the counterpart of the JAX ``fft_impl="pallas"``: it iterates on the
  uncropped overlap-add signal, optionally on 512 bins (``drop_nyquist``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from advoc_tpu_torch.ops import reference as ref
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


@functools.lru_cache(maxsize=64)
def _const(params: AudioParams, name: str, device: torch.device) -> Tensor:
    """A named entry of :func:`_consts` / :func:`_dft_consts` as float32 on
    ``device``, moved there once."""
    table = {**_consts(params), **_dft_consts(params)}
    return torch.as_tensor(table[name], dtype=torch.float32, device=device)


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
    return y * torch.as_tensor(_nola_norm(params, n, length), device=y.device)


# ---------------------------------------------------------------------------
# STFT / iSTFT.
# ---------------------------------------------------------------------------


def stft(x: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Centered STFT: (..., L) → (..., 1 + L//hop, n_freq) complex64
    (reflect padding, periodic Hann)."""
    lead = x.shape[:-1]
    length = x.shape[-1]
    xb = x.reshape(-1, length).to(torch.float32)
    pad = params.n_fft // 2
    xp = F.pad(xb, (pad, pad), mode="reflect")
    frames = _frame(xp, params, 1 + length // params.hop_length)
    spec = torch.fft.rfft(frames * _const(params, "window", xb.device), n=params.n_fft)
    return spec.reshape(lead + spec.shape[1:])


def istft(spec: Tensor, length: int, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Inverse STFT with NOLA normalization: (..., T, n_freq) → (..., length)."""
    lead = spec.shape[:-2]
    sb = spec.reshape((-1,) + spec.shape[-2:])
    frames = torch.fft.irfft(sb, n=params.n_fft)
    y = _overlap_add(frames * _const(params, "window", frames.device), params, length)
    return y.reshape(lead + (length,))


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
    """(..., L) waveform → (..., 1 + L//hop, n_mels) r9y9 normalized mel."""
    if impl == "pallas":
        raise NotImplementedError(
            "the fused featurizer kernel (advoc_tpu/ops/pallas/featurizer.py) "
            "is not ported yet: ROADMAP.md queue B3"
        )
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


def griffin_lim(
    mag: Tensor,
    length: int | None = None,
    n_iters: int = 60,
    momentum: float = 0.0,
    params: AudioParams = DEFAULT_PARAMS,
    fft_impl: str = "matmul",
    init_phase: tuple[Tensor, Tensor] | None = None,
    drop_nyquist: bool = False,
) -> Tensor:
    """Griffin-Lim phase recovery: (..., T, n_freq) → (..., length) waveform.

    momentum=0 is classic G-L, ≈0.99 fast G-L. Zero-phase start unless
    ``init_phase`` = (cos φ, sin φ), broadcastable to the magnitude.
    ``fft_impl`` selects the form (module docstring); ``drop_nyquist`` runs
    the kernel form on the first n_freq − 1 bins, for callers whose Nyquist
    bin is known to be negligible.
    """
    if length is None:
        length = mag.shape[-2] * params.hop_length
    mag = mag.to(torch.float32)
    n_frames = mag.shape[-2]
    if drop_nyquist and fft_impl != "kernel":
        raise ValueError("drop_nyquist is a kernel-path option")

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
        )
    if fft_impl != "matmul":
        raise ValueError(f"unknown fft_impl {fft_impl!r}")

    fwd_re, fwd_im, inv_re, inv_im = (
        _const(params, k, mag.device) for k in ("fwd_re", "fwd_im", "inv_re", "inv_im")
    )
    lead = mag.shape[:-2]
    magb = mag.reshape((-1,) + mag.shape[-2:])  # (B, T, F)
    pad = params.n_fft // 2
    n_frames_re = 1 + length // params.hop_length

    def synth(re: Tensor, im: Tensor) -> Tensor:
        frames_w = torch.matmul(re, inv_re) + torch.matmul(im, inv_im)
        return _overlap_add(frames_w, params, length)

    def analyze(x: Tensor) -> tuple[Tensor, Tensor]:
        xp = F.pad(x, (pad, pad), mode="reflect")
        frames = _frame(xp, params, n_frames_re)[:, :n_frames]
        return torch.matmul(frames, fwd_re), torch.matmul(frames, fwd_im)

    if init_phase is not None:
        cos0, sin0 = (torch.broadcast_to(p.to(mag), mag.shape).reshape(magb.shape)
                      for p in init_phase)
        re, im = magb * cos0, magb * sin0
    else:
        re, im = magb, torch.zeros_like(magb)
    prev_re, prev_im = re, im
    for i in range(n_iters):
        nre, nim = analyze(synth(re, im))
        # No momentum on iteration 0: there is no previous rebuild yet.
        m = 0.0 if i == 0 else momentum
        ure = nre + m * (nre - prev_re)
        uim = nim + m * (nim - prev_im)
        scale = magb / torch.clamp(torch.sqrt(ure * ure + uim * uim), min=1e-16)
        re, im, prev_re, prev_im = ure * scale, uim * scale, nre, nim
    return synth(re, im).reshape(lead + (length,))
