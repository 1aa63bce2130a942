"""Evaluation metrics of the port (``advoc_tpu.train.eval_metrics``).

The objective vocoder panel as torch functions on the caller's device
(:func:`spectrogram_l1`, :func:`log_spectral_distance`, :func:`snr_db`,
:func:`mel_l1`, :func:`vocoder_eval`, each returning 0-d tensors); STOI on
the host in numpy, as in the JAX package (its silent-frame removal makes
the frame count depend on the data); :func:`stress_panel`, the panel over
the degenerate fixtures of :func:`advoc_tpu_torch.data.synthetic.stress_fixture`;
and MelSpecGAN's distribution panel :func:`melspec_moment_panel`.
"""

from __future__ import annotations

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor


def spectrogram_l1(mag_a: Tensor, mag_b: Tensor) -> Tensor:
    """Mean |a − b| over magnitude spectrograms."""
    return torch.mean(torch.abs(mag_a - mag_b))


def log_spectral_distance(mag_a: Tensor, mag_b: Tensor, eps: float = 1e-5) -> Tensor:
    """LSD in dB: the RMS over frequency of the log-magnitude difference,
    averaged over frames. (..., T, F) → scalar."""
    la = 20.0 * torch.log10(torch.clamp(mag_a, min=eps))
    lb = 20.0 * torch.log10(torch.clamp(mag_b, min=eps))
    return torch.mean(torch.sqrt(torch.mean((la - lb) ** 2, dim=-1)))


def snr_db(x: Tensor, y: Tensor, eps: float = 1e-12) -> Tensor:
    """Signal-to-noise ratio of ``y`` against the reference ``x``, in dB."""
    num = torch.sum(x * x, dim=-1)
    den = torch.sum((x - y) ** 2, dim=-1) + eps
    return torch.mean(10.0 * torch.log10(num / den + eps))


def mel_l1(wav_a: Tensor, wav_b: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """Re-extracted normalized-mel L1 between two waveforms (the STFT path)."""
    ma = spectral.waveform_to_r9y9_melspec(wav_a, params)
    mb = spectral.waveform_to_r9y9_melspec(wav_b, params)
    return torch.mean(torch.abs(ma - mb))


def vocoder_eval(wav_ref: Tensor, wav_gen: Tensor,
                 params: AudioParams = DEFAULT_PARAMS) -> dict[str, Tensor]:
    """The objective panel of generated audio against the reference."""
    mag_ref = spectral.waveform_to_magspec(wav_ref, params)
    mag_gen = spectral.waveform_to_magspec(wav_gen, params)
    return {
        "spec_l1": spectrogram_l1(mag_gen, mag_ref),
        "lsd_db": log_spectral_distance(mag_gen, mag_ref),
        "snr_db": snr_db(wav_ref, wav_gen),
        "mel_l1": mel_l1(wav_ref, wav_gen, params),
    }


def stoi(wav_ref, wav_gen, sample_rate: int = DEFAULT_PARAMS.sample_rate) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2011) on the host.

    The JAX package's construction: 10 kHz, 256/128 Hann frames
    zero-padded to a 512-point FFT, energy-VAD removal of frames 40 dB
    below the reference's loudest, 15 one-third-octave bands from 150 Hz,
    384 ms (30-frame) segments, −15 dB SDR clipping, the per-band-segment
    linear correlation averaged over bands and segments. A proxy of
    intelligibility (not checked against the authors' MATLAB code): read
    differences, not absolute values. NaN where the reference is silent or
    shorter than one segment after the VAD. Takes numpy or tensors.
    """
    from advoc_tpu_torch.data.audioio import resample

    fs, flen, hop, nfft, n_bands, seg_n = 10000, 256, 128, 512, 15, 30
    clip_hi = 1.0 + 10.0 ** (15.0 / 20.0)  # β = −15 dB: clip at x·(1 + 10^(−β/20))

    def host(w) -> np.ndarray:
        w = w.detach().cpu().numpy() if torch.is_tensor(w) else w
        return np.asarray(w, np.float64)

    x = resample(host(wav_ref), sample_rate, fs)
    y = resample(host(wav_gen), sample_rate, fs)
    n = min(x.shape[-1], y.shape[-1])
    x, y = x[:n], y[:n]
    if n < flen:
        return float("nan")
    win = np.hanning(flen + 2)[1:-1]

    def frames(s: np.ndarray) -> np.ndarray:
        m = 1 + (len(s) - flen) // hop
        idx = np.arange(flen)[None] + hop * np.arange(m)[:, None]
        return s[idx] * win

    # Energy VAD on the reference, then the kept frames overlap-added back
    # into contiguous signals (Hann at 50% overlap sums to a constant).
    xf, yf = frames(x), frames(y)
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-30)
    if e.max() < -400.0:  # an all-(near-)zero reference: undefined
        return float("nan")
    keep = e > e.max() - 40.0
    xf, yf = xf[keep], yf[keep]

    def ola(f: np.ndarray) -> np.ndarray:
        out = np.zeros((f.shape[0] - 1) * hop + flen)
        for i, fr in enumerate(f):
            out[i * hop : i * hop + flen] += fr
        return out

    x, y = ola(xf), ola(yf)
    xs, ys = frames(x), frames(y)
    if xs.shape[0] < seg_n:
        return float("nan")
    fx = np.abs(np.fft.rfft(xs, nfft, axis=1)) ** 2
    fy = np.abs(np.fft.rfft(ys, nfft, axis=1)) ** 2
    freqs = np.arange(nfft // 2 + 1) * fs / nfft
    cf = 150.0 * 2.0 ** (np.arange(n_bands) / 3.0)
    lo, hi = cf * 2.0 ** (-1.0 / 6.0), cf * 2.0 ** (1.0 / 6.0)
    band = (freqs[None, :] >= lo[:, None]) & (freqs[None, :] < hi[:, None])
    bx = np.sqrt(fx @ band.T + 1e-30).T  # (15, M)
    by = np.sqrt(fy @ band.T + 1e-30).T
    sw = np.lib.stride_tricks.sliding_window_view  # (15, S, 30)
    xseg, yseg = sw(bx, seg_n, axis=1), sw(by, seg_n, axis=1)
    alpha = np.linalg.norm(xseg, axis=2, keepdims=True) / (
        np.linalg.norm(yseg, axis=2, keepdims=True) + 1e-30)
    yn = np.minimum(yseg * alpha, xseg * clip_hi)
    xd = xseg - xseg.mean(axis=2, keepdims=True)
    yd = yn - yn.mean(axis=2, keepdims=True)
    denom = np.linalg.norm(xd, axis=2) * np.linalg.norm(yd, axis=2) + 1e-30
    return float(((xd * yd).sum(axis=2) / denom).mean())


def melspec_moment_panel(real: Tensor, fake: Tensor) -> dict[str, Tensor]:
    """Distribution metrics of generated mel spectrograms against a real
    batch, both (B, T, M) normalized mels; 0-d tensors:

    * ``eval_band_{mean,std}_l1``: per-band first and second moments (over
      batch and time), L1 against real: the spectral envelope;
    * ``eval_diversity_gap``: |across-sample std (per time × band, averaged),
      fake − real|: a collapsed generator has none;
    * ``eval_{mean,std}_gap``: the global moments.

    Standard deviations are the population's (numpy's and JAX's ``std``).
    """
    rm, fm = real.mean(dim=(0, 1)), fake.mean(dim=(0, 1))
    rs, fs = real.std(dim=(0, 1), correction=0), fake.std(dim=(0, 1), correction=0)
    div_r = real.std(dim=0, correction=0).mean()
    div_f = fake.std(dim=0, correction=0).mean()
    return {
        "eval_mean_gap": torch.abs(fake.mean() - real.mean()),
        "eval_std_gap": torch.abs(fake.std(correction=0) - real.std(correction=0)),
        "eval_band_mean_l1": torch.mean(torch.abs(fm - rm)),
        "eval_band_std_l1": torch.mean(torch.abs(fs - rs)),
        "eval_diversity_gap": torch.abs(div_f - div_r),
    }


def stress_panel(
    vocoder,
    kinds: tuple[str, ...] | None = None,
    n_frames: int = 256,
    params: AudioParams = DEFAULT_PARAMS,
    seed: int = 0,
    device=None,
    impl: str = "xla",
) -> dict[str, dict[str, float]]:
    """Round-trip ``vocoder`` (any mel → waveform callable, e.g. a
    :class:`~advoc_tpu_torch.infer.Vocoder`) over each stress class and
    return the objective panel and STOI per class.

    Each fixture goes to ``device`` (default: the vocoder's ``device``,
    else the card) and is featurized there through ``impl`` ("xla", the
    JAX package's STFT path, or "kernel", the fused featurizer). Every
    metric must be finite, but ``snr_db`` and ``stoi`` on the silence class
    (zero signal energy); otherwise FloatingPointError.
    """
    from advoc_tpu_torch.data.synthetic import STRESS_KINDS, stress_fixture

    kinds = STRESS_KINDS if kinds is None else kinds
    dev = torch.device(device if device is not None
                       else getattr(vocoder, "device", None) or "cuda")
    out: dict[str, dict[str, float]] = {}
    for kind in kinds:
        wav = torch.tensor(stress_fixture(kind, n_frames * params.hop_length,
                                          params.sample_rate, seed=seed), device=dev)
        mel = spectral.waveform_to_r9y9_melspec(wav, params, impl=impl)
        gen = torch.as_tensor(vocoder(mel), device=dev)[: wav.shape[0]]
        metrics = {k: float(v) for k, v in vocoder_eval(wav, gen, params).items()}
        metrics["stoi"] = stoi(wav, gen, params.sample_rate)
        bad = [k for k, v in metrics.items()
               if not (k in ("snr_db", "stoi") and kind == "silence") and not np.isfinite(v)]
        if bad:
            raise FloatingPointError(
                f"non-finite metrics {bad} on stress class {kind!r}: {metrics}")
        out[kind] = metrics
    return out
