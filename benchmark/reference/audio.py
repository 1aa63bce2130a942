"""Plain PyTorch reference of the vocoder's spectral stages.

Written from the published r9y9 / AdVoc pipeline, independent of the code
under test: it imports neither ``advoc_tpu`` nor ``advoc_tpu_torch`` and
builds its own constants (periodic Hann window, Slaney mel filterbank and
its pseudo-inverse in float64, the windowed DFT maps of n_fft // 2 bins).

Every matrix product goes through :func:`mm`, whose operands are first
passed through ``q``: the identity for the reference (float32 with TF32 off),
a rounding to a lower precision for the control (:mod:`.quant`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Audio:
    """The r9y9 featurizer parameters (the configurations' ``audio`` block)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 125.0
    fmax: float = 7600.0
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    amp_floor: float = 1e-5

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


def ident(x: Tensor) -> Tensor:
    return x


def mm(a: Tensor, b: Tensor, q=ident) -> Tensor:
    """``a @ b`` on the operands as ``q`` rounds them, accumulated in float32."""
    return torch.matmul(q(a), q(b))


# -- constants (float64 numpy, then float32 on the device) -------------------------


def hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (np.maximum(m, 15.0) - 15.0))
    return np.where(m >= 15.0, log, lin)


@functools.lru_cache(maxsize=4)
def mel_basis(a: Audio) -> np.ndarray:
    """Slaney-normalised triangular filterbank (n_mels, n_freq), float64."""
    fft_f = np.linspace(0.0, a.sample_rate / 2.0, a.n_freq)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(a.fmin), _hz_to_mel(a.fmax), a.n_mels + 2))
    fb = np.zeros((a.n_mels, a.n_freq))
    for m in range(a.n_mels):
        lo, c, hi = mel_f[m], mel_f[m + 1], mel_f[m + 2]
        up = (fft_f - lo) / (c - lo)
        down = (hi - fft_f) / (hi - c)
        fb[m] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb


@functools.lru_cache(maxsize=4)
def _tables(a: Audio) -> dict:
    fb = mel_basis(a)
    n, nb = a.n_fft, a.n_fft // 2  # the loop's bins: the Nyquist bin dropped
    t = np.arange(n)[:, None] * np.arange(nb)[None, :] * (2.0 * np.pi / n)
    w = hann(n)[:, None]
    c = np.where(np.arange(nb) == 0, 1.0, 2.0)[:, None] / n  # irfft weights
    return {
        "fb_t": fb.T,  # (F, M)
        "pinv_t": np.linalg.pinv(fb).T,  # (M, F)
        "colsum": fb.sum(0),
        "fwd_re": w * np.cos(t), "fwd_im": -w * np.sin(t),  # (n_fft, nb)
        "inv_re": c * np.cos(t.T) * w.T, "inv_im": -c * np.sin(t.T) * w.T,  # (nb, n_fft)
        "window": hann(n),
    }


@functools.lru_cache(maxsize=32)
def _table_on(a: Audio, name: str, device: str) -> Tensor:
    return torch.as_tensor(_tables(a)[name], dtype=torch.float32, device=device)


def table(a: Audio, name: str, device) -> Tensor:
    return _table_on(a, name, str(torch.device(device)))


# -- the dB / mel stages ----------------------------------------------------------


def db_to_amp(x: Tensor) -> Tensor:
    return torch.pow(10.0, x / 20.0)


def norm_mel_to_amp(mel: Tensor, a: Audio) -> Tensor:
    """Normalised dB in [0, 1] → linear amplitude (ref level added back)."""
    db = mel.clamp(0.0, 1.0) * -a.min_level_db + a.min_level_db + a.ref_level_db
    return db_to_amp(db)


def amp_to_norm(x: Tensor, a: Audio) -> Tensor:
    db = 20.0 * torch.log10(x.clamp(min=a.amp_floor)) - a.ref_level_db
    return ((db - a.min_level_db) / -a.min_level_db).clamp(0.0, 1.0)


def pinv_estimate(mel: Tensor, a: Audio, q=ident) -> Tensor:
    """Normalised mel (…, T, M) → magnitude (…, T, F) ≥ 0 by the pseudo-inverse."""
    return mm(norm_mel_to_amp(mel, a), table(a, "pinv_t", mel.device), q).clamp(min=0.0)


def project(mag: Tensor, mel: Tensor, a: Audio, q=ident, max_gain: float = 4.0,
            strength: float = 1.0) -> Tensor:
    """One mel-consistency projection: each band's gain toward the conditioning
    mel, clipped to [1/max_gain, max_gain], spread over its bins by the
    filterbank weights; bins no band covers keep their value."""
    fb_t = table(a, "fb_t", mag.device)
    colsum = table(a, "colsum", mag.device)
    ratio = (norm_mel_to_amp(mel, a) / mm(mag, fb_t, q).clamp(min=1e-8))
    ratio = ratio.clamp(1.0 / max_gain, max_gain)
    gain = torch.where(colsum > 1e-6, mm(ratio, fb_t.T, q) / colsum.clamp(min=1e-6), 1.0)
    return mag * (1.0 + strength * (gain - 1.0))


def stft_mag(x: Tensor, a: Audio) -> Tensor:
    """|STFT| (…, 1 + L // hop, n_freq) of a waveform, centred, reflect-padded,
    float32 through ``torch.fft`` (for judging outputs, not a stage)."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).float()
    pad = a.n_fft // 2
    xp = torch.nn.functional.pad(xb[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, a.n_fft, a.hop_length)
    spec = torch.fft.rfft(frames * table(a, "window", x.device), n=a.n_fft).abs()
    return spec.reshape(lead + spec.shape[-2:])


def wav_to_norm_mel(x: Tensor, a: Audio) -> Tensor:
    """Waveform (…, L) → normalised r9y9 mel (…, 1 + L // hop, M)."""
    return amp_to_norm(torch.matmul(stft_mag(x, a), table(a, "fb_t", x.device)), a)


# -- fast Griffin-Lim -------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _ola_norm(a: Audio, t: int, device: str) -> Tensor:
    """1 / window-sum of ``t`` overlap-added frames, as (t + r − 1, hop) blocks."""
    n, hop = a.n_fft, a.hop_length
    r = n // hop
    w2 = hann(n) ** 2
    s = np.zeros((t + r - 1) * hop)
    for i in range(t):
        s[i * hop : i * hop + n] += w2
    return torch.as_tensor(1.0 / np.maximum(s, 1e-11), dtype=torch.float32,
                           device=device).reshape(t + r - 1, hop)


def _synth(re: Tensor, im: Tensor, a: Audio, q) -> Tensor:
    """(B, T, nb) spectrum → (B, T + r − 1, hop) normalised overlap-add blocks."""
    b, t, _ = re.shape
    hop, r = a.hop_length, a.n_fft // a.hop_length
    frames = (mm(re, table(a, "inv_re", re.device), q)
              + mm(im, table(a, "inv_im", re.device), q)).reshape(b, t, r, hop)
    y = re.new_zeros((b, t + r - 1, hop))
    for k in range(r):
        y[:, k : k + t] += frames[:, :, k]
    return y * _ola_norm(a, t, str(re.device))


def _analyse(y: Tensor, t: int, a: Audio, q) -> tuple[Tensor, Tensor]:
    hop, r = a.hop_length, a.n_fft // a.hop_length
    frames = torch.cat([y[:, k : k + t] for k in range(r)], dim=-1)  # (B, T, n_fft)
    return (mm(frames, table(a, "fwd_re", y.device), q),
            mm(frames, table(a, "fwd_im", y.device), q))


def fast_griffin_lim(mag: Tensor, n_iters: int, momentum: float, a: Audio, q=ident) -> Tensor:
    """Fast G-L (Perraudin et al. 2013) on the whole utterance's overlap-add
    signal, uncropped, on the first n_fft // 2 bins, from zero phase; no
    momentum on the first iteration. (B, T, ≥ n_fft // 2) → (B, T·hop)."""
    nb = a.n_fft // 2
    mag = mag[..., :nb].float()
    b, t, _ = mag.shape
    re, im = mag.clone(), torch.zeros_like(mag)
    pre, pim = re, im
    for i in range(n_iters):
        ar, ai = _analyse(_synth(re, im, a, q), t, a, q)
        m = 0.0 if i == 0 else momentum
        ur, ui = ar + m * (ar - pre), ai + m * (ai - pim)
        pre, pim = ar, ai
        s = mag * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        re, im = ur * s, ui * s
    lead = (a.n_fft // 2) // a.hop_length
    return _synth(re, im, a, q)[:, lead : lead + t].reshape(b, t * a.hop_length)
