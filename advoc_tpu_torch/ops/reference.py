"""Float64 numpy constants of the r9y9 spectral pipeline.

The port's own copy of the parameter block and host constants of
``advoc_tpu.ops.reference`` (the JAX package's float64 oracle): the audio
parameters, the Slaney mel scale and filterbank, and the periodic Hann
window. Plain numpy, so that the port needs nothing of the JAX package; the
tests assert that every array here equals the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AudioParams:
    """The featurizer parameter block (r9y9 wavenet_vocoder defaults)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 125.0
    fmax: float = 7600.0
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    # Floor inside amp_to_db: 20*log10(1e-5) = -100 dB.
    amp_floor: float = 1e-5

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


DEFAULT_PARAMS = AudioParams()


def hz_to_mel_slaney(freq_hz: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq_hz = np.asarray(freq_hz, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq_hz / f_sp
    log_region = freq_hz >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq_hz, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = mels * f_sp
    log_region = mels >= min_log_mel
    return np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the Slaney mel scale."""
    mel_min = hz_to_mel_slaney(np.float64(fmin))
    mel_max = hz_to_mel_slaney(np.float64(fmax))
    mels = np.linspace(mel_min, mel_max, n_mels, dtype=np.float64)
    return mel_to_hz_slaney(mels)


def create_mel_filterbank(params: AudioParams = DEFAULT_PARAMS) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_freq)
    (librosa ``filters.mel(htk=False, norm='slaney')``)."""
    n_freq = params.n_freq
    fft_freqs = np.linspace(0.0, params.sample_rate / 2.0, n_freq, dtype=np.float64)
    mel_f = mel_frequencies(params.n_mels + 2, params.fmin, params.fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : params.n_mels + 2] - mel_f[: params.n_mels])
    weights *= enorm[:, None]
    return weights


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', n))."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
