"""Float64 numpy constants of the r9y9 spectral pipeline.

The port's own copy of the parameter block and host constants of
``advoc_tpu.ops.reference`` (the JAX package's float64 oracle): the audio
parameters, the Slaney mel scale and filterbank, the periodic Hann window,
the float64 ``stft``/``istft``, and the LWS consistency kernels measured
with them (``lws_kernels``, ``lws_edge_kernels``, cached per argument).
Plain numpy, so that the port needs nothing of the JAX package; the tests
assert that every array here equals the JAX package's exactly.
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


def stft(x: np.ndarray, params: AudioParams = DEFAULT_PARAMS) -> np.ndarray:
    """Centered STFT. Returns complex128 of shape (n_frames, n_freq).

    Conventions: reflect-pad by n_fft//2 on both sides (librosa center=True),
    periodic Hann window of win_length zero-padded to n_fft, rFFT.
    n_frames = 1 + len(x) // hop_length.
    """
    x = np.asarray(x, dtype=np.float64)
    pad = params.n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    win = hann_window(params.win_length)
    if params.win_length < params.n_fft:
        lpad = (params.n_fft - params.win_length) // 2
        win = np.pad(win, (lpad, params.n_fft - params.win_length - lpad))
    n_frames = 1 + (len(xp) - params.n_fft) // params.hop_length
    frames = np.stack(
        [
            xp[i * params.hop_length : i * params.hop_length + params.n_fft]
            for i in range(n_frames)
        ]
    )
    return np.fft.rfft(frames * win[None, :], n=params.n_fft, axis=-1)


def istft(
    spec: np.ndarray, length: int, params: AudioParams = DEFAULT_PARAMS
) -> np.ndarray:
    """Inverse STFT with NOLA window-sum normalization.

    ``spec`` is (n_frames, n_freq) complex; returns float64 waveform of
    ``length`` samples (the original, pre-padding length).
    """
    spec = np.asarray(spec)
    win = hann_window(params.win_length)
    if params.win_length < params.n_fft:
        lpad = (params.n_fft - params.win_length) // 2
        win = np.pad(win, (lpad, params.n_fft - params.win_length - lpad))
    frames = np.fft.irfft(spec, n=params.n_fft, axis=-1)  # (n_frames, n_fft)
    n_frames = frames.shape[0]
    total = params.n_fft + (n_frames - 1) * params.hop_length
    y = np.zeros(total, dtype=np.float64)
    wsum = np.zeros(total, dtype=np.float64)
    wsq = win * win
    for i in range(n_frames):
        s = i * params.hop_length
        y[s : s + params.n_fft] += frames[i] * win
        wsum[s : s + params.n_fft] += wsq
    pad = params.n_fft // 2
    y = y[pad : pad + length]
    wsum = wsum[pad : pad + length]
    return y / np.maximum(wsum, 1e-11)


def _lws_band_mask(n_freq: int, width: int) -> np.ndarray:
    idx = np.arange(n_freq)
    return np.abs(idx[:, None] - idx[None, :]) <= width


def _lws_corner_mask(n_freq: int, width: int) -> np.ndarray:
    s = np.add.outer(np.arange(n_freq), np.arange(n_freq))
    return (s <= width) | (s >= 2 * (n_freq - 1) - width)


_LWS_KERNEL_CACHE: dict = {}


def lws_kernels(
    params: AudioParams = DEFAULT_PARAMS,
    band: int = 3,
    corner: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Truncated ℝ-linear consistency kernels (A, B), each (2Q-1, F, F).

    Q = n_fft // hop (4 for the r9y9 params ⇒ frame offsets −3…+3). A is
    masked to the |Δn| ≤ ``band`` diagonal band, B to the DC/Nyquist corners
    (``n'+n0 ≤ corner`` or ``≥ 2(F−1)−corner``). Measured numerically: istft
    then stft of per-bin delta spectrograms (real and imaginary separately,
    since G is not ℂ-linear), so the kernels inherit this oracle's exact
    STFT conventions including NOLA normalization. Cached per argument.
    """
    key = (params, band, corner)
    if key in _LWS_KERNEL_CACHE:
        return _LWS_KERNEL_CACHE[key]
    F = params.n_freq
    Q = params.n_fft // params.hop_length
    assert params.n_fft % params.hop_length == 0, "LWS kernels need hop | n_fft"
    T0 = 4 * Q  # enough interior frames around the probe
    m0 = T0 // 2
    length = (T0 - 1) * params.hop_length

    def measure(val: complex) -> np.ndarray:
        K = np.zeros((2 * Q - 1, F, F), dtype=np.complex128)
        for n0 in range(F):
            S = np.zeros((T0, F), dtype=np.complex128)
            S[m0, n0] = val
            G = stft(istft(S, length, params), params)[:T0]
            for j, dm in enumerate(range(-(Q - 1), Q)):
                K[j, :, n0] = G[m0 + dm, :]
        return K

    K1 = measure(1.0)
    Ki = measure(1.0j)
    A = (K1 - 1j * Ki) / 2.0
    B = (K1 + 1j * Ki) / 2.0
    A *= _lws_band_mask(F, band)[None]
    B *= _lws_corner_mask(F, corner)[None]
    _LWS_KERNEL_CACHE[key] = (A, B)
    return A, B


_LWS_EDGE_KERNEL_CACHE: dict = {}


def lws_edge_kernels(
    params: AudioParams = DEFAULT_PARAMS,
    band: int = 3,
    corner: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """End-edge consistency kernels (A_edge, B_edge), each (Q−1, 2Q−1, F, F).

    ``A_edge[d]`` is the consistency kernel for a response frame at distance
    ``d`` from the END of a finite signal (a spectrogram that simply stops at
    the stream head, length = n_frames·hop): its analysis window is truncated
    at the signal end and the OLA/NOLA normalization there sums only the
    windows that exist, so the effective windows are *asymmetric* — this is
    the numerically-measured analog of the ``lws`` C library's
    asymmetric-analysis-window mode (SURVEY §7.3 hard-part #2). Frames at
    distance ≥ Q−1 from the end see the interior operator (their window ends
    before the signal does), so only d ∈ 0…Q−2 need edge sets; entries whose
    source frame would lie beyond the end (d + dm < 0) are structurally zero.

    Measured like :func:`lws_kernels` but vectorized over probe bins: both
    STFT and iSTFT are linear and the NOLA window-sum is content-independent,
    so one irFFT of the identity gives all F per-bin time atoms and the F
    probe responses come from one batched OLA + rFFT. Cached per argument.
    """
    key = (params, band, corner)
    if key in _LWS_EDGE_KERNEL_CACHE:
        return _LWS_EDGE_KERNEL_CACHE[key]
    F = params.n_freq
    Q = params.n_fft // params.hop_length
    assert params.n_fft % params.hop_length == 0, "LWS kernels need hop | n_fft"
    nfft, hop = params.n_fft, params.hop_length
    T0 = 4 * Q
    length = T0 * hop  # online convention: T frames ↔ T·hop samples
    win = hann_window(params.win_length)
    if params.win_length < nfft:
        lpad = (nfft - params.win_length) // 2
        win = np.pad(win, (lpad, nfft - params.win_length - lpad))
    # Content-independent NOLA sum for a T0-frame signal of this length.
    total = nfft + (T0 - 1) * hop
    wsum = np.zeros(total, dtype=np.float64)
    for i in range(T0):
        wsum[i * hop : i * hop + nfft] += win * win
    pad = nfft // 2
    wsum_sig = np.maximum(wsum[pad : pad + length], 1e-11)

    def measure(ds: int, val: complex) -> np.ndarray:
        """(T0_resp, F_resp, F_src): responses at every frame to per-bin
        probes at source frame T0−1−ds."""
        s = (T0 - 1 - ds) * hop
        atoms = np.fft.irfft(val * np.eye(F, dtype=np.complex128), n=nfft,
                             axis=-1)  # (F_src, nfft)
        y = np.zeros((F, length), dtype=np.float64)
        lo, hi = max(s, pad), min(s + nfft, pad + length)
        y[:, lo - pad : hi - pad] = (atoms * win[None])[:, lo - s : hi - s]
        y /= wsum_sig[None]
        # Batched centered stft (reflect pad, frame, window, rfft).
        yp = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
        nf = 1 + (yp.shape[1] - nfft) // hop
        frames = np.stack(
            [yp[:, i * hop : i * hop + nfft] for i in range(min(nf, T0))],
            axis=1,
        )
        G = np.fft.rfft(frames * win[None, None], n=nfft, axis=-1)
        return np.transpose(G, (1, 2, 0))  # (T0, F_resp, F_src)

    A = np.zeros((Q - 1, 2 * Q - 1, F, F), dtype=np.complex128)
    B = np.zeros_like(A)
    for ds in range(2 * Q - 2):
        G1 = measure(ds, 1.0)
        Gi = measure(ds, 1.0j)
        for d in range(Q - 1):
            dm = ds - d
            if -(Q - 1) <= dm <= Q - 1:
                r = T0 - 1 - d
                A[d, dm + Q - 1] = (G1[r] - 1j * Gi[r]) / 2.0
                B[d, dm + Q - 1] = (G1[r] + 1j * Gi[r]) / 2.0
    # Locality, measured (BASELINE.md): d ≥ 1 is as band/corner-local as the
    # interior (≥99.99% of |A|² in |Δn| ≤ 3, B in the corners), but d = 0 —
    # the head frame, whose analysis window overlaps the reflect re-analysis
    # pad — is NOT: its conjugate part holds ~10% of A's energy spread over
    # ALL bins (time reflection ≈ spectral conjugation, a dense ℝ-linear
    # coupling). So d = 0 stays DENSE (one (2Q−1)·F × F matvec — trivial MXU
    # work) and d ≥ 1 get the standard masks.
    A[1:] *= _lws_band_mask(F, band)[None, None]
    B[1:] *= _lws_corner_mask(F, corner)[None, None]
    _LWS_EDGE_KERNEL_CACHE[key] = (A, B)
    return A, B
