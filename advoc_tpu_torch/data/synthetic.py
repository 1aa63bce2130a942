"""Speech-like test audio made from a seed (numpy only).

The port's copy of ``advoc_tpu.data.loader.synthetic_speech``: the same
function, so both packages make the same fixtures from the same seed.
"""

from __future__ import annotations

import numpy as np


def synthetic_speech(seed: int, n_samples: int, sample_rate: int = 22050) -> np.ndarray:
    """Deterministic speech-like audio: a harmonic source with wandering pitch
    (90–220 Hz), formant-ish colored noise and a syllabic envelope; peak 0.7."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / sample_rate
    f0 = 140.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    x = np.zeros_like(t)
    for k, amp in enumerate([1.0, 0.6, 0.45, 0.3, 0.22, 0.15, 0.1, 0.07], start=1):
        x += amp * np.sin(k * phase + rng.uniform(0, 6.28))
    noise = rng.standard_normal(n_samples)
    x += 0.08 * np.convolve(noise, np.hanning(32) / 16.0, mode="same")
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.8 * t + rng.uniform(0, 6.28)))
    x *= 0.2 + 0.8 * env**1.5
    x = x / np.abs(x).max() * 0.7
    return x.astype(np.float32)
