"""Test audio made from a seed (numpy only).

The port's copies of ``advoc_tpu.data.loader.synthetic_speech``,
``STRESS_KINDS`` and ``stress_fixture``: the same functions, so both
packages make the same fixtures from the same seed.
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


STRESS_KINDS = ("silence", "clipping", "noise", "chirp", "tone", "dc")


def stress_fixture(kind: str, n_samples: int, sample_rate: int = 22050,
                   seed: int = 0) -> np.ndarray:
    """Degenerate and adversarial eval inputs, float32 (``STRESS_KINDS``):

    * ``silence``: zeros (G-L must not NaN on zero magnitude);
    * ``clipping``: speech driven 4× past full scale and hard-clipped;
    * ``noise``: white Gaussian noise, peak 0.7 (no harmonic structure);
    * ``chirp``: a linear 50 Hz → 8 kHz sweep through every mel band;
    * ``tone``: a steady 440 Hz sine;
    * ``dc``: a 0.4 offset plus quiet speech (below fmin, unrecoverable).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / sample_rate
    if kind == "silence":
        x = np.zeros(n_samples)
    elif kind == "clipping":
        x = np.clip(4.0 * synthetic_speech(seed, n_samples, sample_rate), -0.95, 0.95)
    elif kind == "noise":
        x = rng.standard_normal(n_samples)
        x = 0.7 * x / np.abs(x).max()
    elif kind == "chirp":
        f = 50.0 + (8000.0 - 50.0) * np.arange(n_samples) / max(n_samples, 1)
        x = 0.7 * np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
    elif kind == "tone":
        x = 0.7 * np.sin(2 * np.pi * 440.0 * t)
    elif kind == "dc":
        x = 0.4 + 0.3 * synthetic_speech(seed, n_samples, sample_rate)
    else:
        raise ValueError(f"unknown stress kind {kind!r}; one of {STRESS_KINDS}")
    return np.asarray(x, np.float32)
