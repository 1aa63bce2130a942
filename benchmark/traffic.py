"""The one traffic generator: every mix is a data file of parameters
(``benchmark/workloads/<cell>.json``, key ``traffic``) that this module reads.

Audio is speech-like and made on the device from a seed (a frozen copy of the
program's ``synthetic_speech`` recipe: a harmonic source with wandering
pitch, coloured noise and a syllabic envelope, peak 0.7), then featurised by
the reference's r9y9 mel (:mod:`reference.audio`). Utterance lengths follow
LJSpeech 1.1 (a lognormal clipped to its shortest and longest file), drawn
once from the mix's own ``mix_seed``: every run seed gets the same set of
lengths and only their order and the audio differ, so the work a run does
does not move with its seed.

Mixes (``traffic["kind"]``):

* ``fixed_batch``: ``batch`` rows of ``frames`` frames a call, ``pool``
  distinct batches called in turn (one caller; the driver sets how many
  calls it keeps in flight).
* ``bucketed``: ``utterances`` LJ-shaped utterances grouped as a batched CLI
  groups them: sorted into ``chunk_frames`` buckets, ``batch`` rows a call
  (a bucket's last call padded with silent rows); the buckets interleaved
  evenly and the calls within a bucket shuffled by the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.audio import Audio, wav_to_norm_mel


def lj_durations(n: int, t: dict, seed: int) -> np.ndarray:
    """``n`` utterance durations in seconds (LJSpeech-shaped)."""
    rng = np.random.default_rng(seed)
    d = rng.lognormal(t["log_mean"], t["log_sigma"], n)
    return np.clip(d, t["min_s"], t["max_s"])


def speech(n_samples: list[int], gen: torch.Generator, device, sr: int) -> list[torch.Tensor]:
    """Speech-like waveforms of the given lengths, float32 on ``device``."""
    out = []
    for n in n_samples:
        u = torch.rand(11, generator=gen, device=device, dtype=torch.float64) * 6.28
        tt = torch.arange(n, device=device, dtype=torch.float64) / sr
        f0 = 140.0 + 60.0 * torch.sin(2 * math.pi * 0.7 * tt + u[0])
        ph = 2 * math.pi * torch.cumsum(f0, 0) / sr
        x = torch.zeros_like(tt)
        for k, amp in enumerate([1.0, 0.6, 0.45, 0.3, 0.22, 0.15, 0.1, 0.07], start=1):
            x += amp * torch.sin(k * ph + u[k])
        noise = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        h = torch.hann_window(32, periodic=False, device=device, dtype=torch.float64) / 16
        coloured = torch.nn.functional.conv1d(noise[None, None], h[None, None], padding=16)
        x += 0.08 * coloured[0, 0, :n]
        env = 0.5 * (1 + torch.sin(2 * math.pi * 2.8 * tt + u[9]))
        x *= 0.2 + 0.8 * env ** 1.5
        out.append((x / x.abs().max() * 0.7).float())
    return out


def mels_of(frames: list[int], gen: torch.Generator, device, a: Audio) -> list[np.ndarray]:
    """Normalised mels (frames_i, M) of speech, as float32 host arrays."""
    wavs = speech([f * a.hop_length for f in frames], gen, device, a.sample_rate)
    return [wav_to_norm_mel(w, a)[:f].cpu().numpy() for w, f in zip(wavs, frames)]


def offline_calls(t: dict, seed: int, device, a: Audio) -> list[dict]:
    """The calls of an offline mix, in the order of the first pass: each a
    dict with ``mel`` (rows, T, M) float32 on the host and ``frames`` (the
    true length of each real row; padded rows are not listed)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if t["kind"] == "fixed_batch":
        calls = []
        for _ in range(t["pool"]):
            m = mels_of([t["frames"]] * t["batch"], gen, device, a)
            calls.append({"mel": np.stack(m), "frames": [t["frames"]] * t["batch"]})
        return calls
    if t["kind"] != "bucketed":
        raise ValueError(f"not an offline mix: {t['kind']!r}")
    c, b = t["chunk_frames"], t["batch"]
    frames = np.ceil(lj_durations(t["utterances"], t, t["mix_seed"]) * a.sample_rate
                     / a.hop_length).astype(int)
    order = np.argsort(-(-frames // c) * c, kind="stable")
    groups: list[list[int]] = []
    for i in order:
        if groups and len(groups[-1]) < b and -(-frames[groups[-1][0]] // c) == -(-frames[i] // c):
            groups[-1].append(int(i))
        else:
            groups.append([int(i)])
    mels = mels_of([int(f) for f in frames], gen, device, a)
    calls = []
    for g in groups:
        tb = int(-(-max(frames[i] for i in g) // c) * c)
        mb = np.zeros((b, tb, a.n_mels), np.float32)
        for r, i in enumerate(g):
            mb[r, : frames[i]] = mels[i]
        calls.append({"mel": mb, "frames": [int(frames[i]) for i in g]})
    return calls


def call_order(calls: list[dict], t: dict, seed: int):
    """Deck indices forever. ``fixed_batch``: in turn. ``bucketed``: every pass
    interleaves the buckets evenly (the k-th of a bucket's n calls at (k + ½)/n
    of the pass), so that any stretch of calls holds each bucket in its share
    whatever the seed; the seed picks the order of the calls within a bucket,
    afresh on every pass."""
    rng = np.random.default_rng([seed, 1])
    if t["kind"] != "bucketed":
        while True:
            yield from range(len(calls))
    by_len: dict[int, list[int]] = {}
    for i, c in enumerate(calls):
        by_len.setdefault(c["mel"].shape[1], []).append(i)
    slots = sorted(((k + 0.5) / len(ix), tb, k) for tb, ix in by_len.items()
                   for k in range(len(ix)))
    while True:
        perm = {tb: rng.permutation(ix).tolist() for tb, ix in by_len.items()}
        yield from (perm[tb][k] for _, tb, k in slots)
