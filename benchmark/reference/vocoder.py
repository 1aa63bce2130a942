"""The reference vocoder, the offline call, composed of :mod:`.audio` and
:mod:`.unet` in plain PyTorch.

Offline (the semantics of a batched vocoder call): the pseudo-inverse
estimate in normalised dB, the generator over ``chunk``-frame windows that
overlap by ``overlap`` frames, joined by linear crossfade weights in the dB
domain, back to amplitude, one mel-consistency projection, fast G-L on the
whole (bucketed) utterance.
"""

from __future__ import annotations

import numpy as np
import torch

from . import unet
from .audio import (Audio, amp_to_norm, fast_griffin_lim, ident, norm_mel_to_amp,
                    pinv_estimate, project)

Tensor = torch.Tensor


def windows(t: int, chunk: int, overlap: int) -> list[int]:
    """Start frames of the ``chunk``-frame windows that cover [0, t)."""
    if t <= chunk:
        return [0]
    return list(range(0, t - chunk, chunk - overlap)) + [t - chunk]


def crossfade(chunk: int, overlap: int) -> np.ndarray:
    w = np.ones(chunk)
    if overlap:
        ramp = (np.arange(overlap) + 1.0) / (overlap + 1.0)
        w[:overlap], w[-overlap:] = ramp, ramp[::-1]
    return w


def generator_rows(est_norm: Tensor, sd: dict, model: dict, q, block: int) -> Tensor:
    """The generator over rows in blocks of ``block`` (memory)."""
    return torch.cat([unet.generator(est_norm[i : i + block], sd, model, q)
                      for i in range(0, est_norm.shape[0], block)])


def vocode(mel: Tensor, sd: dict, model: dict, voc: dict, a: Audio, q=ident,
           block: int = 16) -> tuple[Tensor, Tensor, Tensor]:
    """(B, T, M) normalised mel, T a multiple of the chunk → (the generator's
    output per window (B·n_windows, chunk, F), the waveform (B, T·hop), G-L's
    target magnitude (B, T, F))."""
    b, t, _ = mel.shape
    chunk, ov = voc["chunk_frames"], voc["overlap_frames"]
    est_norm = amp_to_norm(pinv_estimate(mel, a, q), a)
    starts = windows(t, chunk, ov)
    x = torch.stack([est_norm[:, s : s + chunk] for s in starts], 1)
    rep = generator_rows(x.reshape(b * len(starts), chunk, -1), sd, model, q, block)
    w = torch.as_tensor(crossfade(chunk, ov), dtype=torch.float32, device=mel.device)
    num, den = torch.zeros_like(est_norm), torch.zeros(t, device=mel.device)
    r = rep.reshape(b, len(starts), chunk, -1)
    for i, s in enumerate(starts):
        num[:, s : s + chunk] += r[:, i] * w[:, None]
        den[s : s + chunk] += w
    mag = norm_mel_to_amp(num / den.clamp(min=1e-8)[:, None], a)
    if voc["mel_projection"]:
        mag = project(mag, mel, a, q, strength=voc["mel_projection"])
    wav = fast_griffin_lim(mag, voc["gl_iters"], voc["momentum"], a, q)
    return rep, wav, mag
