"""Offline vocoder: mel in, waveform out, on one device.

The port of ``advoc_tpu.infer.vocoder.Vocoder``. Per call: the pinv
heuristic estimate, conversion to normalized dB, the generator over
``chunk_frames`` windows with ``overlap_frames`` of linear crossfade in the
dB domain, conversion back to amplitude, the mel-consistency projection,
then fast Griffin-Lim over the whole utterance. Lengths are bucketed to
multiples of ``chunk_frames`` and the waveform is cropped back to the true
length, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor


def _chunk_windows(t: int, chunk: int, hop: int) -> np.ndarray:
    """Start indices of overlapping windows covering [0, t)."""
    if t <= chunk:
        return np.array([0])
    starts = list(range(0, t - chunk, hop))
    starts.append(t - chunk)
    return np.asarray(starts)


def _crossfade_weights(chunk: int, overlap: int) -> np.ndarray:
    """Per-frame weights: linear ramps on both edges (float32)."""
    w = np.ones(chunk, np.float64)
    if overlap > 0:
        ramp = (np.arange(overlap) + 1.0) / (overlap + 1.0)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w.astype(np.float32)


def chunked_generator_apply(generator, chunk: int, overlap: int, t_frames: int):
    """The generator over ``chunk``-frame windows with dB-domain crossfade.

    Returns ``est_norm (B, t_frames, F) → mag_norm``: every window of every
    row goes through ``generator`` in one batch, and the outputs are joined
    by the crossfade weights (normalized, so the fade cancels at the edges).
    """
    starts = [int(s) for s in _chunk_windows(t_frames, chunk, chunk - overlap)]
    weights_np = _crossfade_weights(chunk, overlap)

    def apply(est_norm: Tensor) -> Tensor:
        b, _, n_bins = est_norm.shape
        weights = torch.as_tensor(weights_np, device=est_norm.device)[None, :, None]
        chunks = torch.stack([est_norm[:, s : s + chunk] for s in starts], dim=1)
        nc = len(starts)
        repaired = generator(chunks.reshape(b * nc, chunk, n_bins)).reshape(
            b, nc, chunk, n_bins
        )
        num = torch.zeros_like(est_norm)
        den = est_norm.new_zeros((1, t_frames, 1))
        for i, s in enumerate(starts):
            num[:, s : s + chunk] += repaired[:, i] * weights
            den[:, s : s + chunk] += weights
        return num / torch.clamp(den, min=1e-8)

    return apply


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Vocoder runs on the card by default and no CUDA device is present; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class Vocoder:
    """mel (T, n_mels) or (B, T, n_mels) → waveform (…, T·hop).

    ``generator``: an ``AdvocGenerator`` (moved to ``device`` and set to eval
    mode), or None for the heuristic pipeline. ``mel_projection`` None means
    1.0 with a generator and 0.0 without. ``phase_method`` "lws" is fast G-L
    at momentum 0.99, "gl" classic G-L. ``phase_impl``: "auto" takes the
    CUDA G-L kernel on a CUDA device whenever n_fft == 4 · hop (the JAX
    Vocoder's rule for its Pallas kernels; the kernel iterates on the whole
    utterance, so no length is excluded) and the matmul scan otherwise;
    "kernel" always takes the kernel function (its plain version on the
    CPU); "xla" always takes the matmul scan.
    ``device`` defaults to "cuda" and raises if no card is present.
    """

    def __init__(
        self,
        generator=None,
        params: AudioParams = DEFAULT_PARAMS,
        chunk_frames: int = 256,
        overlap_frames: int = 32,
        gl_iters: int = 30,
        phase_method: str = "lws",
        phase_impl: str = "auto",
        mel_projection: float | None = None,
        device=None,
        mesh=None,
        phase_init: str = "zero",
    ):
        if mesh is not None:
            raise NotImplementedError("mesh (data-parallel) is not ported yet (ROADMAP.md)")
        if phase_init != "zero":
            raise NotImplementedError(f"phase_init={phase_init!r} is not ported yet (ROADMAP.md)")
        if phase_method == "lws_exact":
            raise NotImplementedError("phase_method='lws_exact' is not ported yet (ROADMAP.md)")
        if phase_method not in ("lws", "gl"):
            raise ValueError(f"unknown phase_method {phase_method!r}")
        if phase_impl not in ("auto", "kernel", "xla"):
            raise ValueError(f"unknown phase_impl {phase_impl!r}")
        self.device = _resolve_device(device)
        self.generator = generator.to(self.device).eval() if generator is not None else None
        self.params = params
        self.chunk = chunk_frames
        self.overlap = overlap_frames
        self.gl_iters = gl_iters
        self.phase_method = phase_method
        self.momentum = 0.99 if phase_method == "lws" else 0.0
        self.phase_impl = phase_impl
        if mel_projection is None:
            mel_projection = 1.0 if generator is not None else 0.0
        self.mel_projection = float(mel_projection)

    def _use_kernel(self) -> bool:
        if self.phase_impl != "auto":
            return self.phase_impl == "kernel"
        p = self.params
        return self.device.type == "cuda" and p.n_fft == 4 * p.hop_length

    def bucket(self, t: int) -> int:
        """Round up to a multiple of chunk_frames."""
        c = self.chunk
        return max(c, ((t + c - 1) // c) * c)

    def _run(self, mel: Tensor) -> Tensor:
        """(B, T, M) bucketed mel → (B, T·hop) waveform."""
        p = self.params
        t_frames = mel.shape[1]
        est = spectral.r9y9_melspec_to_magspec(mel, p)
        est_norm = spectral.normalize_db(spectral.amp_to_db(est, p) - p.ref_level_db, p)
        if self.generator is not None:
            apply = chunked_generator_apply(self.generator, self.chunk, self.overlap, t_frames)
            mag_norm = apply(est_norm)
        else:
            mag_norm = est_norm
        mag = spectral.db_to_amp(spectral.denormalize_db(mag_norm, p) + p.ref_level_db)
        if self.mel_projection > 0.0:
            mag = spectral.mel_consistency_project(mag, mel, p, strength=self.mel_projection)
        length = t_frames * p.hop_length
        if self._use_kernel():
            # The Nyquist bin is the heuristic estimate passed through when
            # the mel basis has no support there (fmax < sr/2), so the loop
            # runs on exactly n_fft/2 bins.
            return spectral.griffin_lim(
                mag, length, n_iters=self.gl_iters, momentum=self.momentum,
                params=p, fft_impl="kernel",
                drop_nyquist=p.fmax < 0.5 * p.sample_rate,
            )
        return spectral.griffin_lim(
            mag, length, n_iters=self.gl_iters, momentum=self.momentum, params=p,
        )

    def __call__(self, mel) -> Tensor:
        """Vocode (T, M) or (B, T, M), numpy or tensor; returns a float32
        tensor on the Vocoder's device, cropped to the true length."""
        if not torch.is_tensor(mel):
            mel = torch.tensor(np.asarray(mel, np.float32))
        mel = mel.to(self.device, torch.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        t = mel.shape[1]
        tb = self.bucket(t)
        if tb != t:  # silence-level mel (0.0 is the dB floor after normalize)
            mel = torch.nn.functional.pad(mel, (0, 0, 0, tb - t))
        with torch.inference_mode():
            wav = self._run(mel)[:, : t * self.params.hop_length]
        return wav[0] if squeeze else wav

    def vocode_longform(self, *args, **kwargs):
        raise NotImplementedError("vocode_longform is not ported yet (ROADMAP.md)")


class StreamingVocoder:
    """Not ported yet: ROADMAP.md queue A6."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("StreamingVocoder is not ported yet (ROADMAP.md)")
