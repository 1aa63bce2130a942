"""Vocoders: mel in, waveform out, on one device.

The port of ``advoc_tpu.infer.vocoder``. :class:`Vocoder` is the offline
path. Per call: the pinv heuristic estimate, conversion to normalized dB,
the generator over ``chunk_frames`` windows with ``overlap_frames`` of
linear crossfade in the dB domain, conversion back to amplitude, the
mel-consistency projection, then fast Griffin-Lim over the whole
utterance. Lengths are bucketed to multiples of ``chunk_frames`` and the
waveform is cropped back to the true length, as in the JAX package.
:meth:`Vocoder.vocode_longform` runs any length through one fixed-tile
:class:`StreamingVocoder`, the stateful chunk-by-chunk serving engine.
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
    on_device: dict[torch.device, Tensor] = {}  # moved once: a host copy per call waits

    def apply(est_norm: Tensor) -> Tensor:
        b, _, n_bins = est_norm.shape
        weights = on_device.get(est_norm.device)
        if weights is None:
            weights = on_device[est_norm.device] = torch.as_tensor(
                weights_np, device=est_norm.device)[None, :, None]
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
            "the vocoders run on the card by default and no CUDA device is present; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _bmask(active: Tensor, like: Tensor) -> Tensor:
    """(n,) bool mask reshaped to broadcast over ``like``'s trailing dims."""
    return active.reshape(active.shape + (1,) * (like.ndim - 1))


def _to_pcm16(x: Tensor) -> Tensor:
    """``save_as_wav``'s PCM16 convention, on the tensor's device."""
    return torch.round(torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)


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
    CPU); "xla" always takes the matmul scan. ``gl_precision`` is the
    kernel form's mode: None or "default" is JAX's default split_synth (the
    tensor-core kernel on the card), "highest" fp32 throughout; the matmul
    scan is fp32 either way. ``phase_init`` "pghi" starts G-L (either form)
    from :func:`~advoc_tpu_torch.ops.spectral.pghi_init_phase` with
    ``pghi_coef``, "zero" from zero phase.
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
        gl_precision: str | None = None,
        mel_projection: float | None = None,
        device=None,
        mesh=None,
        phase_init: str = "zero",
        pghi_coef: float = 0.0,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh (data-parallel) is not ported yet (ROADMAP.md)")
        if phase_init not in ("zero", "pghi"):
            raise ValueError(f"unknown phase_init {phase_init!r}")
        if phase_method == "lws_exact":
            raise NotImplementedError("phase_method='lws_exact' is not ported yet (ROADMAP.md)")
        if phase_method not in ("lws", "gl"):
            raise ValueError(f"unknown phase_method {phase_method!r}")
        if phase_impl not in ("auto", "kernel", "xla"):
            raise ValueError(f"unknown phase_impl {phase_impl!r}")
        if gl_precision not in (None, "default", "highest"):
            raise ValueError(f"unknown gl_precision {gl_precision!r}")
        self.device = _resolve_device(device)
        self.generator = generator.to(self.device).eval() if generator is not None else None
        self.params = params
        self.chunk = chunk_frames
        self.overlap = overlap_frames
        self.gl_iters = gl_iters
        self.phase_method = phase_method
        self.momentum = 0.99 if phase_method == "lws" else 0.0
        self.phase_impl = phase_impl
        self.gl_precision = "default" if gl_precision is None else gl_precision
        if mel_projection is None:
            mel_projection = 1.0 if generator is not None else 0.0
        self.mel_projection = float(mel_projection)
        self.phase_init = phase_init
        self.pghi_coef = pghi_coef
        self._longform: dict[tuple[int, int], StreamingVocoder] = {}

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
        init = (spectral.pghi_init_phase(mag, p, self.pghi_coef)
                if self.phase_init == "pghi" else None)
        if self._use_kernel():
            # The Nyquist bin is the heuristic estimate passed through when
            # the mel basis has no support there (fmax < sr/2), so the loop
            # runs on exactly n_fft/2 bins.
            return spectral.griffin_lim(
                mag, length, n_iters=self.gl_iters, momentum=self.momentum,
                params=p, fft_impl="kernel", precision=self.gl_precision,
                drop_nyquist=p.fmax < 0.5 * p.sample_rate, init_phase=init,
            )
        return spectral.griffin_lim(
            mag, length, n_iters=self.gl_iters, momentum=self.momentum, params=p,
            init_phase=init,
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

    def vocode_longform(
        self,
        mel,
        tile_frames: int = 1024,
        overlap_frames: int = 32,
        sync_every: int = 16,
    ) -> np.ndarray:
        """Any length through one fixed tile: consecutive ``tile_frames``
        tiles go through a cached one-stream gl :class:`StreamingVocoder`
        whose carry (phase continuation and an ``overlap_frames`` waveform
        crossfade) stitches the tiles. The generator runs through the same
        ``chunk_frames`` chunk-and-crossfade stage as the offline call, at
        the Vocoder's G-L budget. Tiles are enqueued with ``readback=False``
        and the queue is drained every ``sync_every`` tiles.

        (T, M) or (B, T, M), rows vocoded one after another; returns float32
        numpy (…, T·hop) cropped to the true length.
        """
        mel = np.asarray(mel, np.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        if tile_frames < self.chunk or tile_frames % self.chunk:
            raise ValueError(
                f"tile_frames={tile_frames} must be a multiple of chunk_frames={self.chunk}"
            )
        key = (tile_frames, overlap_frames)
        sv = self._longform.get(key)
        if sv is None:
            apply = (chunked_generator_apply(self.generator, self.chunk, self.overlap, tile_frames)
                     if self.generator is not None else None)
            sv = StreamingVocoder(
                apply, params=self.params, chunk_frames=tile_frames,
                overlap_frames=overlap_frames, gl_iters=self.gl_iters,
                mel_projection=self.mel_projection, device=self.device,
            )
            self._longform[key] = sv
        hop = self.params.hop_length
        b, t = mel.shape[:2]
        n_tiles = max(1, -(-t // tile_frames))
        padded = n_tiles * tile_frames
        if padded != t:  # silence-level mel (0.0 is the dB floor after normalize)
            mel = np.pad(mel, ((0, 0), (0, padded - t), (0, 0)))
        rows = []
        for i in range(b):
            sv.reset()
            emits = []
            for k in range(n_tiles):
                emits.append(sv.push(mel[i, k * tile_frames : (k + 1) * tile_frames],
                                     readback=False))
                if (k + 1) % sync_every == 0 and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            emits.append(sv.flush(readback=False))
            wav = torch.cat(emits).cpu().numpy()
            rows.append(wav[sv.preroll_samples : sv.preroll_samples + t * hop])
        out = np.stack(rows)
        return out[0] if squeeze else out


class StreamingVocoder:
    """Low-latency stateful chunk vocoder, the gl engine of the JAX
    package's ``StreamingVocoder``.

    Feed consecutive non-overlapping mel chunks of ``chunk_frames``; each
    push returns ``chunk_frames·hop`` samples per stream. The engine carries
    each stream's last ``overlap_frames`` magnitude frames, runs fast G-L
    (momentum 0.99, ``gl_iters``, the matmul form in fp32) on
    [carried frames | chunk] from a phase extrapolated from the stream's
    last two frames (RTISI-style), and crossfades the ``overlap_frames·hop``
    samples that consecutive windows both synthesize. Emissions trail the
    input by ``overlap_frames``: each stream's first ``preroll_samples``
    emitted samples are start padding to drop once. :meth:`flush` ends an
    utterance: it emits the carried tail (``flush_samples`` per stream) and
    resets the stream.

    ``generator``: an ``AdvocGenerator`` (moved to ``device``, eval mode),
    any callable (n, chunk, n_freq) normalized-dB → same, or None for the
    heuristic pipeline. ``n_streams`` independent streams go through one
    push; ``active`` masks let rows sit out a push with their carry kept
    bit-exactly. ``emit_dtype="int16"`` converts on the device with
    ``save_as_wav``'s convention, ``round(clip(x)·32767)``;
    ``mel_dtype="float16"`` casts the input on the host. ``device``
    defaults to "cuda" and raises if no card is present.

    Not ported yet (ROADMAP.md queue A): the ``lws_online`` and
    ``lws_block`` engines, ``mel_context`` and ``mesh``; they raise
    ``NotImplementedError``.
    """

    def __init__(
        self,
        generator=None,
        params: AudioParams = DEFAULT_PARAMS,
        chunk_frames: int = 64,
        overlap_frames: int = 8,
        gl_iters: int = 16,
        n_streams: int = 1,
        emit_dtype: str = "float32",
        mel_dtype: str = "float32",
        phase_engine: str = "gl",
        mel_context: int = 0,
        mesh=None,
        mel_projection: float | None = None,
        device=None,
    ):
        if phase_engine in ("lws_online", "lws_block"):
            raise NotImplementedError(
                f"phase_engine={phase_engine!r} is not ported yet (ROADMAP.md)")
        if phase_engine != "gl":
            raise ValueError(f"unknown phase_engine {phase_engine!r}")
        if mel_context:
            raise NotImplementedError("mel_context (a lws-engine option) is not ported yet "
                                      "(ROADMAP.md)")
        if mesh is not None:
            raise NotImplementedError("mesh (data-parallel) is not ported yet (ROADMAP.md)")
        if emit_dtype not in ("float32", "int16"):
            raise ValueError(f"unknown emit_dtype {emit_dtype!r}")
        if mel_dtype not in ("float32", "float16"):
            raise ValueError(f"unknown mel_dtype {mel_dtype!r}")
        if not 0 <= overlap_frames <= chunk_frames:
            raise ValueError(
                f"overlap_frames={overlap_frames} must be in [0, chunk_frames={chunk_frames}]"
            )
        self.device = _resolve_device(device)
        if isinstance(generator, torch.nn.Module):
            generator = generator.to(self.device).eval()
        self.generator = generator
        self.params = params
        self.chunk = chunk_frames
        self.overlap = overlap_frames
        self.gl_iters = gl_iters
        self.n_streams = n_streams
        self.emit_dtype = emit_dtype
        self.mel_dtype = np.dtype(mel_dtype)
        self.phase_engine = phase_engine
        if mel_projection is None:
            mel_projection = 1.0 if generator is not None else 0.0
        self.mel_projection = float(mel_projection)
        hop = params.hop_length
        self._ov_samps = overlap_frames * hop
        win_frames = overlap_frames + chunk_frames
        self._fade = torch.tensor(np.linspace(0.0, 1.0, self._ov_samps, dtype=np.float32),
                                  device=self.device)
        self._frame_idx = torch.arange(1, win_frames + 1, dtype=torch.float32,
                                       device=self.device)[:, None]
        # The first ov·hop emitted samples come from the zero-magnitude pad:
        # dropped once per stream. flush emits the carried tail, as many.
        self.preroll_samples = self._ov_samps
        self.latency_frames = 0
        self.flush_samples = self.preroll_samples + self.latency_frames * hop
        # Carries stay on the device between pushes.
        self._state_magtail: Tensor | None = None  # (n, ov, F) carried magnitudes
        self._state_wav: Tensor | None = None  # (n, ov·hop) pending overlap tails
        self._state_phase: tuple | None = None  # unit phase of frames −1, −2: (n, F) ×4

    def _run(self, mel: Tensor, active: Tensor, mag_tail: Tensor, prev_tail: Tensor,
             pc: Tensor, ps: Tensor, pc1: Tensor, ps1: Tensor) -> tuple:
        """One push: mel (n, chunk, M) f32, active (n,) bool; the carries in
        ``_ensure_state``'s order. Returns (emit, *new carries)."""
        p = self.params
        olds = (mag_tail, prev_tail, pc, ps, pc1, ps1)
        est = spectral.r9y9_melspec_to_magspec(mel, p)
        est_norm = spectral.normalize_db(spectral.amp_to_db(est, p) - p.ref_level_db, p)
        mag_norm = self.generator(est_norm) if self.generator is not None else est_norm
        mag = spectral.db_to_amp(spectral.denormalize_db(mag_norm, p) + p.ref_level_db)
        if self.mel_projection > 0.0:
            mag = spectral.mel_consistency_project(mag, mel, p, strength=self.mel_projection)
        # G-L on [carried ov frames | chunk], so consecutive windows share
        # ov frames of real time and the crossfade blends two estimates of
        # the same samples.
        mag_full = torch.cat([mag_tail, mag], dim=1)
        # Continue each stream's phase: the per-bin advance between its last
        # two frames, extrapolated linearly over the window.
        delta = torch.atan2(ps * pc1 - pc * ps1, pc * pc1 + ps * ps1)  # (n, F)
        base = torch.atan2(ps, pc)
        ang = base[:, None, :] + self._frame_idx[None] * delta[:, None, :]
        ov_s = self._ov_samps
        win_s = (self.overlap + self.chunk) * p.hop_length
        wav, (fc, fs) = spectral.griffin_lim(
            mag_full, win_s, n_iters=self.gl_iters, momentum=0.99, params=p,
            init_phase=(torch.cos(ang), torch.sin(ang)), return_final_phase=True,
        )
        head = wav[:, :ov_s] * self._fade + prev_tail * (1.0 - self._fade)
        emit = torch.cat([head, wav[:, ov_s : win_s - ov_s]], dim=1)
        if self.emit_dtype == "int16":
            emit = _to_pcm16(emit)
        emit = torch.where(_bmask(active, emit), emit, 0)
        news = (mag[:, self.chunk - self.overlap :], wav[:, win_s - ov_s :],
                fc[:, -1], fs[:, -1], fc[:, -2], fs[:, -2])
        return (emit,) + tuple(torch.where(_bmask(active, n), n, o) for n, o in zip(news, olds))

    def _fresh_state(self) -> tuple:
        n, f, dev = self.n_streams, self.params.n_freq, self.device
        mag_tail = torch.zeros((n, self.overlap, f), device=dev)
        tail = torch.zeros((n, self._ov_samps), device=dev)
        pc, ps = torch.ones((n, f), device=dev), torch.zeros((n, f), device=dev)
        return mag_tail, tail, (pc, ps, pc, ps)

    def reset(self, stream: int | None = None) -> None:
        """Reset all streams (default) or one stream's slot for a new
        utterance: tail to silence, phase to the zero-phase start."""
        if stream is None or self._state_wav is None:
            self._state_wav = self._state_phase = self._state_magtail = None
            return

        def put(x: Tensor, value: float) -> Tensor:
            # Out of place: the old carry may be an inference tensor, or
            # still read by a push in flight.
            x = x.clone()
            x[stream] = value
            return x

        self._state_wav = put(self._state_wav, 0.0)
        self._state_magtail = put(self._state_magtail, 0.0)
        pc, ps, pc1, ps1 = self._state_phase
        self._state_phase = (put(pc, 1.0), put(ps, 0.0), put(pc1, 1.0), put(ps1, 0.0))

    def _ensure_state(self) -> tuple:
        """Initialize any missing carry; return the carries in ``_run``'s
        argument order (after mel and active)."""
        # Tail and phase carries initialize independently (a test can ablate
        # the phase carry alone by setting _state_phase = None).
        if self._state_magtail is None:
            self._state_magtail = self._fresh_state()[0]
        if self._state_wav is None:
            self._state_wav = self._fresh_state()[1]
        if self._state_phase is None:
            self._state_phase = self._fresh_state()[2]
        return (self._state_magtail, self._state_wav, *self._state_phase)

    def _active(self, active) -> Tensor:
        if active is None:
            active = np.ones(self.n_streams, bool)
        active = np.asarray(active, dtype=bool)
        if active.shape != (self.n_streams,):
            raise ValueError(f"active must be ({self.n_streams},), got {active.shape}")
        return torch.from_numpy(active).to(self.device)

    @staticmethod
    def _out(emit: Tensor, squeeze: bool, readback: bool):
        emit = emit[0] if squeeze else emit
        return emit.cpu().numpy() if readback else emit

    def push(self, mel_chunk, active=None, readback: bool = True):
        """Vocode one chunk per stream: exactly ``chunk_frames·hop`` samples
        per stream, ``overlap_frames`` behind the input.

        (chunk_frames, n_mels) → (emit,), for ``n_streams == 1`` only;
        (n_streams, chunk_frames, n_mels) → (n_streams, emit).
        ``active``: optional (n_streams,) bools; inactive rows keep their
        carry bit-exactly, their mel row is ignored and their emit row is
        zeros. ``readback=True`` returns numpy; ``readback=False`` returns the
        emit as a tensor on the device without waiting for the card (the
        carries are safe to push against again at once).
        """
        mel_chunk = np.asarray(mel_chunk, dtype=self.mel_dtype)  # the uplink cast
        squeeze = mel_chunk.ndim == 2
        if squeeze:
            if self.n_streams != 1:
                raise ValueError(f"{self.n_streams} streams need a (n_streams, chunk, M) push")
            mel_chunk = mel_chunk[None]
        if mel_chunk.shape[:2] != (self.n_streams, self.chunk):
            raise ValueError(f"mel chunk {mel_chunk.shape} does not fit "
                             f"({self.n_streams}, {self.chunk}, n_mels)")
        mel = torch.tensor(mel_chunk, device=self.device).to(torch.float32)
        active_t = self._active(active)
        with torch.no_grad():
            emit, *carries = self._run(mel, active_t, *self._ensure_state())
        self._state_magtail, self._state_wav = carries[:2]
        self._state_phase = tuple(carries[2:])
        return self._out(emit, squeeze, readback)

    def flush(self, active=None, readback: bool = True):
        """End of utterance: emit each active stream's carried tail
        (``flush_samples``, the last window's own synthesis) and reset those
        streams; inactive rows emit zeros and keep their carry bit-exactly.
        Pushes of T frames plus the flush give T·hop + ``flush_samples``
        samples: drop the first ``flush_samples`` for exactly T·hop.
        Returns (flush_samples,) when ``n_streams == 1``, else
        (n_streams, flush_samples); ``readback`` as in :meth:`push`."""
        active_t = self._active(active)
        mag_tail, tail, pc, ps, pc1, ps1 = self._ensure_state()
        emit = _to_pcm16(tail) if self.emit_dtype == "int16" else tail
        emit = torch.where(_bmask(active_t, emit), emit, 0)
        m2 = _bmask(active_t, pc)
        self._state_magtail = torch.where(_bmask(active_t, mag_tail), 0.0, mag_tail)
        self._state_wav = torch.where(_bmask(active_t, tail), 0.0, tail)
        self._state_phase = (torch.where(m2, 1.0, pc), torch.where(m2, 0.0, ps),
                             torch.where(m2, 1.0, pc1), torch.where(m2, 0.0, ps1))
        return self._out(emit, self.n_streams == 1, readback)
