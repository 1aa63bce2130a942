"""Vocoders: mel in, waveform out, on one device or over a mesh.

The port of ``advoc_tpu.infer.vocoder``. :class:`Vocoder` is the offline
path. Per call: the pinv heuristic estimate, conversion to normalized dB,
the generator over ``chunk_frames`` windows with ``overlap_frames`` of
linear crossfade in the dB domain, conversion back to amplitude, the
mel-consistency projection, then fast Griffin-Lim (or true LWS) over the
whole utterance. Lengths are bucketed to multiples of ``chunk_frames`` and
the waveform is cropped back to the true length, as in the JAX package.
:meth:`Vocoder.vocode_longform` runs any length through one fixed-tile
:class:`StreamingVocoder`, the stateful chunk-by-chunk serving engine, whose
phase engines are G-L with a crossfade and two kinds of streaming LWS.
Both take a ('data',) :class:`~advoc_tpu_torch.parallel.mesh.Mesh`
(``mesh=``): the batch, or the streams, split over its devices, each
shard run on its device's replica of the generator.
"""

from __future__ import annotations

import numpy as np
import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.cache import device_cache
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS
from advoc_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from advoc_tpu_torch.utils import profiling

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


@device_cache(maxsize=16)
def _crossfade_on(chunk: int, overlap: int, device: torch.device) -> Tensor:
    """:func:`_crossfade_weights` as (1, chunk, 1) on ``device``, moved once:
    a host copy per call waits."""
    return torch.as_tensor(_crossfade_weights(chunk, overlap), device=device)[None, :, None]


def chunked_generator_apply(generator, chunk: int, overlap: int, t_frames: int):
    """The generator over ``chunk``-frame windows with dB-domain crossfade.

    Returns ``est_norm (B, t_frames, F) → mag_norm``: every window of every
    row goes through ``generator`` in one batch, and the outputs are joined
    by the crossfade weights (normalized, so the fade cancels at the edges).
    Under a profiler the whole is the range ``advoc.windows`` and the
    generator's call in it ``advoc.unet``
    (:func:`~advoc_tpu_torch.utils.profiling.span`).
    """
    starts = [int(s) for s in _chunk_windows(t_frames, chunk, chunk - overlap)]

    def apply(est_norm: Tensor) -> Tensor:
        b, _, n_bins = est_norm.shape
        with profiling.span("windows"):
            weights = _crossfade_on(chunk, overlap, est_norm.device)
            chunks = torch.stack([est_norm[:, s : s + chunk] for s in starts], dim=1)
            nc = len(starts)
            with profiling.span("unet"):
                repaired = generator(chunks.reshape(b * nc, chunk, n_bins))
            repaired = repaired.reshape(b, nc, chunk, n_bins)
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


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (data_mesh), got {type(mesh).__name__}")


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
    at momentum 0.99, "gl" classic G-L, "lws_exact" true LWS
    (:func:`~advoc_tpu_torch.ops.spectral.lws`, ``gl_iters`` sweeps, never
    the G-L kernel). ``phase_impl``: "auto" takes the
    CUDA G-L kernel on a CUDA device whenever n_fft == 4 · hop (the JAX
    Vocoder's rule for its Pallas kernels; the kernel iterates on the whole
    utterance, so no length is excluded) and the matmul scan otherwise;
    "kernel" always takes the kernel function (its plain version on the
    CPU); "xla" always takes the matmul scan. ``gl_precision`` is the
    G-L's precision, as in the JAX Vocoder: None or "default" is JAX's
    default, "highest" fp32 throughout. The kernel form's default is
    split_synth (the tensor-core kernel on the card); the matmul scan's
    (``phase_impl="xla"``, and ``vocode_longform``'s engine) is bf16
    operands with fp32 accumulation, JAX's single-pass DEFAULT. ``phase_init``
    "pghi" starts G-L (either form) from
    :func:`~advoc_tpu_torch.ops.spectral.pghi_init_phase` with
    ``pghi_coef``, "zero" from zero phase.
    ``device`` defaults to "cuda" and raises if no card is present.

    ``mesh`` (a :class:`~advoc_tpu_torch.parallel.mesh.Mesh`): each call
    pads the batch to a multiple of the mesh, runs one contiguous shard of
    it on each mesh device (the generator replicated there, G-L on that
    device, the kernel included), gathers the waveforms on ``device``
    (default: the mesh's first device) and crops the padding. The shards'
    launches are enqueued one after another with no wait between them, so
    the devices run at once.
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
        _check_mesh(mesh)
        if phase_init not in ("zero", "pghi"):
            raise ValueError(f"unknown phase_init {phase_init!r}")
        if phase_method not in ("lws", "gl", "lws_exact"):
            raise ValueError(f"unknown phase_method {phase_method!r}")
        if phase_impl not in ("auto", "kernel", "xla"):
            raise ValueError(f"unknown phase_impl {phase_impl!r}")
        if gl_precision not in (None, "default", "highest"):
            raise ValueError(f"unknown gl_precision {gl_precision!r}")
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = _resolve_device(device)
        self.generator = generator.to(self.device).eval() if generator is not None else None
        self.mesh = mesh
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
        if self.phase_method == "lws_exact":
            return False
        if self.phase_impl != "auto":
            return self.phase_impl == "kernel"
        p = self.params
        return self.device.type == "cuda" and p.n_fft == 4 * p.hop_length

    def bucket(self, t: int) -> int:
        """Round up to a multiple of chunk_frames."""
        c = self.chunk
        return max(c, ((t + c - 1) // c) * c)

    def _run(self, mel: Tensor, generator) -> Tensor:
        """(B, T, M) bucketed mel → (B, T·hop) waveform, on mel's device with
        ``generator`` (the Vocoder's, or its replica there). Under a profiler
        its stages are the ranges ``advoc.estimate``, ``advoc.windows``
        (:func:`chunked_generator_apply`), ``advoc.project`` and
        ``advoc.gl``."""
        p = self.params
        t_frames = mel.shape[1]
        with profiling.span("estimate"):
            est = spectral.r9y9_melspec_to_magspec(mel, p)
            est_norm = spectral.normalize_db(spectral.amp_to_db(est, p) - p.ref_level_db, p)
        if generator is not None:
            apply = chunked_generator_apply(generator, self.chunk, self.overlap, t_frames)
            mag_norm = apply(est_norm)
        else:
            mag_norm = est_norm
        mag = spectral.db_to_amp(spectral.denormalize_db(mag_norm, p) + p.ref_level_db)
        if self.mel_projection > 0.0:
            with profiling.span("project"):
                mag = spectral.mel_consistency_project(mag, mel, p, strength=self.mel_projection)
        length = t_frames * p.hop_length
        with profiling.span("gl"):
            if self.phase_method == "lws_exact":
                return spectral.lws(mag, length, n_sweeps=self.gl_iters, params=p)
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
                precision=self.gl_precision, init_phase=init,
            )

    def __call__(self, mel) -> Tensor:
        """Vocode (T, M) or (B, T, M), numpy or tensor; returns a float32
        tensor on the Vocoder's device, cropped to the true length. Under a
        profiler the call is the range ``advoc.vocode`` (on a mesh, with
        each shard's stages in it)."""
        with profiling.span("vocode"):
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
            length = t * self.params.hop_length
            with torch.inference_mode():
                if self.mesh is None:
                    wav = self._run(mel, self.generator)[:, :length]
                else:
                    b, n = mel.shape[0], self.mesh.size
                    if b % n:  # silent rows to a whole shard each, cropped below
                        mel = torch.nn.functional.pad(mel, (0, 0, 0, 0, 0, n - b % n))
                    gens = (replicate(self.generator, self.mesh) if self.generator is not None
                            else [None] * n)
                    parts = [self._run(m, g)[:, :length]
                             for m, g in zip(shard_batch(mel, self.mesh), gens, strict=True)]
                    wav = torch.cat([x.to(self.device, non_blocking=True) for x in parts])[:b]
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
        the Vocoder's G-L budget and precision. Tiles are enqueued with
        ``readback=False`` and the queue is drained every ``sync_every``
        tiles.

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
                mel_projection=self.mel_projection, gl_precision=self.gl_precision,
                device=self.device,
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
    """Low-latency stateful chunk vocoder, the port of the JAX package's
    ``StreamingVocoder``.

    Feed consecutive non-overlapping mel chunks of ``chunk_frames``; each
    push returns ``chunk_frames·hop`` samples per stream. Each stream's first
    ``preroll_samples`` emitted samples are start padding to drop once, and
    emissions trail the input by ``latency_frames``. :meth:`flush` ends an
    utterance: it emits what the engine still holds (``flush_samples`` per
    stream) and resets the stream, so pushes of T frames plus the flush,
    with the first ``flush_samples`` dropped, give exactly T·hop samples.

    ``phase_engine``:

    * ``"gl"``: the engine carries each stream's last ``overlap_frames``
      magnitude frames, runs fast G-L (momentum 0.99, ``gl_iters``, the
      matmul form at ``gl_precision``: None means "highest", fp32, as in the
      JAX package; "default" is JAX's single-pass bf16 loop) on [carried
      frames | chunk] from a phase extrapolated from the stream's last two
      frames (RTISI-style), and crossfades the ``overlap_frames·hop`` samples
      that consecutive windows both synthesize. Preroll ``overlap_frames·hop``,
      no latency.
    * ``"lws_online"``: true causal streaming LWS. The chunk's frames arrive
      one at a time into :func:`~advoc_tpu_torch.ops.spectral.lws_online_push`
      and the finalized frames overlap-add through the streaming iSTFT: no
      crossfade, globally coherent phase, the same frames however the
      signal is cut into chunks. ``lws_look_ahead`` frames of latency,
      ``lws_sweeps`` (default 2) sweeps per arrival.
    * ``"lws_block"``: the same stream with the block schedule of
      :func:`~advoc_tpu_torch.ops.spectral.lws_block_push`: the whole chunk
      arrives at once and ``lws_sweeps`` (default 4) multicolor sweeps of
      ``lws_colors`` colors refine every mutable frame, the new ones seeded
      by ``lws_init``.

    The lws engines drop a ``n_fft // 2`` preroll (the iSTFT centre pad).
    ``mel_context=c`` (lws engines) carries 2c mel frames, so the generator
    sees at least c frames on both sides of every frame it hands on, at c
    more frames of latency (``latency_frames = lws_look_ahead +
    mel_context``); ``chunk_frames + 2·mel_context`` must suit the
    generator (the U-Net needs a multiple of 2^depth).

    ``generator``: an ``AdvocGenerator`` (moved to ``device``, eval mode),
    any callable (n, frames, n_freq) normalized-dB → same, or None for the
    heuristic pipeline. ``n_streams`` independent streams go through one
    push; ``active`` masks let rows sit out a push with their carry kept
    bit-exactly. ``emit_dtype="int16"`` converts on the device with
    ``save_as_wav``'s convention, ``round(clip(x)·32767)``;
    ``mel_dtype="float16"`` casts the input on the host. ``device``
    defaults to "cuda" and raises if no card is present.

    ``mesh`` (a :class:`~advoc_tpu_torch.parallel.mesh.Mesh`): the streams
    split over its devices, ``n_streams`` / mesh size rows each (it must
    divide). Each device runs an engine of its rows with its replica of
    the generator (a module; any other callable only where the mesh has
    one device) and holds their carries between pushes; a push or flush
    runs every shard's engine, then gathers the emits on ``device``
    (default: the mesh's first device). Masks and ``reset`` work as
    without a mesh.
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
        lws_look_ahead: int = 2,
        lws_sweeps: int | None = None,
        lws_colors: int = 4,
        lws_init: str = "advance",
        mel_context: int = 0,
        mesh=None,
        mel_projection: float | None = None,
        gl_precision: str | None = None,
        device=None,
    ):
        shard_kw = {k: v for k, v in locals().items()
                    if k not in ("self", "generator", "n_streams", "mesh", "device")}
        _check_mesh(mesh)
        if mesh is not None and n_streams % mesh.size:
            raise ValueError(f"n_streams={n_streams} must be divisible by the mesh size "
                             f"{mesh.size}")
        if emit_dtype not in ("float32", "int16"):
            raise ValueError(f"unknown emit_dtype {emit_dtype!r}")
        if mel_dtype not in ("float32", "float16"):
            raise ValueError(f"unknown mel_dtype {mel_dtype!r}")
        if phase_engine not in ("gl", "lws_online", "lws_block"):
            raise ValueError(f"unknown phase_engine {phase_engine!r}")
        self._lws_engine = phase_engine != "gl"
        if mel_context and not self._lws_engine:
            raise ValueError("mel_context is a lws-engine option (the gl engine handles "
                             "chunk boundaries with its waveform crossfade)")
        if not 0 <= mel_context <= chunk_frames:
            raise ValueError(f"mel_context={mel_context} must be in [0, chunk_frames={chunk_frames}]")
        if not 0 <= overlap_frames <= chunk_frames:
            raise ValueError(
                f"overlap_frames={overlap_frames} must be in [0, chunk_frames={chunk_frames}]"
            )
        if gl_precision not in (None, "default", "highest"):
            raise ValueError(f"unknown gl_precision {gl_precision!r}")
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = _resolve_device(device)
        if isinstance(generator, torch.nn.Module):
            generator = generator.to(self.device).eval()
        self.generator = generator
        # The engines of a mesh's shards, one per device: they hold the carries.
        self._shards: list[StreamingVocoder] = []
        if mesh is not None:
            if generator is None or isinstance(generator, torch.nn.Module):
                gens = replicate(generator, mesh) if generator is not None else [None] * mesh.size
            elif len(set(mesh.devices)) == 1:
                gens = [generator] * mesh.size
            else:
                raise TypeError("a mesh over several devices replicates the generator: pass "
                                "an nn.Module, not another callable")
            self._shards = [StreamingVocoder(g, n_streams=n_streams // mesh.size, device=dev,
                                             **shard_kw)
                            for g, dev in zip(gens, mesh.devices, strict=True)]
        self.params = params
        self.chunk = chunk_frames
        self.overlap = overlap_frames
        self.gl_iters = gl_iters
        self.gl_precision = "highest" if gl_precision is None else gl_precision
        self.n_streams = n_streams
        self.emit_dtype = emit_dtype
        self.mel_dtype = np.dtype(mel_dtype)
        self.phase_engine = phase_engine
        self.lws_look_ahead = lws_look_ahead
        if lws_sweeps is None:  # the JAX package's measured defaults
            lws_sweeps = 4 if phase_engine == "lws_block" else 2
        self.lws_sweeps = lws_sweeps
        self.lws_colors = lws_colors
        self.lws_init = lws_init
        self.mel_context = mel_context
        if mel_projection is None:
            mel_projection = 1.0 if generator is not None else 0.0
        self.mel_projection = float(mel_projection)
        hop = params.hop_length
        self._ov_samps = overlap_frames * hop
        if self._lws_engine:
            self.preroll_samples = params.n_fft // 2  # the iSTFT centre pad
            self.latency_frames = lws_look_ahead + mel_context
        else:
            win_frames = overlap_frames + chunk_frames
            self._fade = torch.tensor(np.linspace(0.0, 1.0, self._ov_samps, dtype=np.float32),
                                      device=self.device)
            self._frame_idx = torch.arange(1, win_frames + 1, dtype=torch.float32,
                                           device=self.device)[:, None]
            # The first ov·hop emitted samples come from the zero-magnitude
            # pad: dropped once per stream. flush emits the carried tail.
            self.preroll_samples = self._ov_samps
            self.latency_frames = 0
        self.flush_samples = self.preroll_samples + self.latency_frames * hop
        # Carries stay on the device between pushes. gl engine:
        self._state_magtail: Tensor | None = None  # (n, ov, F) carried magnitudes
        self._state_wav: Tensor | None = None  # (n, ov·hop) pending overlap tails
        self._state_phase: tuple | None = None  # unit phase of frames −1, −2: (n, F) ×4
        # lws engines:
        self._state_lws: tuple | None = None  # lws_online_init's (s_re, s_im, mbuf)
        self._state_ola: tuple | None = None  # istft_stream_init's (ola, wsum)
        self._state_mel: Tensor | None = None  # (n, 2·mel_context, M) mel context

    def _repair(self, mel: Tensor) -> Tensor:
        """Mel (n, frames, M) → linear magnitude: the pinv estimate, through
        the generator in normalized dB when there is one."""
        p = self.params
        est = spectral.r9y9_melspec_to_magspec(mel, p)
        est_norm = spectral.normalize_db(spectral.amp_to_db(est, p) - p.ref_level_db, p)
        mag_norm = self.generator(est_norm) if self.generator is not None else est_norm
        return spectral.db_to_amp(spectral.denormalize_db(mag_norm, p) + p.ref_level_db)

    def _emit(self, x: Tensor, active: Tensor) -> Tensor:
        """The emit dtype, zeros on inactive rows."""
        if self.emit_dtype == "int16":
            x = _to_pcm16(x)
        return torch.where(_bmask(active, x), x, 0)

    def _run(self, mel: Tensor, active: Tensor, mag_tail: Tensor, prev_tail: Tensor,
             pc: Tensor, ps: Tensor, pc1: Tensor, ps1: Tensor) -> tuple:
        """One gl push: mel (n, chunk, M) f32, active (n,) bool; the carries
        in ``_ensure_state``'s order. Returns (emit, *new carries)."""
        p = self.params
        olds = (mag_tail, prev_tail, pc, ps, pc1, ps1)
        mag = self._repair(mel)
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
            precision=self.gl_precision, init_phase=(torch.cos(ang), torch.sin(ang)),
            return_final_phase=True,
        )
        head = wav[:, :ov_s] * self._fade + prev_tail * (1.0 - self._fade)
        emit = self._emit(torch.cat([head, wav[:, ov_s : win_s - ov_s]], dim=1), active)
        news = (mag[:, self.chunk - self.overlap :], wav[:, win_s - ov_s :],
                fc[:, -1], fs[:, -1], fc[:, -2], fs[:, -2])
        return (emit,) + tuple(torch.where(_bmask(active, n), n, o) for n, o in zip(news, olds))

    def _lws_push(self, mag: Tensor, carry: tuple):
        """The engine's LWS stream step: ((emit_re, emit_im), carry)."""
        if self.phase_engine == "lws_block":
            return spectral.lws_block_push(
                mag, carry, n_sweeps=self.lws_sweeps, look_ahead=self.lws_look_ahead,
                colors=self.lws_colors, init=self.lws_init, params=self.params)
        return spectral.lws_online_push(mag, carry, n_sweeps=self.lws_sweeps,
                                        look_ahead=self.lws_look_ahead, params=self.params)

    def _lws_run(self, mel: Tensor, active: Tensor, mel_ctx: Tensor, s_re: Tensor,
                 s_im: Tensor, mbuf: Tensor, ola: Tensor, wsum: Tensor) -> tuple:
        """One lws push; the carries in ``_ensure_state``'s order. Returns
        (emit, *new carries)."""
        p, ctx = self.params, self.mel_context
        olds = (mel_ctx, s_re, s_im, mbuf, ola, wsum)
        # The generator sees [2·ctx carried frames | chunk]; only frames with
        # ctx frames of context on both sides go on, and the chunk's last
        # ctx frames wait for the next push. A stream starts from zero mel
        # context, the silence level (normalized 0.0 is the dB floor).
        mel_in = torch.cat([mel_ctx, mel], dim=1)
        mag = self._repair(mel_in)
        if ctx:
            mag = mag[:, ctx : ctx + self.chunk]
            mel_ctx = mel_in[:, -2 * ctx :]
        if self.mel_projection > 0.0:
            mag = spectral.mel_consistency_project(mag, mel, p, strength=self.mel_projection)
        (em_re, em_im), lws_carry = self._lws_push(mag, (s_re, s_im, mbuf))
        emit, ola_carry = spectral.istft_stream_push(torch.complex(em_re, em_im), (ola, wsum), p)
        news = (mel_ctx, *lws_carry, *ola_carry)
        return (self._emit(emit, active),) + tuple(
            torch.where(_bmask(active, n), n, o) for n, o in zip(news, olds))

    def _lws_flush_run(self, active: Tensor, mel_ctx: Tensor, s_re: Tensor, s_im: Tensor,
                       mbuf: Tensor, ola: Tensor, wsum: Tensor) -> tuple:
        """End of utterance for the lws engines. Emits (a) the ctx frames
        withheld for the generator's right context, completed with silence,
        (b) the look-ahead frames still refining, taken as they are (as the
        offline ``lws_online`` takes its buffer tail), and (c) the streaming
        iSTFT's tail, cropped to n_fft // 2 so that the assembled stream is
        exactly T·hop samples. Flushed rows start afresh; the others keep
        their carry bit for bit."""
        p, ctx, la = self.params, self.mel_context, self.lws_look_ahead
        olds = (mel_ctx, s_re, s_im, mbuf, ola, wsum)
        carry, parts = (s_re, s_im, mbuf), []
        if ctx:
            silence = mel_ctx.new_zeros((mel_ctx.shape[0], self.chunk, p.n_mels))
            mel_in = torch.cat([mel_ctx, silence], dim=1)
            # The withheld real frames are positions ctx … 2·ctx − 1.
            mag = self._repair(mel_in)[:, ctx : 2 * ctx]
            if self.mel_projection > 0.0:
                mag = spectral.mel_consistency_project(mag, mel_in[:, ctx : 2 * ctx], p,
                                                       strength=self.mel_projection)
            em, carry = self._lws_push(mag, carry)
            parts.append(torch.complex(*em))
        if la:
            parts.append(torch.complex(*spectral.lws_online_drain(carry, la, p)))
        if parts:
            emit, (ola, wsum) = spectral.istft_stream_push(torch.cat(parts, dim=1), (ola, wsum), p)
        else:
            emit = ola.new_zeros((ola.shape[0], 0))
        tail = spectral.istft_stream_flush((ola, wsum), p)[:, : p.n_fft // 2]
        emit = self._emit(torch.cat([emit, tail], dim=1), active)
        return (emit,) + tuple(torch.where(_bmask(active, o), 0.0, o) for o in olds)

    def _fresh_state(self) -> tuple:
        n, f, dev = self.n_streams, self.params.n_freq, self.device
        mag_tail = torch.zeros((n, self.overlap, f), device=dev)
        tail = torch.zeros((n, self._ov_samps), device=dev)
        pc, ps = torch.ones((n, f), device=dev), torch.zeros((n, f), device=dev)
        return mag_tail, tail, (pc, ps, pc, ps)

    def reset(self, stream: int | None = None) -> None:
        """Reset all streams (default) or one stream's slot for a new
        utterance: every carry of that row to a fresh stream's (gl: tail to
        silence, phase to the zero-phase start; lws: zeros, so the next
        emissions start with the preroll again)."""
        if self._shards:
            k = self.n_streams // len(self._shards)
            for i, sv in enumerate(self._shards):
                if stream is None or stream // k == i:
                    sv.reset(None if stream is None else stream % k)
            return

        def put(x: Tensor, value: float) -> Tensor:
            # Out of place: the old carry may be an inference tensor, or
            # still read by a push in flight.
            x = x.clone()
            x[stream] = value
            return x

        if self._lws_engine:
            if stream is None or self._state_lws is None:
                self._state_lws = self._state_ola = self._state_mel = None
                return
            self._state_lws = tuple(put(x, 0.0) for x in self._state_lws)
            self._state_ola = tuple(put(x, 0.0) for x in self._state_ola)
            if self._state_mel is not None:
                self._state_mel = put(self._state_mel, 0.0)
            return
        if stream is None or self._state_wav is None:
            self._state_wav = self._state_phase = self._state_magtail = None
            return
        self._state_wav = put(self._state_wav, 0.0)
        self._state_magtail = put(self._state_magtail, 0.0)
        pc, ps, pc1, ps1 = self._state_phase
        self._state_phase = (put(pc, 1.0), put(ps, 0.0), put(pc1, 1.0), put(ps1, 0.0))

    def _ensure_state(self) -> tuple:
        """Initialize any missing carry; return the carries in the order of
        ``_run``'s or ``_lws_run``'s arguments (after mel and active)."""
        n, p, dev = self.n_streams, self.params, self.device
        if self._lws_engine:
            if self._state_lws is None:
                self._state_lws = spectral.lws_online_init(n, self.lws_look_ahead, p, dev)
            if self._state_ola is None:
                self._state_ola = spectral.istft_stream_init(n, p, dev)
            if self._state_mel is None:
                self._state_mel = torch.zeros((n, 2 * self.mel_context, p.n_mels), device=dev)
            return (self._state_mel, *self._state_lws, *self._state_ola)
        # Tail and phase carries initialize independently (a test can ablate
        # the phase carry alone by setting _state_phase = None).
        if self._state_magtail is None:
            self._state_magtail = self._fresh_state()[0]
        if self._state_wav is None:
            self._state_wav = self._fresh_state()[1]
        if self._state_phase is None:
            self._state_phase = self._fresh_state()[2]
        return (self._state_magtail, self._state_wav, *self._state_phase)

    def _store(self, carries: list) -> None:
        """Keep the carries a run returned (``_ensure_state``'s order)."""
        if self._lws_engine:
            self._state_mel = carries[0]
            self._state_lws = tuple(carries[1:4])
            self._state_ola = tuple(carries[4:])
        else:
            self._state_magtail, self._state_wav = carries[:2]
            self._state_phase = tuple(carries[2:])

    def _active_np(self, active) -> np.ndarray:
        if active is None:
            active = np.ones(self.n_streams, bool)
        active = np.asarray(active, dtype=bool)
        if active.shape != (self.n_streams,):
            raise ValueError(f"active must be ({self.n_streams},), got {active.shape}")
        return active

    def _active(self, active) -> Tensor:
        return torch.from_numpy(self._active_np(active)).to(self.device)

    def _sharded(self, method: str, squeeze: bool, readback: bool, active, *mel):
        """``method`` ("push" or "flush") of every shard's engine on its rows
        (of ``active`` and of the mel chunk, if given), the emits gathered
        on ``device``."""
        active = self._active_np(active)
        k = self.n_streams // len(self._shards)
        emits = [getattr(sv, method)(*(m[i * k : (i + 1) * k] for m in mel),
                                     active=active[i * k : (i + 1) * k], readback=False)
                 for i, sv in enumerate(self._shards)]
        emit = torch.cat([e.reshape(k, -1).to(self.device, non_blocking=True) for e in emits])
        return self._out(emit, squeeze, readback)

    @staticmethod
    def _out(emit: Tensor, squeeze: bool, readback: bool):
        emit = emit[0] if squeeze else emit
        return emit.cpu().numpy() if readback else emit

    def push(self, mel_chunk, active=None, readback: bool = True):
        """Vocode one chunk per stream: exactly ``chunk_frames·hop`` samples
        per stream, ``preroll_samples`` of start padding at a stream's start
        and ``latency_frames`` behind the input.

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
        if self._shards:
            return self._sharded("push", squeeze, readback, active, mel_chunk)
        mel = torch.tensor(mel_chunk, device=self.device).to(torch.float32)
        run = self._lws_run if self._lws_engine else self._run
        with torch.no_grad():
            emit, *carries = run(mel, self._active(active), *self._ensure_state())
        self._store(carries)
        return self._out(emit, squeeze, readback)

    def flush(self, active=None, readback: bool = True):
        """End of utterance: emit each active stream's pending audio
        (``flush_samples``: gl, the last window's own synthesis of the
        carried tail; lws, the withheld and look-ahead frames and the
        iSTFT tail) and reset those streams; inactive rows emit zeros and
        keep their carry bit-exactly. Pushes of T frames plus the flush give
        T·hop + ``flush_samples`` samples: drop the first ``flush_samples``
        for exactly T·hop. Returns (flush_samples,) when ``n_streams == 1``,
        else (n_streams, flush_samples); ``readback`` as in :meth:`push`."""
        if self._shards:
            return self._sharded("flush", self.n_streams == 1, readback, active)
        active_t = self._active(active)
        if self._lws_engine:
            with torch.no_grad():
                emit, *carries = self._lws_flush_run(active_t, *self._ensure_state())
            self._store(carries)
            return self._out(emit, self.n_streams == 1, readback)
        mag_tail, tail, pc, ps, pc1, ps1 = self._ensure_state()
        emit = self._emit(tail, active_t)
        m2 = _bmask(active_t, pc)
        self._state_magtail = torch.where(_bmask(active_t, mag_tail), 0.0, mag_tail)
        self._state_wav = torch.where(_bmask(active_t, tail), 0.0, tail)
        self._state_phase = (torch.where(m2, 1.0, pc), torch.where(m2, 0.0, ps),
                             torch.where(m2, 1.0, pc1), torch.where(m2, 0.0, ps1))
        return self._out(emit, self.n_streams == 1, readback)
