"""Waveform slice loader and the device-resident training corpus.

The port of ``advoc_tpu.data.loader``. The host decodes and slices raw
waveforms only; featurization runs on the device inside the train step.

* :func:`decode_extract_and_batch`: file list → batched fixed-length
  slices, decoded by a thread pool behind a bounded queue. It draws crops
  with the JAX loader's numpy RNG call sequence, so the same seed gives the
  same batches bit for bit.
* :class:`DeviceCorpus`: the whole corpus in device memory as int16; the
  host sends only (B,) crop starts a step and the crops are gathered on the
  device (:func:`hbm_data_step`), equal to the int16 wire's batches.
* :func:`device_prefetch`: host batches copied to the device ``depth``
  steps ahead, from pinned buffers.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from advoc_tpu_torch.data import audioio
from advoc_tpu_torch.data.synthetic import STRESS_KINDS, stress_fixture, synthetic_speech

__all__ = ["STRESS_KINDS", "DeviceCorpus", "decode_extract_and_batch", "device_prefetch",
           "hbm_data_step", "mulaw8_encode", "stress_fixture", "synthetic_speech"]


def _slice_plan_eval(n_frames: int, slice_len: int, hop: int) -> list[int]:
    if n_frames <= slice_len:
        return [0]
    return list(range(0, n_frames - slice_len + 1, hop))


_MULAW_LN256 = float(np.log(256.0))


def mulaw8_encode(x: np.ndarray) -> np.ndarray:
    """μ-law-compand a float waveform in [-1, 1] to int8 (μ = 255, ±127).

    ``y = sign(x)·log1p(255·|x|)/ln(256)`` quantized to 255 levels; lossy
    (≈ 38 dB SNR on speech). The device-side inverse is
    ``train.gan.as_waveform``. It failed the JAX package's training-wire
    quality gate (log-domain targets lift its quantization floor): kept for
    waveform-domain links, not for training.
    """
    y = np.sign(x) * np.log1p(255.0 * np.minimum(np.abs(x), 1.0)) / _MULAW_LN256
    return np.clip(np.rint(y * 127.0), -127, 127).astype(np.int8)


def _pcm16(x: np.ndarray) -> np.ndarray:
    """round(x·32768) as int16: the inverse of the decoder's /32768, exact for
    PCM16 sources."""
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def _check_rates(fps: list[str], meta: list[tuple[int, int]], sample_rate: int | None) -> None:
    if sample_rate is None:
        return
    bad = [(fp, sr) for fp, (_, sr) in zip(fps, meta) if sr != sample_rate]
    if bad:
        raise ValueError(
            f"{len(bad)} file(s) are not at the expected {sample_rate} Hz "
            f"(e.g. {bad[0][0]}: {bad[0][1]} Hz); resample them first with "
            "scripts/prepare_dataset.py"
        )


class _ProducerError:
    """Queue envelope carrying an exception from the producer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def decode_extract_and_batch(
    fps: Sequence[str],
    batch_size: int,
    slice_len: int,
    repeat: bool = True,
    shuffle: bool = True,
    seed: int = 0,
    normalize: bool = False,
    num_workers: int = 8,
    prefetch: int = 4,
    drop_remainder: bool = True,
    sample_rate: int | None = None,
    out_dtype: str = "float32",
    rows: Sequence[int] | None = None,
) -> Iterator[np.ndarray]:
    """Yield (batch_size, slice_len) waveform batches (numpy).

    ``rows``: decode only these rows of each batch, in this order, and
    yield (len(rows), slice_len): a data-parallel rank's part of the global
    batch. The crops are drawn as without it (the same RNG call sequence on
    every rank), so the ranks' rows together are the global batch.

    ``out_dtype``: "float32", "int16" (round(x·32768), lossless for PCM16
    sources and half the host→device bytes) or "mulaw8"
    (:func:`mulaw8_encode`). The train step normalizes integer batches on
    the device (``train.gan.as_waveform``).

    Training mode (``repeat=True``): an endless stream of random crops (a
    uniform file, a uniform offset). Eval mode (``repeat=False``): one pass
    of sequential non-overlapping windows per file; ``repeat`` alone picks
    the mode (``shuffle`` is accepted for the JAX signature, which never
    reads it either). ``sample_rate``, when
    given, must be every file's header rate. A decode error in the producer
    thread is re-raised in the consumer.
    """
    fps = list(map(str, fps))
    if not fps:
        raise ValueError("empty file list")
    rng = np.random.default_rng(seed)
    meta = [audioio.wav_num_frames(fp) for fp in fps]
    _check_rates(fps, meta, sample_rate)
    if out_dtype not in ("float32", "int16", "mulaw8"):
        raise ValueError(f"out_dtype must be float32, int16 or mulaw8, got {out_dtype!r}")
    if rows is not None and not all(0 <= r < batch_size for r in rows):
        raise ValueError(f"rows {list(rows)} are not rows of a batch of {batch_size}")

    def decode_one(args) -> np.ndarray:
        fp, start = args
        x = audioio.decode_audio_slice(fp, start, slice_len)
        if normalize:
            peak = np.abs(x).max()
            if peak > 0:
                x = x * (0.95 / peak)
        if out_dtype == "int16":
            return _pcm16(x)
        if out_dtype == "mulaw8":
            return mulaw8_encode(x)
        return x

    def gen_indices() -> Iterable[tuple[str, int]]:
        if repeat:
            while True:
                i = int(rng.integers(len(fps)))
                n, _ = meta[i]
                start = int(rng.integers(max(1, n - slice_len + 1)))
                yield fps[i], start
        else:
            for fp, (n, _) in zip(fps, meta):
                for start in _slice_plan_eval(n, slice_len, slice_len):
                    yield fp, start

    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    sentinel = object()

    def put_or_stop(item) -> bool:
        """A bounded put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        pool = ThreadPoolExecutor(max_workers=num_workers)

        def decode(batch: list) -> np.ndarray:
            if rows is not None:
                batch = [batch[r] for r in rows if r < len(batch)]
            return np.stack(list(pool.map(decode_one, batch)))

        try:
            batch: list = []
            for item in gen_indices():
                if stop.is_set():
                    return
                batch.append(item)
                if len(batch) == batch_size:
                    if not put_or_stop(decode(batch)):
                        return
                    batch = []
            if batch and not drop_remainder:
                put_or_stop(decode(batch))
        except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
            put_or_stop(_ProducerError(exc))
        finally:
            pool.shutdown(wait=False)
            put_or_stop(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    def iterate():
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()

    return iterate()


class DeviceCorpus:
    """The training corpus in device memory as int16; random crops sampled
    on the device.

    Staging the corpus once takes the host→device batch copy out of the
    steady-state loop: the host ships a (B,) vector of crop starts a step
    and :meth:`gather` cuts the crops on the device. :meth:`starts` draws
    (file, offset) with :func:`decode_extract_and_batch`'s training-mode RNG
    call sequence, and the buffer holds the same round(x·32768) samples
    the int16 wire ships, so a gathered batch equals the wire's batch
    exactly. Files shorter than ``slice_len`` are zero-padded, as the wire
    decoder pads a short read. ``device`` defaults to "cuda".
    """

    def __init__(self, fps: Sequence[str], slice_len: int,
                 sample_rate: int | None = None, device="cuda"):
        fps = list(map(str, fps))
        if not fps:
            raise ValueError("empty file list")
        meta = [audioio.wav_num_frames(fp) for fp in fps]
        _check_rates(fps, meta, sample_rate)
        self.slice_len = int(slice_len)
        self.n_files = len(fps)
        self._lens = np.array([n for n, _ in meta], np.int64)
        chunks, offsets, pos = [], [], 0
        for fp in fps:
            xi = _pcm16(audioio.decode_audio(fp))
            if len(xi) < slice_len:
                xi = np.pad(xi, (0, slice_len - len(xi)))
            offsets.append(pos)
            chunks.append(xi)
            pos += len(xi)
        flat = np.concatenate(chunks)
        self.nbytes = flat.nbytes
        self._offsets = np.array(offsets, np.int64)
        self.samples = torch.from_numpy(flat).to(device)
        self._ramp = torch.arange(self.slice_len, device=self.samples.device)

    def starts(self, batch_size: int, seed: int = 0) -> Iterator[np.ndarray]:
        """Endless (B,) int32 flat-start batches, the wire loader's RNG
        call sequence (same seed ⇒ same crops)."""
        rng = np.random.default_rng(seed)
        lens, offs, sl = self._lens, self._offsets, self.slice_len
        while True:
            out = np.empty(batch_size, np.int32)
            for b in range(batch_size):
                i = int(rng.integers(self.n_files))
                start = int(rng.integers(max(1, lens[i] - sl + 1)))
                out[b] = offs[i] + start
            yield out

    def gather(self, starts) -> torch.Tensor:
        """(B,) flat starts → (B, slice_len) int16 crops, cut on the device
        (starts clamped into the buffer, as ``lax.dynamic_slice`` clamps)."""
        s = torch.as_tensor(starts, device=self.samples.device).to(torch.int64)
        s = s.clamp(0, self.samples.shape[0] - self.slice_len)
        return self.samples[s[:, None] + self._ramp]


def hbm_data_step(step_fn, corpus: DeviceCorpus):
    """A ``(gstate, dstate, batch, generator)`` step taking crop starts in
    place of the batch: ``step(gstate, dstate, starts, generator)`` gathers
    the crops on the device and runs ``step_fn`` on them. Data-parallel,
    every rank stages the whole corpus and draws the global starts from
    the shared seed; ``train.gan.data_parallel`` around this step cuts them
    to the rank's rows before the gather."""

    def step(gstate, dstate, starts, generator=None):
        return step_fn(gstate, dstate, corpus.gather(starts), generator)

    return step


def device_prefetch(it: Iterator[np.ndarray], device="cuda", depth: int = 2):
    """Copy host batches onto ``device`` ``depth`` steps ahead of their use:
    on a CUDA device from pinned host buffers with ``non_blocking`` copies,
    so the copy overlaps the steps before it."""
    device = torch.device(device)
    buf: collections.deque = collections.deque()
    for x in it:
        t = torch.from_numpy(np.asarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        buf.append(t.to(device, non_blocking=True))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
