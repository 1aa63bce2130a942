"""Observability of training: TensorBoard summaries and step timing.

The port of ``advoc_tpu.train.metrics``. :func:`to_host` reads a dict of
device scalars back in one stacked copy, never one per scalar.
:class:`SummaryWriter` writes scalars, images and audio through
``torch.utils.tensorboard`` where the ``tensorboard`` package imports, and
does nothing where it does not (as the JAX writer does without TensorFlow).
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch


def to_host(metrics: Mapping[str, torch.Tensor | float]) -> dict[str, float]:
    """A dict of scalars (0-d tensors on one device, or numbers) as Python
    floats, read back with a single copy."""
    keys = sorted(metrics.keys())
    stacked = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).reshape(())
                           for k in keys])
    return {k: float(v) for k, v in zip(keys, stacked.cpu().numpy())}


class SummaryWriter:
    """Scalar, image and audio summaries; a no-op without tensorboard."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError:
            self._writer = None
        else:
            self._writer = _Writer(self.logdir)

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        if self._writer is None:
            return
        for k, v in values.items():
            self._writer.add_scalar(k, float(v), step)
        self._writer.flush()

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        """img: (H, W) or (H, W, C) float in [0, 1] (e.g. a spectrogram)."""
        if self._writer is None:
            return
        img = np.asarray(img, np.float32)
        self._writer.add_image(tag, img, step, dataformats="HW" if img.ndim == 2 else "HWC")
        self._writer.flush()

    def audio(self, step: int, tag: str, wav: np.ndarray, sample_rate: int) -> None:
        """wav: (T,) float in [-1, 1]."""
        if self._writer is None:
            return
        snd = torch.from_numpy(np.clip(np.asarray(wav, np.float32).reshape(1, -1), -1, 1))
        self._writer.add_audio(tag, snd, step, sample_rate=sample_rate)
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class StepTimer:
    """Wall-clock steps/s with the first ``warmup`` steps left out."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.t0 = None

    def tick(self) -> float | None:
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
            return None
        if self.t0 is None or self.count <= self.warmup:
            return None
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)
