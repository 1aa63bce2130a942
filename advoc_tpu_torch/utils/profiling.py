"""Tracing and timing of the port (``advoc_tpu.utils.profiling``).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome/TensorBoard trace (``*.pt.trace.json``, readable by TensorBoard's
  profile plugin and by Perfetto) into ``logdir``; the card's kernels are
  recorded where CUDA is present.
* :func:`timed_call`: wall-clock timing that synchronizes the card before
  each clock read (PyTorch returns before the card finishes).
* :class:`StepProfiler`: rolling steps/s and per-step wall statistics for
  training loops.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str | pathlib.Path):
    """Profile the block (host operators, and the card's kernels where CUDA
    is present) and write its trace into ``logdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))
                 ) as prof:
        yield prof


def tensors_in(x) -> list[torch.Tensor]:
    """The tensors of ``x``: a tensor, or nested tuples, lists and dicts."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors_in(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in tensors_in(item)]
    return []


def wait_for(out) -> None:
    """Wait until the card has finished the work that produced ``out``."""
    for t in tensors_in(out):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timed_call(fn: Callable, *args, trials: int = 3, warmup: int = 1):
    """(best seconds, last output) of ``fn(*args)`` over ``trials`` calls
    after ``warmup``; each timing ends when the card has finished."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        wait_for(out)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn(*args)
        wait_for(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


class StepProfiler:
    """Rolling per-step wall time statistics for training loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def steps_per_sec(self) -> float | None:
        if not self._times:
            return None
        return 1.0 / statistics.mean(self._times)

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {}
        return {
            "step_time_mean_s": statistics.mean(self._times),
            "step_time_p50_s": statistics.median(self._times),
            "step_time_max_s": max(self._times),
            "steps_per_sec": self.steps_per_sec or 0.0,
        }
