"""Tracing and timing of the port (``advoc_tpu.utils.profiling``).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome/TensorBoard trace (``*.pt.trace.json``, readable by TensorBoard's
  profile plugin and by Perfetto) into ``logdir``; the card's kernels are
  recorded where CUDA is present.
* :func:`span`: the program's own stage ranges, ``advoc.<name>`` in the
  trace of any ``torch.profiler`` (:func:`trace`'s too), around the
  kernels they launch; never while the caller is traced (``torch.export``).
  Off, a span is one check.
* :func:`device_ms`: the card's time in each ``advoc.`` range, from a
  profiler's events: every kernel counts in the ranges open on the host
  when it was launched.
* :func:`timed_call`: wall-clock timing that synchronizes the card before
  each clock read (PyTorch returns before the card finishes).
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Callable, Iterable

import torch

from advoc_tpu_torch.ops.kernels import _build

PREFIX = "advoc."
# A ``record_function`` range without the operator call that
# ``torch.profiler.record_function`` makes: the same range in the trace, on
# the thread that opens it, at a quarter of the host cost under a profiler.
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str | pathlib.Path):
    """Profile the block (host operators, and the card's kernels where CUDA
    is present) and write its trace into ``logdir``; yields the profiler
    (its events: ``prof.profiler.kineto_results.events()``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))
                 ) as prof:
        yield prof


def span(name: str):
    """A context manager: the block as the range ``advoc.<name>`` while a
    ``torch.profiler`` records on this thread and the caller is not traced,
    else nothing at the cost of one check."""
    if _build.traced() or not torch.autograd._profiler_enabled():
        return _OFF
    return _range(PREFIX + name)


def device_ms(events: Iterable) -> dict[str, float]:
    """Device ms of each ``advoc.`` range in one ``Vocoder`` call: the
    kernels, copies and sets that a range's block launched, its nested
    ranges' included, summed over the ``advoc.vocode`` ranges and divided
    by their number; empty without one. ``events``: a profiler's
    (``prof.profiler.kineto_results.events()``). A kernel belongs to the
    ranges open on the host when the runtime call that launched it ran
    (their correlation id); the ranges are taken as one thread's."""
    cuda, per = torch.autograd.DeviceType.CUDA, PREFIX + "vocode"
    edges, launches, work = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or name.startswith(PREFIX)):
                work.append(e)
        elif name.startswith(PREFIX):
            s = e.start_ns()
            edges += [(s, 0, name), (s + e.duration_ns(), 2, name)]
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            edges.append((e.start_ns(), 1, e.correlation_id()))
    edges.sort(key=lambda x: x[:2])
    open_: dict[str, int] = {}
    n_per = 0
    for _, kind, key in edges:
        if kind == 0:
            open_[key] = open_.get(key, 0) + 1
            n_per += key == per
        elif kind == 2:
            open_[key] -= 1
        elif open_.get(per):
            launches[key] = [n for n, c in open_.items() if c]
    if not n_per:
        return {}
    out = dict.fromkeys(sorted(open_), 0.0)
    for e in work:
        names = launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id() or -1)
        for n in names or ():
            out[n] += e.duration_ns() / 1e6
    return {n: v / n_per for n, v in out.items()}


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
