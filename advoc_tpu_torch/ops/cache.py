"""A cache for the constant tensors that the spectral core and the kernel
wrappers build on a device."""

from __future__ import annotations

import collections
import functools
import threading

import torch

from advoc_tpu_torch.ops.kernels._build import traced


def device_cache(maxsize: int):
    """A least-recently-used cache for a function that makes constant tensors
    on a device (hashable arguments), each built outside inference mode: a
    constant first built under ``torch.inference_mode()`` (the Vocoder's)
    would be an inference tensor, and every later autograd use of it (a loss
    through the STFT path) would fail.

    While a caller is traced (``torch.export``) a cached constant is
    returned as it is, so the trace records it as a constant of the program
    (``infer.export`` warms the caches with one eager call first); a missing
    one is built afresh and not kept: built there it is the trace's fake
    tensor, which a later eager call must not find in the cache."""

    def wrap(fn):
        entries: collections.OrderedDict = collections.OrderedDict()
        lock = threading.Lock()

        @functools.wraps(fn)
        def call(*args, **kwargs):
            key = (args, tuple(sorted(kwargs.items())))
            with lock:
                if key in entries:
                    entries.move_to_end(key)
                    return entries[key]
            if traced():
                return fn(*args, **kwargs)
            with torch.inference_mode(False):
                value = fn(*args, **kwargs)
            with lock:
                entries[key] = value
                while len(entries) > maxsize:
                    entries.popitem(last=False)
            return value

        return call

    return wrap
