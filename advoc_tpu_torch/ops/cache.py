"""A cache for the constant tensors that the spectral core and the kernel
wrappers build on a device."""

from __future__ import annotations

import functools

import torch


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes constant tensors on a
    device, each built outside inference mode: a constant first built under
    ``torch.inference_mode()`` (the Vocoder's) would be an inference tensor,
    and every later autograd use of it (a loss through the STFT path) would
    fail."""

    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def cached(*args, **kwargs):
            with torch.inference_mode(False):
                return fn(*args, **kwargs)

        return cached

    return wrap
