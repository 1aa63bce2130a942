"""GroupNorm + activation of the U-Net's levels: a CUDA kernel and its plain version.

Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA. In the
port each normalised level of the generator (:class:`~advoc_tpu_torch.models.
advoc.model._Down` at depth > 0, every ``_Up``) ran flax's GroupNorm as ~17
eager PyTorch ops (an f32 copy, the statistics, two ``repeat_interleave``,
the affine, the cast, then the activation) over a channels-last activation,
so the ``reshape`` copied it and every broadcast ran PyTorch's strided
elementwise kernel: ≈ 15 passes over the tensor.

Design on Hopper (``csrc/group_norm.cu``): two launches a level, in the
generator's compute dtype (bf16, f16 or f32). A statistics pass reads the
activation in the layout the convolution returned (channels-last, or
contiguous NCHW for the pixelshuffle and subpixel decoder modes) with
16-byte loads and writes per-(unit, tile, group) Σx and Σx² (f32, reduced
in a fixed order: no float atomics, the same result on every run); a
normalise-activate pass sums a unit's partials, computes flax's fast
variance clamped at 0 and inv = rsqrt(var + 1e-6), and writes
act(T((x − mean)·(inv·w) + b)) in x's dtype T and layout, with the plain
path's own rounding, op by op. The tiles per unit come from the shape
(:func:`tiles`), never from a setting.

Bound (:func:`~advoc_tpu_torch.utils.roofline.group_norm_bytes`): the floor
reads each element once and writes it once, 4 bytes in bf16. At the
full-width U-Net on 128 windows of 256 frames the 11 levels hold 1.150 G
elements: 4.60 GB, 1.37 ms at 3.35 TB/s; the finest level alone 0.64 ms.
Two passes read a level larger than L2 twice (6 bytes, 2.06 ms over the 11
levels); a level of at most 50 MB is read the second time from L2.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from advoc_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

ACTS = ("leaky_relu", "relu")  # LeakyReLU at the U-Net's slope 0.2; ReLU
DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # the kernel's codes 0, 1, 2
MAX_CHANNELS = 2048
_MIN_TILE = 2048  # 16-byte vectors a CTA streams at least (32 KB), unless its unit is smaller
_CTAS_PER_SM = 16  # a pass's target: CTAs enough to fill every SM many times over


def activate(y: Tensor, act: str) -> Tensor:
    """``act`` of ``y`` in y's dtype: LeakyReLU at slope 0.2, or ReLU."""
    return F.leaky_relu(y, 0.2) if act == "leaky_relu" else F.relu(y)


def group_norm_stats_plain(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    """flax GroupNorm's statistics of ``x`` (B, C, ...): per (sample, group)
    the f32 mean and inv = rsqrt(max(E[x²] − E[x]², 0) + 1e-6), (B, G) each."""
    b = x.shape[0]
    g = x.to(torch.float32).reshape(b, groups, -1)
    mean = g.mean(-1)
    var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + 1e-6)


def group_norm_apply_plain(x: Tensor, mean: Tensor, inv: Tensor, weight: Tensor, bias: Tensor,
                           act: str | None, dtype: torch.dtype | None = None) -> Tensor:
    """act((x − mean)·(inv·w) + b) in f32, cast to ``dtype`` (x's by
    default), given the statistics (B, G); no activation where ``act`` is
    None. The port's ``GroupNorm`` and the second half of
    :func:`group_norm_act_plain`."""
    b, c = x.shape[:2]
    shape = (b, c) + (1,) * (x.ndim - 2)
    rep = c // mean.shape[1]
    mean = mean.repeat_interleave(rep, 1).reshape(shape)
    inv = inv.repeat_interleave(rep, 1).reshape(shape)
    w = weight.reshape((1,) + shape[1:])
    y = ((x.to(torch.float32) - mean) * (inv * w) + bias.reshape(w.shape)).to(dtype or x.dtype)
    return y if act is None else activate(y, act)


def group_norm_act_plain(x: Tensor, weight: Tensor, bias: Tensor, groups: int,
                         act: str) -> Tensor:
    """The kernel's function in plain PyTorch: the port's ``GroupNorm``
    (:class:`~advoc_tpu_torch.models.layers.GroupNorm`, output in x's dtype)
    followed by ``act``. The CPU path of :func:`group_norm_act_kernel` and
    the reference the kernel is held to."""
    mean, inv = group_norm_stats_plain(x, groups)
    return group_norm_apply_plain(x, mean, inv, weight, bias, act)


def _check(x: Tensor, weight: Tensor, bias: Tensor, groups: int, act: str) -> bool:
    """Raise on what the kernel does not take; True where ``x`` is
    channels-last in memory, False where it is contiguous NCHW."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight and bias must be ({c},), got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"group_norm_act_kernel needs a bfloat16, float16 or float32 x, got "
                         f"{x.dtype}")
    if c % 8 or groups < 1 or c % groups or c > MAX_CHANNELS:
        raise ValueError(f"group_norm_act_kernel needs C % 8 == 0, C % groups == 0 and "
                         f"C <= {MAX_CHANNELS} (C {c}, groups {groups})")
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if not x.is_contiguous():
        raise ValueError(f"group_norm_act_kernel needs x channels-last or contiguous NCHW, "
                         f"got strides {x.stride()}")
    if (c // groups) * h * w % 8:
        raise ValueError(f"group_norm_act_kernel needs (C / groups)·H·W % 8 == 0 in NCHW "
                         f"(C {c}, groups {groups}, H {h}, W {w})")
    return False


def tiles(units: int, unit_vectors: int, sms: int) -> int:
    """Tiles a unit (a sample, or a (sample, group) in NCHW) is cut into:
    CTAs enough for ``_CTAS_PER_SM`` on each of ``sms``, none streaming
    fewer than ``_MIN_TILE`` 16-byte vectors unless its unit has fewer."""
    return max(1, min(-(-unit_vectors // _MIN_TILE), -(-_CTAS_PER_SM * sms // max(units, 1))))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.group_norm_act.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.group_norm_act.restype = i
    return lib


def group_norm_act_kernel(x: Tensor, weight: Tensor, bias: Tensor, groups: int,
                          act: str) -> Tensor:
    """act(GroupNorm(x)) of a (B, C, H, W) ``x`` in bf16, f16 or f32,
    channels-last or contiguous NCHW, in x's dtype and layout; ``weight``
    and ``bias`` (C,).

    On a CUDA tensor: the CUDA kernel's two launches on x's device and its
    current stream, counted in ``group_norm_act_kernel.launches``; it raises
    on a tensor the kernel does not take (C % 8, C % groups, C above 2048,
    another dtype or layout) or a failed launch. On a CPU tensor:
    :func:`group_norm_act_plain`. Traced
    (:func:`~advoc_tpu_torch.ops.kernels._build.traced`), it is the
    registered operator ``advoc::group_norm_act``, or the plain version's
    aten ops inside :func:`plain_when_traced`. No backward: under autograd
    it raises on the card, where the plain version is the path.
    """
    traced = _build.traced()
    if x.is_cuda and not traced:
        _build.refuse_grad([x, weight, bias], "group_norm_act_kernel",
                           "group_norm_act_plain (models.layers.group_norm_act takes it)")
        return _launch(x, weight, bias, groups, act)[0]
    _check(x, weight, bias, groups, act)
    if traced and not _plain_traced:
        from advoc_tpu_torch.ops.kernels import registered

        return registered.group_norm_act_op(x, weight.to(x.device), bias.to(x.device), groups,
                                            act)
    return group_norm_act_plain(x, weight, bias, groups, act)


_plain_traced = False


@contextlib.contextmanager
def plain_when_traced():
    """Inside: a traced :func:`group_norm_act_kernel` records the plain
    version's aten ops instead of ``advoc::group_norm_act``, so that a
    program traced on the card loads without the registered operators
    (:func:`~advoc_tpu_torch.infer.export.export_vocoder` without
    ``allow_custom_calls``). Eager calls still launch the kernel."""
    global _plain_traced
    before, _plain_traced = _plain_traced, True
    try:
        yield
    finally:
        _plain_traced = before


def _launch(x: Tensor, weight: Tensor, bias: Tensor, groups: int, act: str):
    """The kernel on a CUDA tensor (``advoc::group_norm_act``'s CUDA
    implementation, and the eager wrapper's): (y, scratch), the first
    2·B·G floats of scratch the f32 (mean, inv) of each (sample, group)
    that the normalise pass used.

    It runs once a U-Net level, on the host's critical path where the card
    outruns the host (small batches), so it spends no host time it need
    not: no device switch where x's card is current, the raw current
    stream, no view of the statistics."""
    nhwc = _check(x, weight, bias, groups, act)
    if x.data_ptr() % 16:
        raise ValueError("group_norm_act_kernel needs x 16-byte aligned")
    b, c, h, w = x.shape
    dev = x.device
    units, unit_vectors = (b, h * w * c // 8) if nhwc else (b * groups, (c // groups) * h * w // 8)
    nt = tiles(units, unit_vectors, _sms(dev.index))
    y = torch.empty_like(x)
    # One buffer: the (mean, inv) of each (sample, group), then the partials.
    n_stats = 2 * b * groups
    scratch = torch.empty(n_stats + 2 * units * nt * (groups if nhwc else 1),
                          dtype=torch.float32, device=dev)
    wf = weight.to(dev, torch.float32).contiguous()
    bf = bias.to(dev, torch.float32).contiguous()
    lib = _lib()
    # The launcher launches on the current device.
    on_dev = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev))
    with on_dev:
        code = lib.group_norm_act(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(),
            scratch.data_ptr() + 4 * n_stats, scratch.data_ptr(), b, c, h * w, groups,
            int(nhwc), ACTS.index(act), nt, DTYPES.index(x.dtype),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check(lib, code, "group_norm_act")
    group_norm_act_kernel.launches += 2
    return y, scratch


group_norm_act_kernel.launches = 0
