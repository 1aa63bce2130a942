"""Layers the port's model families share: flax's semantics in PyTorch.

* :class:`GroupNorm`: flax ``GroupNorm`` (eps 1e-6, f32 statistics with
  var = E[x²] − E[x]², output in a chosen dtype); :func:`group_norm_act`:
  a GroupNorm with its activation, on the card without autograd the fused
  kernel (:mod:`advoc_tpu_torch.ops.kernels.group_norm`).
* :func:`flax_init`: flax's default initializers (lecun_normal kernels,
  zero biases, GroupNorm scale 1 and bias 0).
* :func:`conv_same`: flax ``Conv(padding="SAME", dtype=...)``, 1-D or 2-D,
  on channels-first activations; :func:`conv_transpose_same`: flax
  ``ConvTranspose(padding="SAME")`` (``transpose_kernel=False``), whose
  kernel the converters store flipped.
* :func:`dense`: flax ``Dense(dtype=...)``.
* :func:`phase_shuffle`: WaveGAN's shift of each example along time with
  reflect padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.ops.kernels.group_norm import (
    activate,
    group_norm_act_kernel,
    group_norm_apply_plain,
    group_norm_stats_plain,
)
from advoc_tpu_torch.utils import profiling

Tensor = torch.Tensor

# The configs' ``dtype`` names.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


class GroupNorm(nn.Module):
    """flax ``GroupNorm``: eps 1e-6, f32 statistics (fast variance, clamped
    at 0), output cast to ``dtype``. Parameters ``weight``/``bias`` (f32)."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        return group_norm_apply_plain(x, *group_norm_stats_plain(x, self.groups), self.weight,
                                      self.bias, None, self.dtype)


def group_norm_act(x: Tensor, norm: GroupNorm, act: str) -> Tensor:
    """``act`` (``"leaky_relu"`` at slope 0.2, or ``"relu"``) of ``norm(x)``.

    A CUDA ``x`` that autograd would not record (grad off, or none of x,
    weight, bias requiring it: the Vocoder, streaming, export, a train
    step's frozen generator) goes to the fused kernel,
    :func:`~advoc_tpu_torch.ops.kernels.group_norm.group_norm_act_kernel`
    (the registered operator while traced), which raises on what it does
    not take; so does a norm whose output dtype is not x's. A CPU tensor,
    and a CUDA one under autograd (the kernel has no backward, so a
    training step's generator update), run ``norm`` and the activation.
    """
    params = (norm.weight, norm.bias)
    if x.is_cuda and not (torch.is_grad_enabled()
                          and any(t.requires_grad for t in (x, *params))):
        if x.dtype != norm.dtype:
            raise ValueError(f"group_norm_act: the kernel writes x's dtype {x.dtype}, the norm "
                             f"{norm.dtype}")
        return group_norm_act_kernel(x, *params, norm.groups, act)
    return activate(norm(x), act)


def flax_init(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers on every layer of ``module``: lecun_normal kernels
    (truncated normal at ±2σ, σ = 1/√fan_in / 0.8796), zero biases,
    GroupNorm scale 1, bias 0. fan_in is k·cin for convolutions, the
    transposed ones too, as in flax, and in_features for ``Linear``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _CONVS + (nn.Linear,)):
                fan_in = (m.in_features if isinstance(m, nn.Linear)
                          else m.in_channels * math.prod(m.kernel_size))
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                # Drawn on the generator's device and copied: the same weights
                # wherever the module lives.
                w = torch.empty(m.weight.shape, device=generator.device)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax ``padding="SAME"`` on an axis of ``n``: out = ⌈n / s⌉, the total
    padding split with the extra pixel after (k4/s2 on an even n: (1, 1);
    k4/s1: (1, 2); k5/s2 on 64 or 80: (1, 2); k24/s4 on 4m: (10, 10))."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(fn, x: Tensor, layer: nn.Module, dtype: torch.dtype, **kw) -> Tensor:
    """``fn`` (a functional convolution) of ``x`` with ``layer``'s kernel and
    bias, all cast to ``dtype``. On the CPU a reduced ``dtype`` runs as
    float32 on the rounded operands, rounded once (a bf16 convolution that
    accumulates in float32, as cuDNN's does): torch 2.13's oneDNN bf16
    convolutions on the CPU return wrong values at some shapes (k24/s4 with
    4 or 8 input channels, k4/s4 with 16; measured). Under a profiler the
    casts and the convolution are the range ``advoc.conv``
    (:func:`~advoc_tpu_torch.utils.profiling.span`)."""
    args = (x, layer.weight, layer.bias)
    with profiling.span("conv"):
        if x.device.type == "cpu" and dtype != torch.float32:
            return fn(*(a.to(dtype).to(torch.float32) for a in args), **kw).to(dtype)
        return fn(*(a.to(dtype) for a in args), **kw)


def conv_same(x: Tensor, conv: nn.Conv1d | nn.Conv2d, dtype: torch.dtype) -> Tensor:
    """flax ``Conv(padding="SAME", dtype=...)`` of a channels-first ``x``
    (B, C, T) or (B, C, H, W): input, kernel and bias cast to ``dtype``,
    padded inside the convolution where the padding is symmetric, else by
    ``F.pad`` first."""
    pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], conv.kernel_size, conv.stride)]
    padding = [lo for lo, _ in pads]
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = [0] * len(pads)
    return _conv(F.conv1d if x.ndim == 3 else F.conv2d, x, conv, dtype, stride=conv.stride,
                 padding=padding)


def transpose_crop(k: int, s: int) -> tuple[int, int]:
    """How much of ``conv_transpose``'s full output (length (n−1)·s + k) to
    cut from each end to give flax's ``ConvTranspose(padding="SAME")``
    (length n·s): flax correlates the stride-dilated input, padded by
    lax's (pad_a, pad_b), so the crop is (k − 1 − pad_a, k − 1 − pad_b). A
    negative end means zeros appended (only where s > k). (10, 10) at
    k24/s4, (10, 11) at k25/s4, (1, 2) at k5/s2."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return k - 1 - pad_a, k - 1 - (pad_len - pad_a)


def conv_transpose_same(x: Tensor, conv: nn.ConvTranspose1d | nn.ConvTranspose2d,
                        dtype: torch.dtype) -> Tensor:
    """flax ``ConvTranspose(padding="SAME", dtype=...)`` of a channels-first
    ``x``, the converter having flipped flax's kernel spatially (flax does
    not transpose it): output n·s per axis, :func:`transpose_crop` taken
    inside the transposed convolution where it is symmetric and sliced off
    otherwise."""
    crops = [transpose_crop(k, s) for k, s in zip(conv.kernel_size, conv.stride)]
    padding = [min(lo, max(hi, 0)) for lo, hi in crops]
    extra = [max(-hi, 0) for _, hi in crops]
    y = _conv(F.conv_transpose1d if x.ndim == 3 else F.conv_transpose2d, x, conv, dtype,
              stride=conv.stride, padding=padding, output_padding=extra)
    for axis, ((lo, hi), p) in enumerate(zip(crops, padding), start=2):
        cut_lo, cut_hi = lo - p, max(hi, 0) - p
        if cut_lo or cut_hi:
            y = y.narrow(axis, cut_lo, y.shape[axis] - cut_lo - cut_hi)
    return y


def dense(x: Tensor, layer: nn.Linear, dtype: torch.dtype) -> Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to ``dtype``
    (on the CPU as the convolutions)."""
    return _conv(F.linear, x, layer, dtype)


def phase_shuffle(x: Tensor, shift: Tensor, rad: int) -> Tensor:
    """Shift each example of a (B, C, T) ``x`` by ``shift`` (B,) integers in
    [−rad, rad] along time, reflect-padded (the edge sample not repeated):
    out[b, :, t] = x[b, :, reflect(t + shift[b])], the JAX package's pad by
    rad and dynamic slice at rad + shift. One gather, so it is exact and
    differentiable twice (the wgan-gp penalty backpropagates through its
    gradient)."""
    if rad == 0:
        return x
    t = x.shape[-1]
    if t <= rad:
        raise ValueError(f"phase_shuffle needs more than rad={rad} steps, got {t}")
    j = torch.arange(t, device=x.device) + shift.to(x.device, torch.int64)[:, None]
    j = torch.where(j < 0, -j, torch.where(j > t - 1, 2 * (t - 1) - j, j))
    return torch.gather(x, -1, j[:, None, :].expand(x.shape[0], x.shape[1], t))
