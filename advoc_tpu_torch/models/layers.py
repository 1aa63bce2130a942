"""Layers the port's model families share: flax's semantics in PyTorch.

* :class:`GroupNorm`: flax ``GroupNorm`` (eps 1e-6, f32 statistics with
  var = E[x²] − E[x]², output in a chosen dtype); :func:`group_norm_act`:
  a GroupNorm with its activation, on the card without autograd the fused
  kernel (:mod:`advoc_tpu_torch.ops.kernels.group_norm`) where
  :func:`norm_kernel_takes` the level, which can take the preceding
  convolution's bias.
* :func:`flax_init`: flax's default initializers (lecun_normal kernels,
  zero biases, GroupNorm scale 1 and bias 0).
* :func:`conv_same`: flax ``Conv(padding="SAME", dtype=...)``, 1-D or 2-D,
  on channels-first activations; :func:`conv_transpose_same`: flax
  ``ConvTranspose(padding="SAME")`` (``transpose_kernel=False``), whose
  kernel the converters store flipped; :func:`conv_transpose_act`: a 1-D
  one with its activation, on the card without autograd the convolution
  without its bias and the epilogue kernel
  (:mod:`advoc_tpu_torch.ops.kernels.conv_bias_act`).
* :func:`dense`: flax ``Dense(dtype=...)``.
* :func:`phase_shuffle`: WaveGAN's shift of each example along time with
  reflect padding.
* :func:`kaiser_sinc_filter`, :func:`aa_filters`, :func:`aa_snake_beta`:
  BigVGAN's anti-aliased SnakeBeta (×2 up-sampling, SnakeBeta, low-pass and
  ×2 down-sampling), computed on the two phases of the up-sampled signal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels.conv_bias_act import conv_bias_act_kernel
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


def norm_kernel_takes(x: Tensor, *modules: nn.Module) -> bool:
    """Whether the GroupNorm kernel pair takes a level that computes from
    ``x`` through ``modules`` (its norm, and its convolution where that
    matters): a CUDA ``x`` that autograd would not record (grad off, or none
    of x and the modules' parameters requiring it: the Vocoder, streaming,
    export, a train step's frozen generator). A CPU tensor, and a CUDA one
    under autograd (the kernel has no backward, so a training step's
    generator update), run the plain ops."""
    return x.is_cuda and not _build.records((x, *(p for m in modules for p in m.parameters())))


def group_norm_act(x: Tensor, norm: GroupNorm, act: str,
                   conv_bias: Tensor | None = None) -> Tensor:
    """``act`` (``"leaky_relu"`` at slope 0.2, or ``"relu"``) of ``norm(x)``.

    Where :func:`norm_kernel_takes` ``x`` and ``norm``, the fused kernel,
    :func:`~advoc_tpu_torch.ops.kernels.group_norm.group_norm_act_kernel`
    (the registered operator while traced), which raises on what it does
    not take; so does a norm whose output dtype is not x's. Else ``norm``
    and the activation. A ``conv_bias`` (C,) is a level's convolution bias,
    handed over where the level found that the kernel takes it (over its
    convolution too) and ran the convolution without it: the kernel adds it
    to x in x's dtype first.
    """
    if conv_bias is None and not norm_kernel_takes(x, norm):
        return activate(norm(x), act)
    if x.dtype != norm.dtype:
        raise ValueError(f"group_norm_act: the kernel writes x's dtype {x.dtype}, the norm "
                         f"{norm.dtype}")
    return group_norm_act_kernel(x, norm.weight, norm.bias, norm.groups, act, conv_bias)


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


def _conv(fn, x: Tensor, layer: nn.Module, dtype: torch.dtype, bias: bool = True,
          **kw) -> Tensor:
    """``fn`` (a functional convolution) of ``x`` with ``layer``'s kernel and
    bias (none where ``bias`` is False), all cast to ``dtype``. On the CPU a
    reduced ``dtype`` runs as float32 on the rounded operands, rounded once
    (a bf16 convolution that accumulates in float32, as cuDNN's does): torch
    2.13's oneDNN bf16
    convolutions on the CPU return wrong values at some shapes (k24/s4 with
    4 or 8 input channels, k4/s4 with 16; measured). Under a profiler the
    casts and the convolution are the range ``advoc.conv``
    (:func:`~advoc_tpu_torch.utils.profiling.span`)."""
    args = (x, layer.weight, layer.bias) if bias else (x, layer.weight)
    with profiling.span("conv"):
        if x.device.type == "cpu" and dtype != torch.float32:
            return fn(*(a.to(dtype).to(torch.float32) for a in args), **kw).to(dtype)
        return fn(*(a.to(dtype) for a in args), **kw)


def conv_same(x: Tensor, conv: nn.Conv1d | nn.Conv2d, dtype: torch.dtype,
              bias: bool = True) -> Tensor:
    """flax ``Conv(padding="SAME", dtype=...)`` of a channels-first ``x``
    (B, C, T) or (B, C, H, W): input, kernel and bias (none where ``bias`` is
    False) cast to ``dtype``, padded inside the convolution where the
    padding is symmetric, else by ``F.pad`` first. A dilated ``conv`` pads
    for its dilated extent, d·(k − 1) + 1 taps: an odd k at stride 1 keeps
    the length with d·(k − 1)/2 at each end, PyTorch's ``padding="same"``."""
    pads = [same_pads(n, d * (k - 1) + 1, s) for n, k, s, d
            in zip(x.shape[2:], conv.kernel_size, conv.stride, conv.dilation)]
    padding = [lo for lo, _ in pads]
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = [0] * len(pads)
    return _conv(F.conv1d if x.ndim == 3 else F.conv2d, x, conv, dtype, bias, stride=conv.stride,
                 padding=padding, dilation=conv.dilation)


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


def transpose_geometry(kernel_size, stride):
    """:func:`conv_transpose_same`'s padding inside the transposed
    convolution and its output padding, per axis of ``kernel_size`` and
    ``stride``, and the (cut_lo, cut_hi) left to slice off each axis after
    it: :func:`transpose_crop` taken inside where it is symmetric ((0, 1) at
    k25/s4, (0, 0) at k24/s4)."""
    crops = [transpose_crop(k, s) for k, s in zip(kernel_size, stride)]
    padding = [min(lo, max(hi, 0)) for lo, hi in crops]
    extra = [max(-hi, 0) for _, hi in crops]
    cuts = [(lo - p, max(hi, 0) - p) for (lo, hi), p in zip(crops, padding)]
    return padding, extra, cuts


def conv_transpose_same(x: Tensor, conv: nn.ConvTranspose1d | nn.ConvTranspose2d,
                        dtype: torch.dtype, bias: bool = True) -> Tensor:
    """flax ``ConvTranspose(padding="SAME", dtype=...)`` of a channels-first
    ``x``, the converter having flipped flax's kernel spatially (flax does
    not transpose it): output n·s per axis, :func:`transpose_crop` taken
    inside the transposed convolution where it is symmetric and sliced off
    otherwise; no bias where ``bias`` is False."""
    padding, extra, cuts = transpose_geometry(conv.kernel_size, conv.stride)
    y = _conv(F.conv_transpose1d if x.ndim == 3 else F.conv_transpose2d, x, conv, dtype, bias,
              stride=conv.stride, padding=padding, output_padding=extra)
    for axis, (cut_lo, cut_hi) in enumerate(cuts, start=2):
        if cut_lo or cut_hi:
            y = y.narrow(axis, cut_lo, y.shape[axis] - cut_lo - cut_hi)
    return y


def conv_transpose_act(x: Tensor, conv: nn.ConvTranspose1d, dtype: torch.dtype, act: str,
                       out_dtype: torch.dtype) -> Tensor:
    """``act`` (``"relu"``, or ``"leaky_relu"`` at slope 0.2) of
    :func:`conv_transpose_same` of a (B, C, T) ``x`` in ``dtype``, cast to
    ``out_dtype`` (``dtype`` or float32).

    A CUDA ``x`` that autograd would not record (grad off, or none of x,
    the kernel and the bias requiring it: the WaveGAN generators' inference,
    a train step's no_grad fakes) runs the same transposed convolution
    without its bias, then the epilogue kernel
    :func:`~advoc_tpu_torch.ops.kernels.conv_bias_act.conv_bias_act_kernel`,
    which adds the bias cast to ``dtype``, crops and activates in one pass,
    bit-equal to the ops below. A CPU tensor, and a CUDA one under autograd
    (the kernel has no backward), run :func:`conv_transpose_same`, the
    activation and the cast."""
    if x.is_cuda and not _build.records((x, conv.weight, conv.bias)):
        padding, extra, ((cut_lo, cut_hi),) = transpose_geometry(conv.kernel_size, conv.stride)
        y = _conv(F.conv_transpose1d, x, conv, dtype, bias=False, stride=conv.stride,
                  padding=padding, output_padding=extra)
        return conv_bias_act_kernel(y, conv.bias.to(dtype), cut_lo, cut_hi, act, out_dtype)
    return activate(conv_transpose_same(x, conv, dtype), act).to(out_dtype)


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


# BigVGAN's resampling filter: 12 taps, cutoff and half-width of the ×2 ratio.
AA_TAPS, AA_CUTOFF, AA_HALF_WIDTH = 12, 0.25, 0.3


def kaiser_sinc_filter(cutoff: float = AA_CUTOFF, half_width: float = AA_HALF_WIDTH,
                       taps: int = AA_TAPS) -> Tensor:
    """BigVGAN's low-pass FIR (``alias_free_activation/torch/filter.py``
    ``kaiser_sinc_filter1d``), (taps,) float32 on the CPU: a sinc
    of cutoff ``cutoff`` (of the sample rate) under a Kaiser window whose β
    follows Kaiser's rule for the attenuation A = 2.285·(taps/2 − 1)·π·4·
    half_width + 7.95 dB (β ≈ 4.66 at the defaults), at half-sample times for
    an even ``taps``, normalised to sum 1. Computed in float64 and rounded."""
    half = taps // 2
    att = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if att > 50.0:
        beta = 0.1102 * (att - 8.7)
    elif att >= 21.0:
        beta = 0.5842 * (att - 21.0) ** 0.4 + 0.07886 * (att - 21.0)
    else:
        beta = 0.0
    f64 = {"dtype": torch.float64, "device": "cpu"}
    window = torch.kaiser_window(taps, periodic=False, beta=beta, **f64)
    t = torch.arange(-half, half, **f64) + 0.5 if taps % 2 == 0 else \
        torch.arange(taps, **f64) - half
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (h / h.sum()).to(torch.float32)


def aa_filters(taps: list[float]) -> tuple[Tensor, Tensor]:
    """BigVGAN's ×2 resampling around an activation (``UpSample1d``,
    ``DownSample1d`` of ``alias_free_activation/torch/resample.py``) with the
    FIR ``taps`` (an even count, float32 values), rewritten on the two
    phases of the up-sampled signal: (up, down), each (2, 2R + 1) float32
    on the default device, R the widest offset.

    ``UpSample1d`` replicate-pads x by taps/2 − 1, runs a stride-2
    transposed convolution, times 2, and keeps the middle 2T samples (15
    cut off each end at 12 taps): sample 2m + p of the result is
    Σ up[p, R + d] · x[clamp(m + d)], the replicate pad being the clamp.
    ``DownSample1d``
    replicate-pads the 2T samples s by (taps/2 − 1, taps/2) and runs a
    stride-2 convolution: z[n] = Σ_d down[0, R + d] · E[n + d] + down[1, R +
    d] · O[n + d] over the phases E[m] = s[2m], O[m] = s[2m + 1], each
    extended past its ends by s[0] = E[0] before and s[2T − 1] = O[T − 1]
    after. Each weight is a tap, or twice one for the up-sampling (exact)."""
    k = len(taps)
    if k % 2:
        raise ValueError(f"aa_filters: an even tap count, got {k}")
    pad = k // 2 - 1
    lo = 2 * pad + (k - 2) // 2  # UpSample1d's cut before the signal
    up = [[((p + lo - i) // 2 - pad, 2.0 * taps[i]) for i in range(k) if (p + lo - i) % 2 == 0]
          for p in (0, 1)]
    down = [[((i - pad) // 2, taps[i]) for i in range(k) if (i - pad) % 2 == p] for p in (0, 1)]
    r = max(abs(d) for phase in up + down for d, _ in phase)
    out = []
    for phases in (up, down):
        w = [[0.0] * (2 * r + 1) for _ in range(2)]
        for p, phase in enumerate(phases):
            for d, v in phase:
                w[p][r + d] = v
        out.append(torch.tensor(w, dtype=torch.float32))
    return out[0], out[1]


def aa_snake_beta(x: Tensor, log_alpha: Tensor, log_beta: Tensor, up: Tensor,
                  down: Tensor) -> Tensor:
    """BigVGAN's ``Activation1d(SnakeBeta(alpha_logscale=True))`` of a
    (B, C, T) ``x``, returned (B, C, T) in x's dtype; the arithmetic in
    float32. ``up``, ``down``: :func:`aa_filters` of the FIR.

    The ×2 up-sampling, SnakeBeta y + sin²(e^α·y) / (e^β + 1e-9) per channel
    (α, β (C,) on the log scale), and the low-pass ×2 down-sampling, all on
    the two phases of the up-sampled signal: one depthwise convolution makes
    both phases of each channel from x replicate-padded, the Snake writes
    into a buffer padded for the down-sampling, whose ends take the
    interleaved signal's first and last samples, and one grouped
    convolution sums both phases back to T samples. Under a profiler the
    block is the range ``advoc.aa_act``."""
    with profiling.span("aa_act"):
        b, c, t = x.shape
        r = (up.shape[-1] - 1) // 2
        y = F.conv1d(F.pad(x.to(torch.float32), (r, r), mode="replicate"),
                     up.to(torch.float32).repeat(c, 1)[:, None], groups=c)  # (B, 2C, T)
        a = log_alpha.to(torch.float32).exp().repeat_interleave(2)[:, None]
        inv_b = (1.0 / (log_beta.to(torch.float32).exp() + 1e-9)).repeat_interleave(2)[:, None]
        s = y * a
        s.sin_().square_()
        buf = y.new_empty(b, 2 * c, t + 2 * r)
        torch.addcmul(y, s, inv_b, out=buf[..., r : r + t])
        phases = buf.view(b, c, 2, t + 2 * r)
        phases[..., :r] = phases[:, :, :1, r : r + 1]  # s[0] = E[0]
        phases[..., r + t :] = phases[:, :, 1:, r + t - 1 : r + t]  # s[2T − 1] = O[T − 1]
        z = F.conv1d(buf, down.to(torch.float32).repeat(c, 1, 1), groups=c)
        return z.to(x.dtype)
