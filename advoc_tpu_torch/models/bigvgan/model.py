"""BigVGAN's generator in PyTorch (Lee et al., BigVGAN: A Universal Neural
Vocoder with Large-Scale Training, arXiv:2206.04658; NVIDIA's
``github.com/NVIDIA/BigVGAN`` ``bigvgan.py``): log-mel (B, num_mels, T) →
waveform (B, T·hop) in [−1, 1], hop = Π upsample_rates (256 at the
published 22 kHz / 80-band configuration).

``conv_pre`` (k7), then a level per upsample rate u: a transposed
convolution to half the channels (kernel k, the published padding
(k − u)/2: :func:`~advoc_tpu_torch.models.layers.conv_transpose_same`),
then the multi-receptive-field fusion (MRF), the mean of one
:class:`AMPBlock1` per resblock kernel size; ``activation_post``,
``conv_post`` (k7, one channel) and tanh. Each activation is an
anti-aliased SnakeBeta
(:func:`~advoc_tpu_torch.models.layers.aa_snake_beta`); its 12-tap
Kaiser-sinc FIR, rewritten as the up- and down-sampling's filters on the
two phases (:func:`~advoc_tpu_torch.models.layers.aa_filters`), is two
float32 buffers made at init and kept out of the state dict.

Parameters are float32; every convolution runs in ``cfg.dtype`` (bfloat16
by default, float32 accumulation) but ``conv_post`` and the tanh, which run
in float32; the Snake arithmetic is float32 and its result is stored in the
layer's dtype. Weight norm is folded into the weights: ``weight`` is what
NVIDIA's ``remove_weight_norm`` leaves. Module names are NVIDIA's
(``conv_pre``, ``ups.<i>``, ``resblocks.<j>.convs1.<n>``,
``resblocks.<j>.activations.<m>.act.alpha``, ``activation_post``,
``conv_post``), but a level's transposed convolution is ``ups.<i>`` where
NVIDIA nests it as ``ups.<i>.0``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from advoc_tpu_torch.models.layers import (
    DTYPES,
    aa_filters,
    aa_snake_beta,
    conv_same,
    conv_transpose_same,
    kaiser_sinc_filter,
)
from advoc_tpu_torch.utils import profiling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """NVIDIA's ``configs/bigvgan_22khz_80band.json`` (generator keys)."""

    num_mels: int = 80
    upsample_initial_channel: int = 1536
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        # JSON gives lists: keep the fields hashable tuples.
        for name in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        object.__setattr__(self, "resblock_dilation_sizes",
                           tuple(tuple(d) for d in self.resblock_dilation_sizes))
        if (self.activation, self.snake_logscale) != ("snakebeta", True):
            raise ValueError("BigVGANGenerator runs SnakeBeta on the log scale only, got "
                             f"activation={self.activation!r}, "
                             f"snake_logscale={self.snake_logscale}")
        if len(self.upsample_rates) != len(self.upsample_kernel_sizes) or \
                len(self.resblock_kernel_sizes) != len(self.resblock_dilation_sizes):
            raise ValueError("BigVGANConfig: one kernel size a rate, one dilation set a kernel")

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class SnakeBeta(nn.Module):
    """SnakeBeta's per-channel α and β on the log scale (NVIDIA initialises
    both at 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """The anti-aliased activation: SnakeBeta between ×2 resampling
    (:func:`~advoc_tpu_torch.models.layers.aa_snake_beta`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x: Tensor, filters: tuple[Tensor, Tensor]) -> Tensor:
        return aa_snake_beta(x, self.act.alpha, self.act.beta, *filters)


class AMPBlock1(nn.Module):
    """One AMPBlock1 of C channels and kernel k: for each dilation d,
    x ← x + conv2(act(conv1_d(act(x)))), conv1_d a same-length convolution
    of dilation d, conv2 of dilation 1."""

    def __init__(self, channels: int, kernel: int, dilations: tuple):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel, dilation=d)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel) for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(channels)
                                         for _ in range(2 * len(dilations)))

    def forward(self, x: Tensor, filters: tuple[Tensor, Tensor], dtype: torch.dtype) -> Tensor:
        acts = self.activations
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts[::2], acts[1::2]):
            xt = conv_same(a1(x, filters), c1, dtype)
            x = x + conv_same(a2(xt, filters), c2, dtype)
        return x


# The levels' range names, made once: a span that is off costs one check.
_UP_SPANS = tuple(f"up{i}" for i in range(32))


class BigVGANGenerator(nn.Module):
    """log-mel (B, num_mels, T) → waveform (B, T·hop) float32 in [−1, 1]."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(c0 // 2**i, c0 // 2 ** (i + 1), k, stride=u)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            AMPBlock1(c0 // 2 ** (i + 1), k, d) for i in range(len(self.ups))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        c_last = c0 // 2 ** len(self.ups)
        self.activation_post = Activation1d(c_last)
        self.conv_post = nn.Conv1d(c_last, 1, 7)
        up, down = aa_filters(kaiser_sinc_filter().tolist())
        self.register_buffer("aa_up", up, persistent=False)
        self.register_buffer("aa_down", down, persistent=False)

    def forward(self, mel: Tensor) -> Tensor:
        """Under a profiler the call is the range ``advoc.bigvgan``:
        ``advoc.pre`` (``conv_pre``), one ``advoc.up<i>`` a level (its
        transposed convolution's ``advoc.conv`` and ``advoc.mrf``, which
        holds each activation's ``advoc.aa_act`` and each convolution's
        ``advoc.conv``), and ``advoc.post`` (``activation_post``,
        ``conv_post``, tanh)."""
        dt, n_k = self.cfg.compute_dtype, len(self.cfg.resblock_kernel_sizes)
        filters = (self.aa_up, self.aa_down)
        with profiling.span("bigvgan"):
            with profiling.span("pre"):
                x = conv_same(mel, self.conv_pre, dt)
            for i, up in enumerate(self.ups):
                with profiling.span(_UP_SPANS[i]):
                    x = conv_transpose_same(x, up, dt)
                    with profiling.span("mrf"):
                        blocks = self.resblocks[i * n_k : (i + 1) * n_k]
                        xs = blocks[0](x, filters, dt)
                        for block in blocks[1:]:
                            xs = xs + block(x, filters, dt)
                        x = xs / n_k
            with profiling.span("post"):
                x = self.activation_post(x, filters)
                x = conv_same(x.to(torch.float32), self.conv_post, torch.float32)
                return torch.tanh(x[:, 0])
