"""End-to-end waveform GAN (WaveGAN) in PyTorch: z → waveform, no phase
recovery.

The port of ``advoc_tpu.models.wavegan.model``. Activations are
channels-first, (B, C, T), where flax's are (B, T, C); the generator's
projection is reshaped as flax's (B, 16, c0) and permuted, and the
discriminator's last activation is permuted back to (B, T, C) before it is
flattened for the logit ``Dense``, so a converted flax tree computes the
same function (:mod:`advoc_tpu_torch.models.convert`). Every module bears
its flax name (``project``, ``upconv{i}``, ``conv{i}``, ``logit``).

As in flax, parameters are float32 and every layer runs in
``cfg.dtype`` (bfloat16 by default) but the last transposed convolution
and the logit ``Dense``, which run in float32. ``Conv(padding="SAME")``
and ``ConvTranspose(padding="SAME")`` are
:func:`~advoc_tpu_torch.models.layers.conv_same` and
:func:`~advoc_tpu_torch.models.layers.conv_transpose_same`.

Phase shuffle takes its shifts as an argument, (n_layers, B) integers in
[−rad, rad] for the discriminator's first n_up − 1 layers:
:meth:`WaveGANDiscriminator.draw_shifts` draws them from a
``torch.Generator`` (the JAX discriminator draws layer i's from
``fold_in(rng, i)``); None applies no shuffle, as JAX's ``rng=None``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.models.layers import (
    DTYPES,
    conv_same,
    conv_transpose_same,
    dense,
    flax_init,
    phase_shuffle,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WaveGANConfig:
    """The JAX package's fields and defaults."""

    slice_len: int = 16384
    sample_rate: int = 16000
    latent_dim: int = 100
    width: int = 64
    kernel: int = 24
    stride: int = 4
    phase_shuffle: int = 2
    dtype: str = "bfloat16"
    gan_type: str = "wgan-gp"
    n_critic: int = 5
    gp_weight: float = 10.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def n_up(self) -> int:
        """16 · stride^n_up == slice_len (16384 = 16 · 4^5)."""
        n, size = 0, 16
        while size < self.slice_len:
            size *= self.stride
            n += 1
        if size != self.slice_len:
            raise ValueError(f"slice_len {self.slice_len} must be 16 * stride^k")
        return n


def up_stack(cin: int, d: int, c0: int, n_up: int, k: int, s: int) -> list[nn.ConvTranspose1d]:
    """The generators' transposed convolutions: max(d, c0 / 2^(i+1))
    features at level i, one at the last."""
    layers = []
    for i in range(n_up):
        feats = 1 if i == n_up - 1 else max(d, c0 // 2 ** (i + 1))
        layers.append(nn.ConvTranspose1d(cin, feats, k, stride=s))
        cin = feats
    return layers


def run_up_stack(x: Tensor, layers, dtype: torch.dtype, act) -> Tensor:
    """The stack on (B, c0, T): ``act`` after each level in ``dtype``, the
    last level in float32 → tanh, (B, T·s^n)."""
    for i, up in enumerate(layers):
        last = i == len(layers) - 1
        x = conv_transpose_same(x.to(torch.float32) if last else x, up,
                                torch.float32 if last else dtype)
        if not last:
            x = act(x)
    return torch.tanh(x[:, 0])


def down_stack(cin: int, d: int, n: int, k: int, s: int) -> list[nn.Conv1d]:
    """The discriminators' strided convolutions: min(d·2^i, 16d) features."""
    layers = []
    for i in range(n):
        feats = min(d * 2**i, d * 16)
        layers.append(nn.Conv1d(cin, feats, k, stride=s))
        cin = feats
    return layers


def run_down_stack(x: Tensor, layers, dtype: torch.dtype, rad: int,
                   shifts: Tensor | None) -> Tensor:
    """Each conv → LeakyReLU(0.2) → phase shuffle by ``shifts[i]`` (not
    after the last, nor without ``shifts``)."""
    for i, conv in enumerate(layers):
        x = F.leaky_relu(conv_same(x, conv, dtype), 0.2)
        if shifts is not None and i < len(layers) - 1:
            x = phase_shuffle(x, shifts[i], rad)
    return x


def add_layers(module: nn.Module, prefix: str, layers) -> list:
    """Register ``layers`` on ``module`` as ``{prefix}{i}`` (flax's names)
    and return them."""
    for i, layer in enumerate(layers):
        module.add_module(f"{prefix}{i}", layer)
    return layers


class ShuffledDiscriminator(nn.Module):
    """A discriminator of strided convs ``self.convs`` with phase shuffle
    after all but the last."""

    cfg: WaveGANConfig
    convs: list

    @property
    def n_shuffled(self) -> int:
        """The layers phase shuffle follows."""
        return len(self.convs) - 1 if self.cfg.phase_shuffle > 0 else 0

    def draw_shifts(self, batch: int, generator: torch.Generator | None = None,
                    device=None) -> Tensor:
        """(n_shuffled, batch) shifts uniform in [−rad, rad] for
        :meth:`forward`, from ``generator`` on ``device``."""
        rad = self.cfg.phase_shuffle
        return torch.randint(-rad, rad + 1, (self.n_shuffled, batch), generator=generator,
                             device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)


class WaveGANGenerator(nn.Module):
    """z (B, latent_dim) → waveform (B, slice_len) in [-1, 1]."""

    def __init__(self, cfg: WaveGANConfig = WaveGANConfig()):
        super().__init__()
        self.cfg = cfg
        d, n_up = cfg.width, cfg.n_up
        self.c0 = d * 2**n_up // 2  # 1024 for the default config
        self.project = nn.Linear(cfg.latent_dim, 16 * self.c0)
        self.ups = add_layers(self, "upconv", up_stack(self.c0, d, self.c0, n_up, cfg.kernel,
                                                      cfg.stride))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, z: Tensor) -> Tensor:
        dt = self.cfg.compute_dtype
        x = dense(z, self.project, dt).reshape(z.shape[0], 16, self.c0).permute(0, 2, 1)
        return run_up_stack(F.relu(x), self.ups, dt, F.relu)


class WaveGANDiscriminator(ShuffledDiscriminator):
    """waveform (B, slice_len) → scalar logit (B,). Phase-shuffled convs."""

    def __init__(self, cfg: WaveGANConfig = WaveGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.convs = add_layers(self, "conv", down_stack(1, cfg.width, cfg.n_up, cfg.kernel,
                                                        cfg.stride))
        t = cfg.slice_len // cfg.stride**cfg.n_up
        self.logit = nn.Linear(t * self.convs[-1].out_channels, 1)

    def forward(self, wav: Tensor, shifts: Tensor | None = None) -> Tensor:
        cfg = self.cfg
        x = run_down_stack(wav[:, None], self.convs, cfg.compute_dtype, cfg.phase_shuffle,
                           shifts if cfg.phase_shuffle > 0 else None)
        x = x.permute(0, 2, 1).reshape(x.shape[0], -1)  # flax's (B, T, C) order
        return dense(x.to(torch.float32), self.logit, torch.float32)[:, 0]
