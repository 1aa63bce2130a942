"""Mel-conditioned waveform GAN in PyTorch: a neural mel → waveform
vocoder with no phase recovery.

The port of ``advoc_tpu.models.wavegan.conditional``, in the layout and
dtypes of :mod:`advoc_tpu_torch.models.wavegan.model`: a 7-tap frame-rate
trunk and ×4 transposed convolutions up to the sample rate (T frames →
T·hop samples, hop = stride^n_up), against a phase-shuffled strided-conv
discriminator that sees the waveform beside a conditioning channel (each
frame's mean mel energy, ·2 − 1, repeated hop times) and ends in a 3-tap
float32 patch-logit conv. Module names are flax's (``trunk``,
``upconv{i}``, ``conv{i}``, ``logit``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.models.layers import DTYPES, conv_same, flax_init
from advoc_tpu_torch.models.wavegan.model import (
    ShuffledDiscriminator,
    add_layers,
    down_stack,
    run_down_stack,
    run_up_stack,
    up_stack,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CondWaveGANConfig:
    """The JAX package's fields and defaults."""

    n_frames: int = 64
    n_mels: int = 80
    hop: int = 256
    width: int = 64
    kernel: int = 24
    stride: int = 4
    phase_shuffle: int = 2
    dtype: str = "bfloat16"
    gan_type: str = "lsgan"
    n_critic: int = 1
    gp_weight: float = 10.0
    mel_l1_weight: float = 45.0
    sample_rate: int = 22050

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def slice_len(self) -> int:
        return self.n_frames * self.hop

    @property
    def n_up(self) -> int:
        """stride^n_up == hop."""
        n, size = 0, 1
        while size < self.hop:
            size *= self.stride
            n += 1
        if size != self.hop:
            raise ValueError(f"hop {self.hop} must be a power of stride {self.stride}")
        return n


class CondWaveGANGenerator(nn.Module):
    """mel (B, T, n_mels) → waveform (B, T·hop) in [-1, 1]."""

    def __init__(self, cfg: CondWaveGANConfig = CondWaveGANConfig()):
        super().__init__()
        self.cfg = cfg
        d, n_up = cfg.width, cfg.n_up
        c0 = d * 2**n_up // 2  # 512 for the defaults
        self.trunk = nn.Conv1d(cfg.n_mels, c0, 7)
        self.ups = add_layers(self, "upconv", up_stack(c0, d, c0, n_up, cfg.kernel, cfg.stride))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, mel: Tensor) -> Tensor:
        dt = self.cfg.compute_dtype
        x = (mel * 2.0 - 1.0).to(dt).permute(0, 2, 1)  # (B, M, T)
        x = F.leaky_relu(conv_same(x, self.trunk, dt), 0.2)
        return run_up_stack(x, self.ups, dt, "leaky_relu")


class CondWaveGANDiscriminator(ShuffledDiscriminator):
    """(waveform (B, L), mel (B, L/hop, n_mels)) → patch logits
    (B, L / stride^(n_up+1)); phase-shuffled like
    :class:`~advoc_tpu_torch.models.wavegan.model.WaveGANDiscriminator`,
    its shifts (n_shuffled, B)."""

    def __init__(self, cfg: CondWaveGANConfig = CondWaveGANConfig()):
        super().__init__()
        self.cfg = cfg
        # One level more than G's: down to a coarse patch rate.
        self.convs = add_layers(self, "conv", down_stack(2, cfg.width, cfg.n_up + 1, cfg.kernel,
                                                        cfg.stride))
        self.logit = nn.Conv1d(self.convs[-1].out_channels, 1, 3)

    def forward(self, wav: Tensor, mel: Tensor, shifts: Tensor | None = None) -> Tensor:
        cfg = self.cfg
        cond = torch.repeat_interleave(mel.mean(dim=-1) * 2.0 - 1.0, cfg.hop, dim=-1)
        x = torch.stack([wav, cond], dim=1)  # (B, 2, L)
        x = run_down_stack(x.to(cfg.compute_dtype), self.convs, cfg.compute_dtype,
                           cfg.phase_shuffle, shifts if cfg.phase_shuffle > 0 else None)
        return conv_same(x.to(torch.float32), self.logit, torch.float32)[:, 0]
