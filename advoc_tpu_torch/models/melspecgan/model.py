"""MelSpecGAN in PyTorch: a DCGAN-style unconditional generator of r9y9
mel spectrograms, which the advoc vocoder turns into audio.

The port of ``advoc_tpu.models.melspecgan.model``. Images are NCHW,
(B, C, n_frames, n_mels), where flax's are NHWC: the generator's
projection is reshaped as flax's (B, 4, 5, 8d) and permuted, and the
discriminator's last activation is permuted back to NHWC before it is
flattened for the logit ``Dense``. Module names are flax's (``project``,
``conv{i}``, ``norm{i}``, ``head``, ``logit``).

Generator: Dense → (8d, n_frames/16, n_mels/16) → ReLU, three rounds of
[nearest ×2 → 5×5 conv in the compute dtype → GroupNorm(8) in float32 →
ReLU] to 4d, 2d, d features, one more ×2 and a float32 5×5 head to one
channel, then sigmoid: (B, 64, 80) in [0, 1] from a (4, 5) seed.
``jax.image.resize(method="nearest")`` by 2 is ``repeat_interleave(2)``
on each axis. Discriminator: (mel·2 − 1) → four 5×5 stride-2 "SAME" convs
(padded (1, 2) on both axes at 64 × 80, by ``F.pad``) to d, 2d, 4d, 8d
features with LeakyReLU(0.2), then a float32 logit ``Dense``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.models.layers import DTYPES, GroupNorm, conv_same, dense, flax_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MelSpecGANConfig:
    """The JAX package's fields and defaults."""

    n_frames: int = 64
    n_mels: int = 80
    latent_dim: int = 100
    width: int = 64
    dtype: str = "bfloat16"
    gan_type: str = "wgan-gp"
    n_critic: int = 5
    gp_weight: float = 10.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def _up2(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class MelSpecGANGenerator(nn.Module):
    """z (B, latent) → mel (B, n_frames, n_mels) in [0, 1]."""

    def __init__(self, cfg: MelSpecGANConfig = MelSpecGANConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        self.h0, self.w0 = cfg.n_frames // 16, cfg.n_mels // 16  # (4, 5)
        self.project = nn.Linear(cfg.latent_dim, self.h0 * self.w0 * d * 8)
        cin = d * 8
        for i, f in enumerate([d * 4, d * 2, d]):
            self.add_module(f"conv{i}", nn.Conv2d(cin, f, 5))
            self.add_module(f"norm{i}", GroupNorm(8, f, torch.float32))
            cin = f
        self.head = nn.Conv2d(cin, 1, 5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, z: Tensor) -> Tensor:
        dt = self.cfg.compute_dtype
        x = dense(z, self.project, dt).reshape(z.shape[0], self.h0, self.w0, -1)
        x = F.relu(x.permute(0, 3, 1, 2))
        for i in range(3):
            x = conv_same(_up2(x), getattr(self, f"conv{i}"), dt)
            x = F.relu(getattr(self, f"norm{i}")(x))
        x = conv_same(_up2(x).to(torch.float32), self.head, torch.float32)
        return torch.sigmoid(x[:, 0])


class MelSpecGANDiscriminator(nn.Module):
    """mel (B, n_frames, n_mels) → scalar logit (B,)."""

    def __init__(self, cfg: MelSpecGANConfig = MelSpecGANConfig()):
        super().__init__()
        self.cfg = cfg
        d, cin = cfg.width, 1
        h, w = cfg.n_frames, cfg.n_mels
        for i, f in enumerate([d, d * 2, d * 4, d * 8]):
            self.add_module(f"conv{i}", nn.Conv2d(cin, f, 5, stride=2))
            cin, h, w = f, -(-h // 2), -(-w // 2)
        self.logit = nn.Linear(h * w * cin, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, mel: Tensor) -> Tensor:
        dt = self.cfg.compute_dtype
        x = (mel * 2.0 - 1.0)[:, None].to(dt)
        for i in range(4):
            x = F.leaky_relu(conv_same(x, getattr(self, f"conv{i}"), dt), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC order
        return dense(x.to(torch.float32), self.logit, torch.float32)[:, 0]
