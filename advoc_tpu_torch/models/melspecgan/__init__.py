"""MelSpecGAN: the unconditional mel-spectrogram GAN."""

from advoc_tpu_torch.models.melspecgan.model import (
    MelSpecGANConfig,
    MelSpecGANDiscriminator,
    MelSpecGANGenerator,
)

__all__ = ["MelSpecGANConfig", "MelSpecGANDiscriminator", "MelSpecGANGenerator"]
