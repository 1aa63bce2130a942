"""WaveGAN: the end-to-end waveform GAN and its mel-conditioned variant."""

from advoc_tpu_torch.models.wavegan.conditional import (
    CondWaveGANConfig,
    CondWaveGANDiscriminator,
    CondWaveGANGenerator,
)
from advoc_tpu_torch.models.wavegan.model import (
    WaveGANConfig,
    WaveGANDiscriminator,
    WaveGANGenerator,
)

__all__ = ["CondWaveGANConfig", "CondWaveGANDiscriminator", "CondWaveGANGenerator",
           "WaveGANConfig", "WaveGANDiscriminator", "WaveGANGenerator"]
