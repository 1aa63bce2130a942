"""BigVGAN: a universal mel-to-waveform vocoder (arXiv:2206.04658)."""

from advoc_tpu_torch.models.bigvgan.model import BigVGANConfig, BigVGANGenerator

__all__ = ["BigVGANConfig", "BigVGANGenerator"]
