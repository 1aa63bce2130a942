"""Inference entry points of the port."""

from advoc_tpu_torch.infer.vocoder import StreamingVocoder, Vocoder

__all__ = ["StreamingVocoder", "Vocoder"]
