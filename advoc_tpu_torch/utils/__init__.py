"""Utilities of the port."""

from advoc_tpu_torch.utils.config import apply_overrides, ensure_dataset, find_wavs

__all__ = ["apply_overrides", "ensure_dataset", "find_wavs"]
