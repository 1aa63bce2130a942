"""Utilities of the port."""

from advoc_tpu_torch.utils.config import apply_overrides

__all__ = ["apply_overrides"]
