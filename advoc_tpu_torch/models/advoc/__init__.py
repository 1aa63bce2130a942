"""advoc: the U-Net magnitude repairer."""

from advoc_tpu_torch.models.advoc.convert import flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import AdvocConfig, AdvocGenerator

__all__ = ["AdvocConfig", "AdvocGenerator", "flax_to_torch_state_dict"]
