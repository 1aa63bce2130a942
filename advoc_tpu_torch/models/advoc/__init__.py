"""advoc: the U-Net magnitude repairer and its patch discriminator."""

from advoc_tpu_torch.models.advoc.convert import (
    flax_disc_to_torch_state_dict,
    flax_to_torch_state_dict,
)
from advoc_tpu_torch.models.advoc.model import AdvocConfig, AdvocGenerator, PatchDiscriminator

__all__ = ["AdvocConfig", "AdvocGenerator", "PatchDiscriminator", "flax_disc_to_torch_state_dict",
           "flax_to_torch_state_dict"]
