"""bigvgan_conv_roofline: the least time the card could take for BigVGAN's
convolutions (each one's FLOP at the dense bf16 peak or its bf16 input,
kernel and output at the HBM peak, whichever is longer;
:func:`bigvgan_flops.conv_bound_s`), over the device ms of the program's
``advoc.conv`` ranges inside ``advoc.bigvgan``, summed over the traced
window's calls, in %."""

import bigvgan_flops


def read(run: dict):
    return bigvgan_flops.per_call_ratio(run, "advoc.conv", bigvgan_flops.conv_bound_s)
