"""aa_act_roofline: the least time the card could take for BigVGAN's
anti-aliased activations (one bf16 read and one bf16 write of each
activation's (B, C, L) at the HBM peak, whatever implements them;
:func:`bigvgan_flops.act_bound_s`), over the device ms of the program's
``advoc.aa_act`` ranges, summed over the traced window's calls, in %."""

import bigvgan_flops


def read(run: dict):
    return bigvgan_flops.per_call_ratio(run, "advoc.aa_act", bigvgan_flops.act_bound_s)
