"""upconv_roofline: the least time the card could take for the WaveGAN
generator's transposed convolutions (each level's FLOP at the dense bf16
peak or its bf16 input, kernel and output at the HBM peak, whichever is
longer; :func:`wavegan_flops.upconv_bound_s`), over the device ms of the
program's ``advoc.up<i>`` ranges a call, in %."""

import wavegan_flops


def read(run: dict):
    ms = wavegan_flops.program_ms(run)
    if not ms:
        return None
    model = run["config"]["model"]
    up = [ms.get(f"advoc.up{i}") for i in range(len(wavegan_flops.levels(model)))]
    pk = wavegan_flops.peaks(run["trace"].get("device_kind", ""))
    if None in up or pk is None:
        return None
    return 100.0 * wavegan_flops.upconv_bound_s(model, run["batch"], pk) / (sum(up) / 1e3)
