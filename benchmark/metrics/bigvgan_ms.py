"""bigvgan_ms: device ms of the program's ``advoc.bigvgan`` range a
generator call (the kernels, copies and sets launched inside
``BigVGANGenerator.forward``; ``profiling.device_ms(events,
per="bigvgan")``), the mean over the traced window's calls."""

import bigvgan_flops


def read(run: dict):
    ms = bigvgan_flops.program_ms(run)
    return ms["advoc.bigvgan"] if ms else None
