"""wavegan_ms: device ms of the program's ``advoc.wavegan`` range a
generator call (the kernels, copies and sets launched inside
``WaveGANGenerator.forward``; ``profiling.device_ms(events,
per="wavegan")``), the mean over the traced window's calls."""

import wavegan_flops


def read(run: dict):
    ms = wavegan_flops.program_ms(run)
    return ms["advoc.wavegan"] if ms else None
