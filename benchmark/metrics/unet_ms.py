"""unet_ms: device ms of the generator's call in each Vocoder call (CUDA
events around the Vocoder's generator, one call of it a Vocoder call), the
mean over the traced window."""


def read(run: dict):
    ms = run.get("unet_ms")
    return sum(ms) / len(ms) if ms else None
