"""The WaveGAN cell's yardstick: the generator's work from its shapes, and
the program's device ms by range for the readers.

A transposed convolution is counted on its input samples, without the
zeros a strided form would insert (as :mod:`flops` counts the U-Net's):
2 · L_in · C_in · C_out · k a sample. Its required bytes are its bf16
input, kernel and output, each moved once. The last level's input and
output count as bf16 too, though the program casts that level to float32:
the bound is of the work, not of the program's choice of precision.
"""

from __future__ import annotations

import sys

from flops import bound_s, peaks  # noqa: F401  (peaks: the readers' table)
from reference.wavegan import n_up


def levels(model: dict) -> list[tuple[int, int, int]]:
    """(L_in, C_in, C_out) of each transposed convolution: max(width,
    c0 / 2^(i+1)) features at level i, one at the last, c0 = width·2^n/2."""
    n, d = n_up(model), model["width"]
    c0 = d * 2**n // 2
    out, length, cin = [], 16, c0
    for i in range(n):
        cout = 1 if i == n - 1 else max(d, c0 // 2 ** (i + 1))
        out.append((length, cin, cout))
        length, cin = length * model["stride"], cout
    return out


def level_flops(model: dict) -> list[float]:
    """Each level's FLOP a sample (a generated clip)."""
    k = model["kernel"]
    return [2.0 * length * cin * cout * k for length, cin, cout in levels(model)]


def project_flops(model: dict) -> float:
    """The dense projection's FLOP a sample: latent_dim → 16 · c0."""
    c0 = levels(model)[0][1]
    return 2.0 * model["latent_dim"] * 16 * c0


def level_bytes(model: dict, b: int) -> list[float]:
    """Each level's required bytes at batch ``b``: bf16 input, kernel and
    output, once."""
    k, s = model["kernel"], model["stride"]
    return [2.0 * (b * cin * length + cin * cout * k + b * cout * length * s)
            for length, cin, cout in levels(model)]


def upconv_bound_s(model: dict, b: int, pk: dict) -> float:
    """The least time for the levels' work at batch ``b``: each level's FLOP
    at the bf16 peak or its bytes at the HBM peak, whichever is longer."""
    return sum(bound_s(b * f, nb, pk)
               for f, nb in zip(level_flops(model), level_bytes(model, b)))


def program_ms(run: dict) -> dict | None:
    """The program's device ms of each ``advoc.`` range a generator call
    (``profiling.device_ms(events, per="wavegan")`` on the traced run's
    profiler events, through the program's module as loaded), or None: no
    events, the program not loaded, a program whose ``device_ms`` takes no
    ``per``, or no ``advoc.wavegan`` range in the trace."""
    events = run.get("events")
    prof = sys.modules.get("advoc_tpu_torch.utils.profiling")
    if events is None or prof is None:
        return None
    try:
        ms = prof.device_ms(events, per="wavegan")
    except TypeError:  # a program without the ``per`` keyword
        return None
    return ms if "advoc.wavegan" in ms else None
