"""The BigVGAN cell's yardstick: the generator's work from its shapes, and
the program's device ms by range for the readers.

Counts are of a call on a padded (B, T) log-mel, whatever implements it.
A convolution counts 2 · L_out · C_in · C_out · k FLOP a row; a transposed
convolution is counted on its input samples, without the zeros a strided
form would insert (as :mod:`flops` counts the U-Net's): 2 · L_in · C_in ·
C_out · k. Its required bytes are its bf16 input, kernel and output, each
moved once; ``conv_post`` counts as bf16 too, though the program runs it in
float32: the bound is of the work, not of the program's choice of
precision. An anti-aliased activation's required bytes are one bf16 read
and one bf16 write of its (B, C, L), whatever implements it.
"""

from __future__ import annotations

import sys

from flops import bound_s, peaks  # noqa: F401  (peaks: the readers' table)

BF16 = 2  # bytes an element


def convs(model: dict, t: int) -> list[tuple[int, int, int, int, int]]:
    """(L_in, L_out, C_in, C_out, k) of every convolution of a call on ``t``
    frames, in order; a transposed one's L_out is u · L_in."""
    c = model["upsample_initial_channel"]
    out = [(t, t, model["num_mels"], c, 7)]
    length = t
    for u, k in zip(model["upsample_rates"], model["upsample_kernel_sizes"]):
        out.append((length, length * u, c, c // 2, k))
        length, c = length * u, c // 2
        for kr, dils in zip(model["resblock_kernel_sizes"], model["resblock_dilation_sizes"]):
            out += [(length, length, c, c, kr)] * (2 * len(dils))
    out.append((length, length, c, 1, 7))
    return out


def activations(model: dict, t: int) -> list[tuple[int, int]]:
    """(C, L) of every anti-aliased activation of a call on ``t`` frames."""
    c, length, out = model["upsample_initial_channel"], t, []
    n = sum(2 * len(d) for d in model["resblock_dilation_sizes"])
    for u in model["upsample_rates"]:
        c, length = c // 2, length * u
        out += [(c, length)] * n
    return out + [(c, length)]


def conv_flops(model: dict, t: int) -> list[float]:
    """Each convolution's FLOP a row, on its input samples."""
    return [2.0 * lin * cin * cout * k for lin, _, cin, cout, k in convs(model, t)]


def conv_bytes(model: dict, b: int, t: int) -> list[float]:
    """Each convolution's required bytes at batch ``b``: bf16 input, kernel
    and output, once."""
    return [BF16 * (b * cin * lin + cin * cout * k + b * cout * lout)
            for lin, lout, cin, cout, k in convs(model, t)]


def act_bytes(model: dict, b: int, t: int) -> float:
    """Every activation's required bytes at batch ``b``: one bf16 read and
    one bf16 write."""
    return sum(2.0 * BF16 * b * c * length for c, length in activations(model, t))


def conv_bound_s(model: dict, calls, pk: dict) -> float:
    """The least time for the convolutions of ``calls`` ((B, T) each): each
    convolution's FLOP at the bf16 peak or its bytes at the HBM peak,
    whichever is longer."""
    return sum(bound_s(b * f, nb, pk) for b, t in calls
               for f, nb in zip(conv_flops(model, t), conv_bytes(model, b, t)))


def act_bound_s(model: dict, calls, pk: dict) -> float:
    """The least time for the activations of ``calls``: their bytes at the
    HBM peak."""
    return sum(act_bytes(model, b, t) for b, t in calls) / pk["hbm_bytes_per_s"]


def program_ms(run: dict) -> dict | None:
    """The program's device ms of each ``advoc.`` range a generator call
    (``profiling.device_ms(events, per="bigvgan")`` on the traced run's
    profiler events, through the program's module as loaded), or None: no
    events, the program not loaded, a program whose ``device_ms`` takes no
    ``per``, or no ``advoc.bigvgan`` range in the trace. Kept in ``run``
    for the next reader: one pass over a traced pass's events."""
    if "program_ms" not in run:
        run["program_ms"] = _program_ms(run)
    return run["program_ms"]


def _program_ms(run: dict) -> dict | None:
    events = run.get("events")
    prof = sys.modules.get("advoc_tpu_torch.utils.profiling")
    if events is None or prof is None:
        return None
    try:
        ms = prof.device_ms(events, per="bigvgan")
    except TypeError:  # a program without the ``per`` keyword
        return None
    return ms if "advoc.bigvgan" in ms else None


def per_call_ratio(run: dict, rng: str, bound) -> float | None:
    """100 × the bound of the traced calls over the device time of the
    range ``rng`` in them (its ms a call × the calls), or None."""
    ms = program_ms(run)
    if not ms or not ms.get(rng) or not run.get("calls"):
        return None
    pk = peaks(run["trace"].get("device_kind", ""))
    if pk is None:
        return None
    return 100.0 * bound(run["config"]["model"], run["calls"], pk) / \
        (ms[rng] / 1e3 * len(run["calls"]))
