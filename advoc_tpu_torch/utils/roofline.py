"""Roofline accounting of the port (``advoc_tpu.utils.roofline``).

For a computation it counts the operations and the least bytes it must
move, combines them with a measured device time, and reports the achieved
TFLOP/s, the share of the bf16 tensor-core peak, the achieved GB/s, the
share of HBM bandwidth and the bound ``max(flops / peak, bytes / bw)``:
whether a stage is held by operations or by bytes and how far from its
bound it runs.

Peaks are NVIDIA's data-sheet numbers for the H100 SXM: 989 TFLOP/s dense
bf16 and 3.35 TB/s of HBM3, at its 700 W power limit (a card set lower runs
slower under load; report its limit beside any share). A device this module
does not recognise gets the same numbers with ``assumed=True``: its shares
are not meaningful. Caveats, where they bite:

* :func:`cost_of` counts operations with ``torch.utils.flop_counter.
  FlopCounterMode``, which knows matrix products and convolutions only:
  elementwise work, reductions and FFTs count zero.
* The port's hand-written kernels (its registered ``advoc::`` operators and
  their ctypes launches) are invisible to it: count their operations by
  hand from the shapes, as the JAX package does for a Pallas call (the
  same algorithm, the same required operations), e.g. ``gl_flops`` in
  ``chip_smoke.py``.
* Its bytes are the floor, each input tensor read once and each output
  written once, not a measurement of the traffic the kernels make.
* The eager call runs every loop iteration, so no loop is counted once
  (the XLA cost analysis the JAX package corrects with ``cost_of_scan``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from advoc_tpu_torch.utils.profiling import tensors_in, wait_for


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    flops_per_s: float  # dense bf16 tensor-core peak
    hbm_bytes_per_s: float
    assumed: bool = False  # True when the device was not recognized


_H100_SXM = Peaks("NVIDIA H100 SXM", 989e12, 3.35e12)
# Lower-case substrings of torch.cuda.get_device_name: the SXM part (HBM3).
_KNOWN = {"h100 80gb hbm3": _H100_SXM, "h100 sxm": _H100_SXM}


def device_peaks(device=None) -> Peaks:
    """Peak FLOP/s and HBM bandwidth of ``device`` (default: the current
    CUDA device; the CPU where there is none)."""
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    for key, peaks in _KNOWN.items():
        if key in kind.lower():
            return peaks
    return dataclasses.replace(_H100_SXM, name=f"assumed-H100 SXM ({kind})", assumed=True)


def cost_of(fn: Callable, *args) -> dict:
    """Operations and the least bytes of one call ``fn(*args)`` (module
    docstring for what is and is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*args)
    moved = tensors_in(args) + tensors_in(out)
    return {
        "flops": float(counter.get_total_flops()),
        "bytes": float(sum(t.numel() * t.element_size() for t in moved)),
    }


def slope_time(fn: Callable, *args, k_lo: int = 2, k_hi: int = 10, trials: int = 3) -> float:
    """Seconds per call from chained calls: ``fn`` k_lo× and k_hi× back to
    back, each chain ended by a synchronize; the slope (t_hi − t_lo) /
    (k_hi − k_lo) cancels the launch and synchronize overhead of a chain."""

    def chain(k: int) -> float:
        out = None
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn(*args)
        wait_for(out)
        return time.perf_counter() - t0

    chain(1)  # warm: builds, caches
    best = float("inf")
    for _ in range(trials):
        t_lo, t_hi = chain(k_lo), chain(k_hi)
        best = min(best, (t_hi - t_lo) / (k_hi - k_lo))
    return best


def roofline_row(name: str, flops: float, bytes_: float, seconds: float, peaks: Peaks) -> dict:
    """One roofline table row: achieved rates, shares of peak, the bound.
    A stage below the slope timer's noise (≤ 0 s) gets zero rates and keeps
    its raw ms."""
    sol_compute = flops / peaks.flops_per_s
    sol_bw = bytes_ / peaks.hbm_bytes_per_s
    sol = max(sol_compute, sol_bw)
    if seconds <= 0:
        return {"stage": name, "flops": flops, "bytes": bytes_, "ms": seconds * 1e3,
                "tflops_per_s": 0.0, "mfu": 0.0, "gb_per_s": 0.0, "bw_frac": 0.0,
                "sol_ms": sol * 1e3, "sol_headroom": 0.0, "bound": "sub-noise"}
    return {
        "stage": name,
        "flops": flops,
        "bytes": bytes_,
        "ms": seconds * 1e3,
        "tflops_per_s": flops / seconds / 1e12,
        "mfu": flops / seconds / peaks.flops_per_s,
        "gb_per_s": bytes_ / seconds / 1e9,
        "bw_frac": bytes_ / seconds / peaks.hbm_bytes_per_s,
        "sol_ms": sol * 1e3,
        "sol_headroom": seconds / sol if sol else float("inf"),
        "bound": "compute" if sol_compute >= sol_bw else "bandwidth",
    }


def format_table(rows: list[dict], peaks: Peaks) -> str:
    """A markdown roofline table."""
    lines = ["| stage | ms | GFLOP | MB | TFLOP/s | MFU | GB/s | %HBM BW | SoL ms | ×SoL | bound |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['stage']} | {r['ms']:.2f} | {r['flops'] / 1e9:.1f} | {r['bytes'] / 1e6:.0f} "
            f"| {r['tflops_per_s']:.1f} | {r['mfu'] * 100:.1f}% | {r['gb_per_s']:.0f} "
            f"| {r['bw_frac'] * 100:.0f}% | {r['sol_ms']:.2f} | {r['sol_headroom']:.1f}× "
            f"| {r['bound']} |")
    note = (f"\nPeaks: {peaks.name} — {peaks.flops_per_s / 1e12:.0f} bf16 TFLOP/s, "
            f"{peaks.hbm_bytes_per_s / 1e9:.0f} GB/s HBM."
            + (" (device not recognized: peaks ASSUMED, shares not meaningful)"
               if peaks.assumed else ""))
    return "\n".join(lines) + note
