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
  same algorithm, the same required operations). :func:`gl_flops`,
  :func:`gl_bytes`, :func:`feat_work`, :func:`packed_up_work` and
  :func:`group_norm_bytes` (over :func:`group_norm_levels`) are those
  counts for the five kernels, and :func:`bound` turns a count into the
  least time the card could take; ``chip_smoke.py`` and
  ``scripts/roofline_torch.py`` both read them here.
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


H100_SXM = Peaks("NVIDIA H100 SXM", 989e12, 3.35e12)
TF32_FLOPS_PER_S = 495e12  # H100 SXM, dense TF32 tensor cores
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 on the CUDA cores
# Lower-case substrings of torch.cuda.get_device_name: the SXM part (HBM3).
_KNOWN = {"h100 80gb hbm3": H100_SXM, "h100 sxm": H100_SXM}


def device_peaks(device=None) -> Peaks:
    """Peak FLOP/s and HBM bandwidth of ``device`` (default: the current
    CUDA device; the CPU where there is none)."""
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    for key, peaks in _KNOWN.items():
        if key in kind.lower():
            return peaks
    return dataclasses.replace(H100_SXM, name=f"assumed-H100 SXM ({kind})", assumed=True)


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


# -- Hand counts of the kernels' work ---------------------------------------------
# The least work each kernel's function needs at a shape, counted once:
# the bound column of PERF.md's kernel table and the kernels line of
# chip_smoke.py, and B1's row of scripts/roofline_torch.py.


def gl_flops(b: int, t: int, f: int, n_iters: int, hop: int = 256,
             split_synth: bool = False) -> float:
    """Matmul FLOP of one fast-G-L call on (b, t, f) magnitudes (n_fft =
    4·hop): per row and iteration the synthesis 2·(2·T·F·n_fft) and the
    analysis 4·2·(2·T·hop·F), plus the final synthesis. ``split_synth``
    adds the split-synthesis loop's second (lo) synthesis product each
    iteration, n_iters·2·B·T·F·n_fft·2, as the JAX package's
    ``scripts/roofline.py`` counts its Pallas kernel."""
    synth = 2 * (2 * t * f * 4 * hop)
    anal = 4 * 2 * (2 * t * hop * f)
    flops = b * (n_iters * (synth + anal) + synth)
    if split_synth:
        flops += n_iters * 2 * b * t * f * 4 * hop * 2
    return float(flops)


def gl_bytes(b: int, t: int, f: int, hop: int = 256) -> float:
    """Bytes of one fast-G-L call with each input read once (the
    magnitudes, the four f32 DFT maps, the NOLA norm) and the waveform
    written once: the resident minimum, not the kernels' traffic (they move
    their carries through HBM between launches)."""
    return float(4 * (b * t * f + 4 * 4 * hop * f + (t + 3) * hop + b * t * hop))


def feat_work(b: int, length: int, hop: int = 256) -> tuple[float, float]:
    """FLOP and bytes of one fused-featurizer call: the DFT products over 384
    bins and the mel product per frame; audio, the two maps and the mel map
    read once, the (B, L//hop, 80) mel written once."""
    n = b * (length // hop)
    flops = n * (2 * 2 * 4 * hop * 384 + 2 * 384 * 80)
    return float(flops), float(4 * (b * length + 2 * 4 * hop * 384 + 384 * 128 + n * 80))


def packed_up_work(b: int, h: int, w: int, cin: int, f: int) -> tuple[float, float]:
    """FLOP and bytes of one packed_up call: 4 taps · cin MACs per output
    element; x (bf16) and the f32 weights read once, y (bf16) and the sums
    written once."""
    out = b * 2 * h * w * 2 * f
    return (float(out * 4 * cin * 2),
            float(2 * b * h * w * cin + 4 * (16 * cin * f + f) + 2 * out + 8 * b * 2 * f))


def group_norm_levels(cfg, b: int) -> list[tuple[str, str, tuple[int, int, int, int]]]:
    """(name, activation, (B, C, H, W)) of each level of ``cfg``'s U-Net (an
    ``AdvocConfig``) that GroupNorm + activation normalises, on ``b``
    windows of ``cfg.n_frames`` frames: ``down1`` … (LeakyReLU), then
    ``up0`` … (ReLU), as ``AdvocGenerator`` builds them."""
    feats = [min(cfg.width * 2**i, cfg.width * 8) for i in range(cfg.depth)]
    h, w = cfg.n_frames, (cfg.n_freq - 1) // cfg.freq_pack
    levels = []
    for i, f in enumerate(feats):
        h, w = h // 2, w // 2
        if i:
            levels.append((f"down{i}", "leaky_relu", (b, f, h, w)))
    n_ups = cfg.depth - 1 if cfg.fast_head else cfg.depth
    for i, f in enumerate(list(reversed(feats))[:n_ups]):
        h, w = 2 * h, 2 * w
        levels.append((f"up{i}", "relu", (b, f, h, w)))
    return levels


def group_norm_bytes(shape: tuple[int, ...], itemsize: int = 2, reads: int = 1) -> float:
    """Bytes of one GroupNorm + activation call on a ``shape`` (B, C, H, W)
    of ``itemsize``-byte elements (bf16 by default): each element read
    ``reads`` times and written once, and the f32 weight and bias read
    once. ``reads=1`` is the floor; ``reads=2`` two passes over a level
    larger than L2. No tensor-core operations."""
    n = 1
    for d in shape:
        n *= d
    return float((reads + 1) * itemsize * n + 8 * shape[1])


def bound(flops: float, nbytes: float,
          flops_per_s: float = H100_SXM.flops_per_s) -> tuple[float, str]:
    """(the least ms the card could take, "operations" or "bytes"): the
    operations at ``flops_per_s`` (default the dense bf16 tensor-core peak)
    or the bytes at the HBM rate, whichever takes longer."""
    ops_ms = 1e3 * flops / flops_per_s
    bytes_ms = 1e3 * nbytes / H100_SXM.hbm_bytes_per_s
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
