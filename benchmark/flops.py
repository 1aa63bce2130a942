"""The yardstick's counts: the matrix operations a vocoder call needs and
the least bytes G-L must move, from the shapes alone.

The counts are of the work the computation needs, whatever implements it:
the U-Net's convolutions (a transposed convolution counted on its input
pixels, without the zeros a strided form would insert), the pseudo-inverse
estimate, the mel-consistency projection (two products), and fast G-L as
the matrix form on all n_freq bins (each iteration a synthesis and an
analysis of two real products each, then one more synthesis). Elementwise
work, norms and reductions count zero, as ``FlopCounterMode`` counts them.
"""

from __future__ import annotations

import json
import pathlib


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    table = json.loads((pathlib.Path(__file__).with_name("peaks.json")).read_text())
    for d in table["devices"]:
        if d["match"] in kind:
            return d
    return None


def unet_flops(model: dict, n: int, t: int) -> float:
    """The generator's convolutions on ``n`` windows of ``t`` frames."""
    p, d, wd = model["freq_pack"], model["depth"], model["width"]
    feats = [min(wd * 2**i, wd * 8) for i in range(d)]
    h, w, cin, total = t, (model["n_freq"] - 1) // p, p, 0.0
    for f in feats:
        h, w = h // 2, w // 2
        total += 2.0 * n * h * w * f * cin * 16
        cin = f
    total += 2.0 * n * h * w * cin * cin * 9  # bottleneck
    x = feats[-1]
    n_ups = d - 1 if model["fast_head"] else d
    for i, f in enumerate(list(reversed(feats))[:n_ups]):
        skip = feats[d - 1 - i]
        total += 2.0 * n * h * w * (x + skip) * f * 16  # on its input pixels
        h, w, x = h * 2, w * 2, f
    if model["fast_head"]:
        total += 2.0 * n * h * w * (x + feats[0]) * 4 * p * 9
    else:
        total += 2.0 * n * h * w * x * p * model["head_kernel"] ** 2
    return total


def gl_flops(b: int, t: int, n_freq: int, n_fft: int, iters: int) -> float:
    """Fast G-L's matrix form: per iteration 2 synthesis + 2 analysis products
    of 2·T·F·n_fft, then the final synthesis."""
    return b * (iters * 8.0 + 4.0) * t * n_freq * n_fft


def gl_bytes(b: int, t: int, n_freq: int, n_fft: int, hop: int) -> float:
    """G-L's resident bytes: the magnitude read once, the waveform written
    once and the four float32 DFT maps read once."""
    return 4.0 * (b * t * n_freq + b * t * hop + 4 * n_fft * n_freq)


def vocode_flops(model: dict, voc: dict, audio: dict, b: int, t: int) -> dict:
    """The matrix FLOP of one Vocoder call on (b, t) mels, by stage."""
    from reference.vocoder import windows

    f, m, n_fft = audio["n_fft"] // 2 + 1, audio["n_mels"], audio["n_fft"]
    nw = len(windows(t, voc["chunk_frames"], voc["overlap_frames"]))
    return {
        "estimate": 2.0 * b * t * m * f,
        "unet": unet_flops(model, b * nw, voc["chunk_frames"]),
        "projection": 4.0 * b * t * m * f if voc["mel_projection"] else 0.0,
        "gl": gl_flops(b, t, f, n_fft, voc["gl_iters"]),
    }


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])

