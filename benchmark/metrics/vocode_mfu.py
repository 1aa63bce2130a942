"""vocode_mfu: the matrix FLOP the traced window's Vocoder calls need
(:func:`flops.vocode_flops`: U-Net convolutions, pseudo-inverse estimate,
mel projection, G-L as the matrix form on n_freq bins), over the window's
seconds and the card's dense bf16 peak, in %."""

import flops


def read(run: dict):
    if "trace" not in run or "calls" not in run or "vocoder" not in run["config"]:
        return None
    pk = flops.peaks(run["trace"].get("device_kind", ""))
    if pk is None:
        return None
    cfg = run["config"]
    total = sum(sum(flops.vocode_flops(cfg["model"], cfg["vocoder"], run["audio"], b, t).values())
                for b, t, _ in run["calls"])
    return 100.0 * total / run["window_s"] / pk["bf16_flops_per_s"]
