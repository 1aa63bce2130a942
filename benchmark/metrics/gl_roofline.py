"""gl_roofline: the least time the card could take for G-L's required work
(the matrix form on n_freq bins at the dense bf16 peak, or its resident
bytes at the HBM peak, whichever is longer), summed over the traced
window's calls, over the device ms of the ``spectral.griffin_lim`` calls
(CUDA events), in %."""

import flops


def read(run: dict):
    ms = run.get("gl_ms")
    if not ms or "trace" not in run or "vocoder" not in run["config"]:
        return None
    pk = flops.peaks(run["trace"].get("device_kind", ""))
    if pk is None:
        return None
    a, v = run["audio"], run["config"]["vocoder"]
    f = a["n_fft"] // 2 + 1
    bound = sum(flops.bound_s(flops.gl_flops(b, t, f, a["n_fft"], v["gl_iters"]),
                              flops.gl_bytes(b, t, f, a["n_fft"], a["hop_length"]), pk)
                for b, t, _ in run["calls"])
    return 100.0 * bound / (sum(ms) / 1e3)
