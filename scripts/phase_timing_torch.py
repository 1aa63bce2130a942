#!/usr/bin/env python
"""Device-cost table for every offline phase-recovery method, on the
PyTorch port.

The port's copy of ``scripts/phase_timing.py``, with the same flags, rows,
table and result line. Measures the cost of one call (slope timing: K1
against K2 chained calls, each chain ended by one synchronize, so the
launch and synchronize overhead cancels) and the re-extracted mel L1 of
each phase method of ``advoc_tpu_torch.ops.spectral``:

  fast-GL (momentum scan) · classic G-L · true batch LWS ·
  chromatic LWS (colors=4, two sweep counts) · online LWS (causal, look-ahead)

G-L runs the matmul scan in fp32, as the JAX script's ``griffin_lim``
default does; no port kernel runs here. Runs on the card; ``--device cpu``
runs on the CPU. Prints a markdown table plus one machine-readable JSON
line (``PHASE_TIMING_RESULT {...}``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def inputs(batch: int, frames: int, seed: int, device, params):
    """(mel, mag): ``batch`` utterances of ``frames`` frames cut from one
    synthetic signal, and their pinv magnitude estimate, on ``device``."""
    import torch

    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral as sp

    wav = torch.tensor(synthetic_speech(seed, batch * frames * params.hop_length),
                       device=device)
    mel = sp.waveform_to_r9y9_melspec(wav, params)[: batch * frames]
    mel = mel.reshape(batch, frames, params.n_mels)
    return mel, sp.r9y9_melspec_to_magspec(mel, params)


def methods(gl_iters: int, sweeps: int, params) -> list:
    """The table's rows: (name, magnitudes → waveform)."""
    from advoc_tpu_torch.ops import spectral as sp

    P, sw = params, sweeps
    return [
        (f"fast-GL {gl_iters} (shipped default)",
         lambda m: sp.griffin_lim(m, n_iters=gl_iters, momentum=0.99, params=P)),
        (f"classic G-L {gl_iters}",
         lambda m: sp.griffin_lim(m, n_iters=gl_iters, momentum=0.0, params=P)),
        (f"batch LWS sw{sw} (sequential GS)",
         lambda m: sp.lws(m, n_sweeps=sw, params=P)),
        (f"chromatic LWS sw{sw} colors=4",
         lambda m: sp.lws(m, n_sweeps=sw, colors=4, params=P)),
        (f"chromatic LWS sw{2 * sw} colors=4",
         lambda m: sp.lws(m, n_sweeps=2 * sw, colors=4, params=P)),
        ("online LWS sw2 la2 (causal)",
         lambda m: sp.lws_online(m, n_sweeps=2, look_ahead=2, params=P)),
    ]


def mel_l1_rows(y, mel, params) -> list[float]:
    """Re-extracted mel L1 of each row of the waveforms ``y`` against ``mel``."""
    from advoc_tpu_torch.ops import spectral as sp

    m2 = sp.waveform_to_r9y9_melspec(y, params)[:, : mel.shape[1]]
    return (m2 - mel).abs().mean(dim=(1, 2)).tolist()


def main(argv=None) -> dict:
    """Returns the result line's dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--lws_sweeps", type=int, default=5)
    p.add_argument("--k1", type=int, default=2)
    p.add_argument("--k2", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import torch

    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.harness import train_device
    from advoc_tpu_torch.utils.profiling import wait_for

    dev = train_device(args.device)
    b, t = args.batch, args.frames
    mel, mag = inputs(b, t, args.seed, dev, P)
    audio_s = b * t * P.hop_length / P.sample_rate

    def slope_ms(fn, x) -> float:
        def run(k: int) -> float:
            t0 = time.perf_counter()
            out = None
            for _ in range(k):
                out = fn(x)
            wait_for(out)  # the card has finished the chain
            return time.perf_counter() - t0

        run(1)  # warmup (constants, caches)
        a, c = run(args.k1), run(args.k2)
        return (c - a) / (args.k2 - args.k1) * 1000.0

    rows = []
    print(f"| method | device ms ({b}x{t} frames = {audio_s:.0f}s audio, {dev}) "
          "| mel L1 | x_realtime |")
    print("|---|---|---|---|")
    with torch.inference_mode():
        for name, fn in methods(args.gl_iters, args.lws_sweeps, P):
            y = fn(mag)
            ms = slope_ms(fn, mag)
            # Per utterance too: a row of the batch can be held alone to a
            # run of that utterance elsewhere.
            l1_rows = mel_l1_rows(y, mel, P)
            l1 = float(sum(l1_rows) / len(l1_rows))
            xrt = audio_s / (ms / 1000.0)
            rows.append({"method": name, "device_ms": ms, "mel_l1": l1, "x_rt": xrt,
                         "mel_l1_rows": l1_rows})
            print(f"| {name} | {ms:.2f} | {l1:.5f} | {xrt:.0f} |", flush=True)

    result = {"batch": b, "frames": t, "rows": rows}
    print("PHASE_TIMING_RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
