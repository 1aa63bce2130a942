#!/usr/bin/env python
"""Per-stage roofline account of the fused Vocoder call and the train step,
on the PyTorch port.

The port's copy of ``scripts/roofline.py``. For each stage of the
full-width B=128 × 256-frame Vocoder call, ``bench_torch.py``'s graph
(``VocodeGraph``: featurize + pinv estimate, U-Net forward, db→amp + mel
projection, fast G-L ×30 in the matmul form, fast G-L ×30 through B1, the
tensor-core G-L kernel the Vocoder ships, and the whole call) and for the
advoc GAN train step it reports FLOPs, bytes, achieved TFLOP/s, the share
of the bf16 tensor-core peak, the share of HBM bandwidth and the
speed-of-light time.

Method (``advoc_tpu_torch/utils/roofline.py``): FLOPs by
``FlopCounterMode`` (matrix products and convolutions; elementwise work
counts zero), bytes each input read once and each output written once;
seconds by chained-call slope timing (k_lo against k_hi calls, one
synchronize at the end of each chain). The kernels are invisible to the
counter, so B1's row takes the hand count of ``utils/roofline.py``
(``gl_flops`` with the split synthesis's second product, ``gl_bytes``: the
count behind PERF.md's bound column), the same work whatever implements
it. Its bytes are the resident minimum; the kernel moves its carries
through HBM on each of its 61 launches, so its real traffic is higher.
The whole call's row swaps the matmul G-L's count for that hand count. The train step's bytes are the batch plus each parameter and
both Adam moments read and written once.

    python scripts/roofline_torch.py [--batch 128] [--skip_train]

Runs on the card (``--cpu``: the CPU, where each kernel runs its plain
version). Prints the markdown table on stderr and ONE machine-readable
``ROOFLINE_RESULT {...}`` JSON line on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench_torch import VocodeGraph, headline_mel, seeded  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    """Returns the result line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128,
                   help="headline batch (chunks of 256 frames)")
    p.add_argument("--train_batch", type=int, default=16)
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--k_hi", type=int, default=10,
                   help="long-chain length for slope timing")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (smoke/debug; the kernels run their plain versions)")
    args = p.parse_args(argv)

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan
    from advoc_tpu_torch.train.harness import train_device
    from advoc_tpu_torch.utils import roofline as rl

    dev = train_device("cpu" if args.cpu else "cuda")
    peaks = rl.device_peaks(dev)
    on_card = dev.type == "cuda"
    log(f"[roofline] device: {dev} → peaks {peaks.name}; "
        f"B1 {'kernel' if on_card else 'plain version (CPU)'}")

    cfg = AdvocConfig()
    g = seeded(AdvocGenerator(cfg), 0, dev)
    B, T = args.batch, cfg.n_frames
    hop, n = P.hop_length, args.gl_iters

    mel = headline_mel(B, T, dev)
    # bench_torch.py's graph, cut at its stage seams: the shipped form (G-L
    # through B1, the tensor-core kernel at split_synth on n_fft/2 bins), and
    # the matmul form at JAX's DEFAULT precision (bf16 operands), the scan
    # the JAX script counts.
    graph = VocodeGraph(g, n)
    mm = dataclasses.replace(graph, impl="matmul")
    with torch.inference_mode():
        est_norm = graph.featurize(mel)
        repaired = graph.unet(est_norm)
        mag = graph.to_mag(repaired, mel)

    rows = []

    def stage(name, fn, *sargs, cost=None, time_fn=None, note=None):
        cost = cost or rl.cost_of(fn, *sargs)
        secs = rl.slope_time(time_fn or fn, *sargs, k_hi=args.k_hi)
        row = rl.roofline_row(name, cost["flops"], cost["bytes"], secs, peaks)
        if note:
            row["note"] = note
        rows.append(row)
        log(f"[roofline] {name}: {row['ms']:.2f} ms, {row['flops'] / 1e9:.1f} GFLOP, "
            f"{row['mfu'] * 100:.1f}% MFU, {row['bw_frac'] * 100:.0f}% BW, bound={row['bound']}")
        return row

    stage("featurize+pinv estimate", graph.featurize, mel)
    stage("U-Net forward", graph.unet, est_norm)
    stage("db→amp + mel projection", graph.to_mag, repaired, mel)
    gl_mm = stage(f"fast-GL ×{n} (matmul form)", mm.gl, mag)
    # B1: the hand count (FlopCounterMode cannot see the kernel).
    b1 = {"flops": rl.gl_flops(B, T, 512, n, hop, split_synth=True),
          "bytes": rl.gl_bytes(B, T, 512, hop)}
    stage(f"fast-GL ×{n} (B1 kernel, shipped)", graph.gl, mag, cost=b1,
          note=f"hand count (utils/roofline.py gl_flops split_synth, gl_bytes); bytes are "
               f"the resident minimum: the kernel's {2 * n + 1} launches move "
               f"the carries through HBM, so its traffic is higher")
    whole_cost = rl.cost_of(mm, mel)
    whole_cost["flops"] += b1["flops"] - gl_mm["flops"]
    stage("WHOLE fused vocoder (shipped)", graph, mel,
          cost=whole_cost, note="the matmul G-L's count replaced by B1's hand count")

    # --- the train step ---
    if not args.skip_train:
        gt, d = AdvocGenerator(cfg).to(dev), PatchDiscriminator(cfg).to(dev)
        gstate, dstate = gan.make_states(gt, d, seed=0)
        step = gan.make_advoc_train_step(gt, d, cfg, P)
        bt = args.train_batch
        batch = torch.tensor(synthetic_speech(1, bt * T * hop), device=dev).reshape(bt, -1)
        with FlopCounterMode(display=False) as counter:  # with autograd: the backward counts
            step(gstate, dstate, batch)
        n_bytes = sum(x.numel() * x.element_size() for x in gstate.params + dstate.params)
        cost = {"flops": float(counter.get_total_flops()),
                "bytes": float(batch.numel() * batch.element_size() + 2 * 3 * n_bytes)}
        stage(f"GAN train step (B={bt}×{T * hop})", step, gstate, dstate, batch, cost=cost)

    audio_s = B * T * hop / P.sample_rate
    whole = next(r for r in rows if r["stage"].startswith("WHOLE"))
    log("")
    log(rl.format_table(rows, peaks))
    log("")
    log(f"[roofline] headline batch = {audio_s:.0f}s audio; whole-call ×RT at the slope "
        f"time: {audio_s / (whole['ms'] / 1e3):.0f}×")

    result = {
        "device": peaks.name,
        "batch": B,
        "rows": [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
                 for r in rows],
    }
    print("ROOFLINE_RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
