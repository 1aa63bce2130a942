#!/usr/bin/env python
"""Matched-run quality A/B harness for advoc architecture decisions, on the
PyTorch port.

The port's copy of ``scripts/quality_ab.py``, with the same flags, fixture
set and ``RESULT`` line. Trains the advoc GAN for a fixed number of steps
on the deterministic synthetic fixture set (8 files, seeds 0–7, the same
bytes as the JAX script writes) and reports held-out eval L1 and the
steady-state steps/s after ``min(100, steps // 2)`` warm steps. The
protocol: identical data stream, optimizer and step count; ≥3 seeds per
variant, because GAN eval-L1 seed spread is ±0.003 — never decide off one
seed.

Usage:
  python scripts/quality_ab_torch.py --overrides "freq_pack=4" --steps 1000 --seed 0
  python scripts/quality_ab_torch.py --overrides "head_kernel=1" --steps 1000 --seed 1

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    """Prints the RESULT line; returns its numbers."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--overrides", default=None,
                   help="comma-separated AdvocConfig overrides for the variant under test")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--h2d_dtype", choices=["int16", "float32", "mulaw8"], default="int16",
                   help="training wire format under test (the model/optimizer arms stay "
                        "identical; the wire is the variant)")
    p.add_argument("--fixture_dir", default=str(pathlib.Path(tempfile.gettempdir())
                                                / "advoc_ab_fixture"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from advoc_tpu_torch.data import audioio, loader
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan
    from advoc_tpu_torch.train.harness import train_device
    from advoc_tpu_torch.utils import apply_overrides

    dev = train_device(args.device)
    cfg = apply_overrides(AdvocConfig(), args.overrides)
    g, d = AdvocGenerator(cfg).to(dev), PatchDiscriminator(cfg).to(dev)
    gstate, dstate = gan.make_states(g, d, seed=args.seed)
    step = gan.make_advoc_train_step(g, d, cfg, P)
    eval_step = gan.make_advoc_eval_step(cfg, P)

    # Deterministic fixture set (8 synthetic-speech files, seeds 0-7).
    out = pathlib.Path(args.fixture_dir)
    out.mkdir(parents=True, exist_ok=True)
    fps = []
    for i in range(8):
        fp = out / f"s{i}.wav"
        if not fp.exists():
            audioio.save_as_wav(synthetic_speech(i, 4 * P.sample_rate), fp, P.sample_rate)
        fps.append(str(fp))

    slice_len = cfg.n_frames * P.hop_length
    it = loader.decode_extract_and_batch(
        fps, batch_size=args.batch_size, slice_len=slice_len, seed=args.seed,
        sample_rate=P.sample_rate, out_dtype=args.h2d_dtype,
    )
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    warm = min(100, args.steps // 2)  # steps before the steady-state clock
    t0 = time.perf_counter()
    t_warm = None
    metrics = None
    for i, batch in enumerate(it):
        if i >= args.steps:
            break
        gstate, dstate, metrics = step(gstate, dstate, torch.as_tensor(batch, device=dev), rng)
        if i == warm - 1:  # warmup done; start the steady clock once the card has drained
            float(metrics["d_loss"])
            t_warm = time.perf_counter()
    if metrics is not None:
        float(metrics["d_loss"])  # the card has finished every step
    close = getattr(it, "close", None)
    if close is not None:
        close()
    dt = time.perf_counter() - t0
    steady = ((args.steps - warm) / (time.perf_counter() - t_warm)
              if t_warm is not None and args.steps > warm else float("nan"))

    # Held-out eval: fixture seeds the training stream never saw.
    evs = []
    for s in (100, 101, 102, 103):
        wav = synthetic_speech(s, slice_len * 2)
        m = eval_step(g, torch.tensor(wav, device=dev).reshape(2, slice_len))
        evs.append({k: float(v) for k, v in m.items()})
    agg = {k: float(np.mean([e[k] for e in evs])) for k in evs[0]}
    print(
        f"RESULT overrides={args.overrides!r} steps={args.steps} "
        f"seed={args.seed} wire={args.h2d_dtype} time={dt:.0f}s "
        f"steady_steps_per_s={steady:.2f} "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(agg.items())),
        flush=True,
    )
    return {"time_s": dt, "steady_steps_per_s": steady, **agg}


if __name__ == "__main__":
    main()
