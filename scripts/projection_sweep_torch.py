#!/usr/bin/env python
"""Sweep the mel-consistency projection's knobs, on the PyTorch port.

The port's copy of ``scripts/projection_sweep.py``, with the same flags,
grid, table and result line. The projection ships at ``strength=1.0,
max_gain=4.0, n_iters=1`` (``ops/spectral.py`` ``mel_consistency_project``).
This script grids (strength, max_gain, n_iters) on held-out utterances
through the trained generator (a run's latest checkpoint) and the shipped
G-L path, scoring STOI, re-extracted mel L1, and normalized-dB spec L1
against the true magnitude.

The G-L path follows the ``Vocoder``'s rule: on the card the tensor-core
G-L kernel (JAX's split_synth, on n_fft/2 bins), on the CPU the fp32
matmul scan, the JAX script's ``griffin_lim``.

    python scripts/projection_sweep_torch.py --train_dir runs/lj/train

Runs on the card; ``--device cpu`` runs on the CPU. Prints a markdown
table + ONE ``PROJECTION_SWEEP_RESULT {...}`` line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    """Returns the result line's dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--model_size", choices=["full", "small"], default=None,
                   help="default: the run's recorded config, else full")
    p.add_argument("--model_overrides", default=None)
    p.add_argument("--n_frames", type=int, default=256)
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--n_utts", type=int, default=8)
    p.add_argument("--seed0", type=int, default=200)
    p.add_argument("--strengths", default="0.0,0.5,1.0")
    p.add_argument("--max_gains", default="2.0,4.0,8.0")
    p.add_argument("--n_iters", default="1,2,3")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.checkpoint import load_train_generator
    from advoc_tpu_torch.train.eval_metrics import stoi
    from advoc_tpu_torch.train.harness import train_device

    dev = train_device(args.device)
    g, ckpt_step = load_train_generator(args.train_dir, args.model_size, args.model_overrides)
    g = g.to(dev).eval()
    print(f"[sweep] restored step {ckpt_step} from {args.train_dir}", flush=True)

    T = args.n_frames
    length = T * P.hop_length

    def gl(mag):
        if dev.type == "cuda":
            return sp.griffin_lim(mag, length, n_iters=args.gl_iters, momentum=0.99, params=P,
                                  fft_impl="kernel",
                                  drop_nyquist=P.fmax < 0.5 * P.sample_rate)
        return sp.griffin_lim(mag, length, n_iters=args.gl_iters, momentum=0.99, params=P)

    def db_norm(mag):
        return sp.normalize_db(sp.amp_to_db(mag, P) - P.ref_level_db, P)

    @torch.inference_mode()
    def vocode(wav_ref, strength, max_gain, n_it):
        mel = sp.waveform_to_r9y9_melspec(wav_ref, P)[:T][None]
        mag_true = sp.stft(wav_ref, P).abs()[:T][None]
        est = sp.r9y9_melspec_to_magspec(mel, P)
        rep = g(db_norm(est))
        mag_g = sp.db_to_amp(sp.denormalize_db(rep, P) + P.ref_level_db)
        proj = sp.mel_consistency_project(mag_g, mel, P, strength=strength,
                                          max_gain=max_gain, n_iters=n_it)
        y = gl(proj)[0]
        # normalized-dB L1 against the true magnitude: does the projection
        # drag the repair back toward the heuristic, or keep it?
        db_l1 = (db_norm(proj) - db_norm(mag_true)).abs().mean()
        return y, mel[0], db_l1

    wavs = [synthetic_speech(args.seed0 + i, length) for i in range(args.n_utts)]
    strengths = [float(s) for s in args.strengths.split(",")]
    max_gains = [float(s) for s in args.max_gains.split(",")]
    n_iters = [int(s) for s in args.n_iters.split(",")]

    # strength=0 ignores max_gain/n_iters: score it once as the raw-repair
    # floor row instead of 9 duplicate grid points.
    grid = [(0.0, max_gains[0], n_iters[0])] if 0.0 in strengths else []
    grid += list(itertools.product([s for s in strengths if s > 0.0], max_gains, n_iters))

    rows = []
    for s, mg, ni in grid:
        st, ml, db = [], [], []
        for w in wavs:
            y, mel_ref, db_l1 = vocode(torch.tensor(w, device=dev), s, mg, ni)
            with torch.inference_mode():
                m = sp.waveform_to_r9y9_melspec(y, P)[:T].cpu().numpy()
            y = y.cpu().numpy()
            n = min(m.shape[0], T) - 1
            st.append(stoi(w[: len(y)], y, P.sample_rate))
            ml.append(float(np.abs(m[:n] - mel_ref.cpu().numpy()[:n]).mean()))
            db.append(float(db_l1))
        rows.append(dict(strength=s, max_gain=mg, n_iters=ni, stoi=float(np.mean(st)),
                         mel_l1=float(np.mean(ml)), db_l1_vs_true=float(np.mean(db))))
        r = rows[-1]
        print(f"[sweep] s={s} max_gain={mg} n_iters={ni}: STOI {r['stoi']:.4f} "
              f"mel_l1 {r['mel_l1']:.4f} dbL1 {r['db_l1_vs_true']:.4f}", flush=True)

    print("\n| strength | max_gain | n_iters | STOI | mel L1 | dB-L1 vs true |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['strength']} | {r['max_gain']} | {r['n_iters']} | {r['stoi']:.4f} | "
              f"{r['mel_l1']:.4f} | {r['db_l1_vs_true']:.4f} |")

    best = max(rows, key=lambda r: r["stoi"])
    shipped = next((r for r in rows if r["strength"] == 1.0 and r["max_gain"] == 4.0
                    and r["n_iters"] == 1), None)
    result = {"ckpt_step": int(ckpt_step), "n_utts": len(wavs),
              "rows": [{k: round(v, 4) if isinstance(v, float) else v for k, v in r.items()}
                       for r in rows],
              "best": best, "shipped": shipped}
    print("\nPROJECTION_SWEEP_RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
