#!/usr/bin/env python
"""STOI analysis of the trained generator against the heuristic, on the
PyTorch port.

The port's copy of ``scripts/stoi_analysis.py``, with the same flags,
variants, tables and result line. It separates where an intelligibility
(STOI) gap between the trained and the heuristic magnitude comes from:

  * **magnitude vs phase**: each variant is vocoded twice — through the
    shipped fast-G-L phase recovery AND with the ORACLE phase (the
    reference signal's own STFT phase on the variant's magnitude).
  * **fine detail vs band envelope**: per-mel-band L1 and per-band
    envelope correlation (Pearson over frames of each band's trajectory),
    the quantity STOI scores over 384 ms segments.

It also scores the **mel-consistency projection**
(``spectral.mel_consistency_project``): the trained repair projected back
onto the conditioning mel's band envelopes.

The G-L path follows the ``Vocoder``'s rule: on the card the tensor-core
G-L kernel (JAX's split_synth, on n_fft/2 bins), on the CPU the fp32
matmul scan, the JAX script's ``griffin_lim``.

Reports per-variant STOI / mel-L1 / band-envelope-correlation means over
held-out utterances (synthetic seeds the training stream never saw, or
``--files`` wavs), a per-band table for the worst bands, and ONE
machine-readable ``STOI_ANALYSIS_RESULT {...}`` line.

    python scripts/stoi_analysis_torch.py --train_dir runs/lj/train

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--seed0", type=int, default=200,
                   help="first held-out synthetic-speech seed")
    p.add_argument("--files", default=None,
                   help="optional newline list of eval wav paths to use "
                        "instead of synthetic utterances")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.checkpoint import load_train_generator
    from advoc_tpu_torch.train.eval_metrics import stoi
    from advoc_tpu_torch.train.harness import train_device

    dev = train_device(args.device)
    g, step = load_train_generator(args.train_dir, args.model_size, args.model_overrides)
    g = g.to(dev).eval()
    print(f"[stoi] restored step {step} from {args.train_dir}", flush=True)

    T = args.n_frames
    length = T * P.hop_length

    def gl(mag):
        if dev.type == "cuda":
            return sp.griffin_lim(mag, length, n_iters=args.gl_iters, momentum=0.99, params=P,
                                  fft_impl="kernel",
                                  drop_nyquist=P.fmax < 0.5 * P.sample_rate)
        return sp.griffin_lim(mag, length, n_iters=args.gl_iters, momentum=0.99, params=P)

    def magnitudes(mel):
        """(B, T, M) mel → (heuristic, trained, projected) magnitudes."""
        est = sp.r9y9_melspec_to_magspec(mel, P)
        est_norm = sp.normalize_db(sp.amp_to_db(est, P) - P.ref_level_db, P)
        rep = g(est_norm)
        mag_g = sp.db_to_amp(sp.denormalize_db(rep, P) + P.ref_level_db)
        return est, mag_g, sp.mel_consistency_project(mag_g, mel, P)

    @torch.inference_mode()
    def vocode_all(wav_ref):
        """One utterance → dict of 6 vocoded variants + its mel."""
        mel = sp.waveform_to_r9y9_melspec(wav_ref, P)[:T][None]
        spec_ref = sp.stft(wav_ref, P)[:T]
        # Oracle phase: the reference's own unit phase per bin.
        ph = spec_ref / torch.clamp(spec_ref.abs(), min=1e-12)
        est, mag_g, proj = magnitudes(mel)
        out = {}
        for name, mag in (("heuristic", est), ("trained", mag_g), ("projected", proj)):
            out[name] = gl(mag)[0]
            out[name + "_oracle_phase"] = sp.istft(mag[0].to(torch.complex64) * ph, length, P)
        return out, mel[0]

    if args.files:
        fps = pathlib.Path(args.files).read_text().splitlines()[: args.n_utts]
        wavs = [audioio.decode_audio(fp, P.sample_rate)[:length] for fp in fps]
        wavs = [w for w in wavs if len(w) == length]
        src = f"{len(wavs)} eval files"
    else:
        wavs = [synthetic_speech(args.seed0 + i, length) for i in range(args.n_utts)]
        src = f"{len(wavs)} held-out synthetic utterances"
    print(f"[stoi] scoring {src} ({T} frames each)", flush=True)

    variants = ["heuristic", "trained", "projected", "heuristic_oracle_phase",
                "trained_oracle_phase", "projected_oracle_phase"]
    acc = {v: {"stoi": [], "mel_l1": [], "band_l1": [], "env_corr": []} for v in variants}
    for w in wavs:
        outs, mel_ref = vocode_all(torch.tensor(w, dtype=torch.float32, device=dev))
        mel_ref = mel_ref.cpu().numpy()  # (T, M) normalized [0, 1]
        for v in variants:
            with torch.inference_mode():
                m = sp.waveform_to_r9y9_melspec(outs[v], P)[:T].cpu().numpy()
            y = outs[v].cpu().numpy()
            n = min(m.shape[0], T) - 1
            diff = np.abs(m[:n] - mel_ref[:n])  # (n, M)
            acc[v]["stoi"].append(stoi(w[: len(y)], y, P.sample_rate))
            acc[v]["mel_l1"].append(float(diff.mean()))
            acc[v]["band_l1"].append(diff.mean(axis=0))  # (M,)
            # Per-band envelope correlation: Pearson over frames of each band
            # trajectory, the quantity STOI scores.
            a = m[:n] - m[:n].mean(axis=0)
            b = mel_ref[:n] - mel_ref[:n].mean(axis=0)
            denom = np.sqrt((a**2).sum(axis=0) * (b**2).sum(axis=0)) + 1e-12
            acc[v]["env_corr"].append((a * b).sum(axis=0) / denom)

    summary = {}
    for v in variants:
        summary[v] = {
            "stoi": float(np.mean(acc[v]["stoi"])),
            "mel_l1": float(np.mean(acc[v]["mel_l1"])),
            "env_corr_mean": float(np.mean(np.stack(acc[v]["env_corr"]))),
        }
    print("\n| variant | STOI | mel L1 | band-envelope corr |")
    print("|---|---|---|---|")
    for v in variants:
        s = summary[v]
        print(f"| {v} | {s['stoi']:.4f} | {s['mel_l1']:.4f} | {s['env_corr_mean']:.4f} |")

    # Per-band diagnosis: where does the trained G win L1 but lose envelope
    # correlation (through the shipped G-L path)?
    bl_h = np.mean(np.stack(acc["heuristic"]["band_l1"]), axis=0)
    bl_t = np.mean(np.stack(acc["trained"]["band_l1"]), axis=0)
    ec_h = np.mean(np.stack(acc["heuristic"]["env_corr"]), axis=0)
    ec_t = np.mean(np.stack(acc["trained"]["env_corr"]), axis=0)
    worse_env = np.where(ec_t < ec_h - 0.02)[0]
    print(f"\nbands where trained env-corr < heuristic − 0.02: {worse_env.tolist()}")
    print("band | L1 heur | L1 trained | env heur | env trained")
    for b in worse_env[:12]:
        print(f"{b:4d} | {bl_h[b]:.4f} | {bl_t[b]:.4f} | {ec_h[b]:.4f} | {ec_t[b]:.4f}")

    result = {
        "ckpt_step": int(step),
        "n_utts": len(wavs),
        "source": "files" if args.files else "synthetic",
        **{v: {k: round(x, 4) for k, x in summary[v].items()} for v in variants},
        "bands_env_worse": [int(b) for b in worse_env.tolist()],
    }
    print("\nSTOI_ANALYSIS_RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
