#!/usr/bin/env python
"""Stress-fixture eval panel on the PyTorch port: round-trip the vocoder
over degenerate inputs.

The port's copy of ``scripts/stress_eval.py``, with the same flags and
table. Runs each stress class (silence, clipping, noise, chirp, tone, dc —
``advoc_tpu_torch.data.synthetic.STRESS_KINDS``) through mel extraction →
vocoder → objective panel (spec L1, LSD, SNR, re-extracted mel L1) and
prints a markdown table. With ``--train_dir`` the panel runs through the
trained advoc generator (the run's latest checkpoint); otherwise the pure
heuristic pipeline. The offline ``Vocoder`` runs fast G-L through the
tensor-core G-L kernel on the card. ``--streaming ENGINE`` routes the panel
through the chunked :class:`StreamingVocoder` instead: chunked pushes plus
the end-of-utterance ``flush()``, flush_samples-aligned. Runs on the card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def make_streaming_vocode(generator, params, engine, args, device):
    """mel → waveform through chunked StreamingVocoder pushes, stream-start
    aligned (drop preroll + look-ahead) and trimmed to the input length."""
    import numpy as np
    import torch

    from advoc_tpu_torch.infer import StreamingVocoder

    kw = dict(gl_iters=args.gl_iters, overlap_frames=args.overlap_frames)
    if engine != "gl":
        kw = dict(lws_sweeps=args.lws_sweeps, lws_look_ahead=args.lws_look_ahead)

    def vocode(mel):
        mel = mel.cpu().numpy() if torch.is_tensor(mel) else np.asarray(mel)
        t = mel.shape[0]
        ch = args.chunk_frames
        sv = StreamingVocoder(generator, params=params, chunk_frames=ch,
                              phase_engine=engine, device=device, **kw)
        # Pad to whole chunks (fixed-shape pushes), then flush(): the
        # end-of-utterance contract.
        melp = np.pad(mel, ((0, (-t) % ch), (0, 0)))
        outs = [sv.push(melp[c : c + ch]) for c in range(0, melp.shape[0], ch)]
        outs.append(sv.flush())
        stream = np.concatenate(outs)
        sig = stream[sv.flush_samples :]
        return sig[: t * params.hop_length]

    return vocode


def main(argv=None) -> dict:
    """Prints the panel's table; returns the panel ({class: metrics})."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", default=None,
                   help="trained advoc run; omit for the heuristic pipeline")
    p.add_argument("--model_size", choices=["full", "small"], default=None,
                   help="default: the run's recorded config, else full")
    p.add_argument("--model_overrides", default=None)
    p.add_argument("--n_frames", type=int, default=256)
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--streaming", default=None,
                   choices=["gl", "lws_online", "lws_block"],
                   help="run the panel through the StreamingVocoder path")
    p.add_argument("--chunk_frames", type=int, default=64)
    p.add_argument("--overlap_frames", type=int, default=8)
    p.add_argument("--lws_sweeps", type=int, default=None)
    p.add_argument("--lws_look_ahead", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS
    from advoc_tpu_torch.train.eval_metrics import stress_panel
    from advoc_tpu_torch.train.harness import train_device

    dev = train_device(args.device)
    generator = None
    chunk_frames = args.chunk_frames if args.streaming else 256
    desc = "heuristic"
    if args.train_dir is not None:
        from advoc_tpu_torch.train.checkpoint import load_train_generator

        generator, step = load_train_generator(args.train_dir, args.model_size,
                                               args.model_overrides)
        generator = generator.to(dev).eval()
        chunk_frames = args.chunk_frames if args.streaming else generator.cfg.n_frames
        desc = f"advoc step {step}"

    if args.streaming:
        voc = make_streaming_vocode(generator, DEFAULT_PARAMS, args.streaming, args, dev)
        desc += f", streaming {args.streaming} (chunk {args.chunk_frames})"
    else:
        voc = Vocoder(generator, params=DEFAULT_PARAMS, chunk_frames=chunk_frames,
                      gl_iters=args.gl_iters, device=dev)

    panel = stress_panel(voc, n_frames=args.n_frames, seed=args.seed, device=dev)
    print(f"\nStress panel ({desc}, {args.n_frames} frames, "
          f"{args.gl_iters} G-L iters):\n")
    cols = ["spec_l1", "lsd_db", "snr_db", "mel_l1"]
    print("| class | " + " | ".join(cols) + " |")
    print("|---|" + "---|" * len(cols))
    for kind, m in panel.items():
        print(f"| {kind} | " + " | ".join(f"{m[c]:.4f}" for c in cols) + " |")
    return panel


if __name__ == "__main__":
    main()
