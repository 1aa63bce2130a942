#!/usr/bin/env python
"""Streaming-serving loop on the PyTorch port: drive N concurrent streams
through the StreamingVocoder and report per-push latency percentiles,
per-stream cost, aggregate throughput, and (optionally) spectral fidelity.

The port's copy of ``scripts/stream_serve.py``, with the same flags, table
and result line. It exercises the serving path as the server runs it:
fixed-shape pushes, carries resident on the card, narrow wire formats, for
any phase engine (``gl`` = per-chunk Griffin-Lim with a phase carry and a
crossfade; ``lws_online`` = causal streaming LWS; ``lws_block``). A push
returns its emit on the host (``readback=True`` copies it off the card,
which waits for the push's work), so each push's time ends when its
samples are on the host. Runs on the card; ``--device cpu`` runs on the
CPU.

Prints a short report plus ONE machine-readable JSON line
(``STREAM_SERVE_RESULT {...}``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    """Returns the result line's dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bundle", default=None, help="port inference bundle dir")
    p.add_argument("--train_dir", default=None,
                   help="trained ckpt dir; omit both for heuristic pipeline")
    p.add_argument("--model_size", choices=["full", "small"], default=None,
                   help="default: the bundle's (the run's recorded) config, else small")
    p.add_argument("--model_overrides", default=None)
    p.add_argument("--engine", choices=["gl", "lws_online", "lws_block"], default="gl")
    p.add_argument("--n_streams", type=int, default=1)
    p.add_argument("--chunk_frames", type=int, default=64)
    p.add_argument("--pushes", type=int, default=20)
    p.add_argument("--gl_iters", type=int, default=16)
    p.add_argument("--overlap_frames", type=int, default=8,
                   help="gl engine: crossfade overlap = emission delay")
    p.add_argument("--lws_sweeps", type=int, default=None)
    p.add_argument("--lws_look_ahead", type=int, default=2)
    p.add_argument("--mel_context", type=int, default=0)
    p.add_argument("--emit_dtype", choices=["float32", "int16"], default="float32")
    p.add_argument("--mel_dtype", choices=["float32", "float16"], default="float32")
    p.add_argument("--input", default=None,
                   help="wav file/dir per stream (cycled); default synthetic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fidelity", action="store_true",
                   help="also report stream-0 re-extracted mel L1")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer.vocoder import StreamingVocoder
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.harness import train_device

    dev = train_device(args.device)
    generator = None
    if args.bundle:
        from advoc_tpu_torch.train.checkpoint import load_generator

        generator, _ = load_generator(args.bundle, args.model_size, args.model_overrides,
                                      default_size="small")
    elif args.train_dir:
        from advoc_tpu_torch.train.checkpoint import load_train_generator

        generator, _ = load_train_generator(args.train_dir, args.model_size,
                                            args.model_overrides, default_size="small")

    def melspec(wav) -> np.ndarray:
        x = torch.tensor(np.asarray(wav, np.float32), device=dev)
        return spectral.waveform_to_r9y9_melspec(x, P).cpu().numpy()

    # --- per-stream mel feeds ---
    n, ch = args.n_streams, args.chunk_frames
    need = ch * args.pushes
    mels = []
    if args.input:
        from advoc_tpu_torch.data import audioio

        inp = pathlib.Path(args.input)
        paths = sorted(inp.rglob("*.wav")) if inp.is_dir() else [inp]
        for s in range(n):
            wav = audioio.decode_audio(paths[s % len(paths)], P.sample_rate)
            if s == 0:
                wav0 = np.asarray(wav)  # stream-0 source, for --fidelity
            m = melspec(wav)
            reps = -(-need // max(1, m.shape[0]))
            mels.append(np.tile(m, (reps, 1))[:need])
    else:
        for s in range(n):
            wav = synthetic_speech(args.seed + s, need * P.hop_length)
            if s == 0:
                wav0 = np.asarray(wav)
            mels.append(melspec(wav)[:need])
    mels = np.stack(mels)  # (n, need, M)

    sv = StreamingVocoder(
        generator, params=P, chunk_frames=ch, n_streams=n, gl_iters=args.gl_iters,
        phase_engine=args.engine, overlap_frames=args.overlap_frames,
        lws_sweeps=args.lws_sweeps, lws_look_ahead=args.lws_look_ahead,
        mel_context=args.mel_context, emit_dtype=args.emit_dtype,
        mel_dtype=args.mel_dtype, device=dev,
    )

    def chunk(c):
        x = mels[:, c * ch : (c + 1) * ch]
        return x[0] if n == 1 else x

    t0 = time.perf_counter()
    out0 = sv.push(chunk(0))  # first push: builds constants and caches
    compile_s = time.perf_counter() - t0
    times, outs = [], [out0]
    for c in range(1, args.pushes):
        t0 = time.perf_counter()
        outs.append(sv.push(chunk(c)))  # numpy: the samples are on the host
        times.append(time.perf_counter() - t0)
    times = np.asarray(times) * 1000.0
    audio_s = ch * P.hop_length / P.sample_rate  # per stream per push
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    agg_rtf = n * audio_s * 1000.0 / p50

    print(f"engine={args.engine} streams={n} chunk={ch} frames "
          f"({audio_s*1000:.0f} ms audio/push/stream) device={dev}")
    print(f"first push (incl. start-up): {compile_s:.1f} s")
    print(f"push wall ms: p50 {p50:.2f} / p95 {p95:.2f} / max {times.max():.2f}"
          f"  → {p50/n:.2f} ms/stream, aggregate {agg_rtf:.0f}× RT")

    result = {
        "engine": args.engine, "n_streams": n, "chunk_frames": ch,
        "pushes": args.pushes, "p50_ms": round(float(p50), 3),
        "p95_ms": round(float(p95), 3),
        "ms_per_stream": round(float(p50) / n, 3),
        "aggregate_rtf": round(float(agg_rtf), 1),
    }
    if args.fidelity:
        emitted = np.concatenate([o if n == 1 else o[0] for o in outs]).astype(np.float32)
        if args.emit_dtype == "int16":
            emitted = emitted / 32767.0
        sig = emitted[sv.preroll_samples + sv.latency_frames * P.hop_length :]
        n_fr = len(sig) // P.hop_length - 1
        if n_fr > 0:
            m2 = melspec(sig)[:n_fr]
            l1 = float(np.abs(m2 - mels[0][:n_fr]).mean())
            print(f"stream-0 re-extracted mel L1: {l1:.5f}")
            result["mel_l1"] = round(l1, 5)
            from advoc_tpu_torch.train.eval_metrics import stoi

            k = min(len(sig), len(wav0))
            s0 = stoi(wav0[:k], sig[:k], P.sample_rate)
            print(f"stream-0 STOI (intelligibility proxy): {s0:.4f}")
            result["stoi"] = round(s0, 4)
    print("STREAM_SERVE_RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
