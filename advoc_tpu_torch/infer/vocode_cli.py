"""Offline vocoding CLI: mels in, wavs out, with a throughput report.

    python -m advoc_tpu_torch.infer.vocode_cli --bundle runs/advoc/bundle_torch \\
        --input mels.npy --out_dir out/

Input: a .npy of (T, 80) or (B, T, 80) r9y9-normalized mels (a TTS
frontend's output), or a wav or a directory of wavs to re-vocode
(featurized on the device by the STFT path). Loads a port inference bundle
(``scripts/bundle_to_torch.py`` converts a JAX one); without one it runs
the heuristic pipeline; ``--train_dir`` takes the generator of a training
run's latest checkpoint instead. Runs on the card unless ``--device cpu``.
The port's copy of ``advoc_tpu.infer.vocode_cli``.

AOT artifacts (:mod:`advoc_tpu_torch.infer.export`): ``--aot_export DIR``
exports the loaded Vocoder at (1, bucket) for each input's bucketed length
instead of vocoding (``--aot_allow_custom_calls`` accepts an artifact that
records the port's kernels, which the card's default phase_impl does);
``--aot DIR`` then serves from such a directory with no model code, one
input at a time:

    python -m advoc_tpu_torch.infer.vocode_cli --bundle B --input wavs/ \
        --out_dir unused/ --aot_export aot/ --aot_allow_custom_calls
    python -m advoc_tpu_torch.infer.vocode_cli --aot aot/ --input wavs/ --out_dir out/
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Vocode every input into ``--out_dir``; returns the totals of the
    timed part (after the warmup): files, audio seconds, wall seconds."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True,
                   help=".npy mels, a wav file, or a directory of wavs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--bundle", default=None, help="port inference bundle dir")
    p.add_argument("--train_dir", default=None,
                   help="a training run: its latest checkpoint's generator (alternative "
                        "to --bundle)")
    p.add_argument("--aot", default=None,
                   help="serve from an AOT artifact dir (infer.export_vocoder output): no "
                        "model code; overrides --bundle/--train_dir")
    p.add_argument("--aot_export", default=None,
                   help="instead of vocoding, export the loaded Vocoder as AOT artifacts "
                        "into this dir (batch 1, each input's bucketed length)")
    p.add_argument("--aot_allow_custom_calls", action="store_true",
                   help="--aot_export: accept an artifact that records the port's kernels "
                        "(advoc:: operators; runs where they are registered: the default "
                        "phase_impl on the card)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--model_size", choices=["full", "small"], default=None,
                   help="default: the bundle config's model_size (a training run's "
                        "recorded config), else full")
    p.add_argument("--model_overrides", default=None,
                   help="default: the bundle config's overrides (a training run's "
                        "recorded config)")
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--mel_projection", type=float, default=None,
                   help="post-repair mel-consistency projection strength; "
                        "default auto (1.0 with a model, 0.0 heuristic)")
    p.add_argument("--batch", type=int, default=8, help="mels vocoded per device call")
    p.add_argument("--phase_impl", choices=["auto", "xla", "kernel"], default="auto",
                   help="G-L: 'auto' = the CUDA kernel on the card; 'xla' = the "
                        "matmul scan; 'kernel' = the kernel function (its plain "
                        "version on the CPU)")
    p.add_argument("--longform", action="store_true",
                   help="every input rides one fixed tile (Vocoder.vocode_longform)")
    p.add_argument("--longform_tile", type=int, default=1024,
                   help="longform tile frames (a multiple of the model chunk)")
    args = p.parse_args(argv)
    if args.aot and args.aot_export:
        p.error("--aot serves an existing artifact; it cannot be combined with --aot_export "
                "(export from --bundle/--train_dir)")
    if args.aot and args.longform:
        p.error("--longform needs the live Vocoder (AOT artifacts are fixed-shape by design)")
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P

    if args.aot:  # no model code: the artifact is self-contained
        from advoc_tpu_torch.infer.export import ExportedVocoder

        voc = ExportedVocoder(args.aot, device=args.device)
        print(f"[vocode] serving AOT artifacts {voc.shapes()} from {args.aot}", flush=True)
    else:
        voc = _live_vocoder(args, P)
    dev = voc.device

    # --- gather mels ---
    inp = pathlib.Path(args.input)
    if inp.suffix == ".npy":
        mels = np.load(inp)
        if mels.ndim == 2:
            mels = mels[None]
        names = [f"{inp.stem}_{i}" for i in range(len(mels))]
        mels = [np.asarray(m, np.float32) for m in mels]
    else:
        wav_paths = sorted(inp.rglob("*.wav")) if inp.is_dir() else [inp]
        mels, names = [], []
        for wp in wav_paths:
            wav = torch.tensor(audioio.decode_audio(wp, P.sample_rate), device=dev)
            mels.append(spectral.waveform_to_r9y9_melspec(wav, P).cpu().numpy())
            names.append(wp.stem)

    if args.aot_export:
        from advoc_tpu_torch.infer.export import export_vocoder

        shapes = sorted({(1, voc.bucket(m.shape[0])) for m in mels})
        man = export_vocoder(voc, shapes, args.aot_export,
                             allow_custom_calls=args.aot_allow_custom_calls)
        print(f"[vocode] exported {len(man['artifacts'])} artifact(s) {shapes} → "
              f"{args.aot_export}", flush=True)
        return {"files": 0, "audio_s": 0.0, "seconds": 0.0, "exported": man}
    return _vocode(args, voc, mels, names, P)


def _live_vocoder(args, P):
    """The Vocoder of --bundle, --train_dir or the heuristic pipeline."""
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.train.checkpoint import (
        generator_config,
        load_generator,
        load_train_generator,
    )

    generator = None
    if args.bundle:
        generator, conf = load_generator(args.bundle, args.model_size, args.model_overrides)
        cfg = generator.cfg
        print(f"[vocode] loaded bundle {args.bundle} (config {conf})", flush=True)
    elif args.train_dir:
        generator, step = load_train_generator(args.train_dir, args.model_size,
                                               args.model_overrides)
        cfg = generator.cfg
        print(f"[vocode] loaded checkpoint step {step} from {args.train_dir}", flush=True)
    else:
        cfg = generator_config({}, args.model_size, args.model_overrides)
        print("[vocode] no model given — heuristic pipeline", flush=True)
    return Vocoder(generator, params=P, chunk_frames=cfg.n_frames, gl_iters=args.gl_iters,
                   mel_projection=args.mel_projection, phase_impl=args.phase_impl,
                   device=args.device)


def _vocode(args, voc, mels: list, names: list, P) -> dict:
    """Vocode ``mels`` into --out_dir: one at a time (--longform, --aot,
    --batch 1 or a single input), else in --batch groups per length bucket."""
    from advoc_tpu_torch.data import audioio

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    hop = P.hop_length
    total_audio = 0.0

    def report(t_start: float, done_audio: float, what: str) -> dict:
        dt = time.perf_counter() - t_start
        print(f"[vocode] {done_audio:.1f}s audio in {dt:.2f}s after warmup ({what}) "
              f"→ {done_audio / dt:.0f}× realtime", flush=True)
        return {"files": len(mels), "audio_s": done_audio, "seconds": dt}

    if args.longform or args.aot or args.batch <= 1 or len(mels) == 1:
        # One input at a time (AOT artifacts are exported at batch 1); the
        # first call (warmup) stays out of the clock.
        t_start, t_audio0 = None, 0.0
        for mel, name in zip(mels, names):
            if args.longform:
                wav = voc.vocode_longform(mel, tile_frames=args.longform_tile)
            else:
                wav = voc(torch.from_numpy(mel)).cpu().numpy()
            if t_start is None:
                t_start, t_audio0 = time.perf_counter(), len(wav) / P.sample_rate
            total_audio += len(wav) / P.sample_rate
            audioio.save_as_wav(wav, out_dir / f"{name}.wav", P.sample_rate)
            print(f"[vocode] {name}.wav ({len(wav)} samples"
                  f"{', longform' if args.longform else ''})", flush=True)
        if len(mels) > 1:
            return report(t_start, total_audio - t_audio0,
                          f"one {args.longform_tile}-frame tile" if args.longform
                          else "one at a time")
        return {"files": len(mels), "audio_s": 0.0, "seconds": 0.0}

    # --batch > 1: group mels by bucketed length, pad every group to exactly
    # --batch rows (one shape per bucket), and read group k back while group
    # k+1 already runs on the card (the Vocoder returns without waiting;
    # rows are independent, so padded rows change nothing).
    order = sorted(range(len(mels)), key=lambda i: voc.bucket(mels[i].shape[0]))
    groups: list[list[int]] = []
    for i in order:
        tb = voc.bucket(mels[i].shape[0])
        if (groups and len(groups[-1]) < args.batch
                and voc.bucket(mels[groups[-1][0]].shape[0]) == tb):
            groups[-1].append(i)
        else:
            groups.append([i])

    def dispatch(idx):
        tb = voc.bucket(max(mels[i].shape[0] for i in idx))
        mb = np.zeros((args.batch, tb, P.n_mels), np.float32)
        for r, i in enumerate(idx):
            mb[r, : mels[i].shape[0]] = mels[i]
        return voc(torch.from_numpy(mb))  # (--batch, tb·hop) on the device

    def write(idx, out):
        nonlocal total_audio
        arr = out.cpu().numpy()  # waits; the NEXT group is already queued
        for r, i in enumerate(idx):
            n = mels[i].shape[0] * hop
            total_audio += n / P.sample_rate
            audioio.save_as_wav(arr[r, :n], out_dir / f"{names[i]}.wav", P.sample_rate)
            print(f"[vocode] {names[i]}.wav ({n} samples)", flush=True)

    # Warm every distinct length bucket before the clock starts.
    buckets = sorted({voc.bucket(m.shape[0]) for m in mels})
    for tb in buckets:
        voc(torch.zeros((args.batch, tb, P.n_mels))).cpu()  # .cpu() waits for the card
    print(f"[vocode] warmed {len(buckets)} length bucket(s): {buckets}", flush=True)

    t_start = time.perf_counter()
    pending = None
    for idx in groups:
        out = dispatch(idx)
        if pending is not None:
            write(*pending)
        pending = (idx, out)
    if pending is not None:
        write(*pending)
    return report(t_start, total_audio, f"{len(groups)} batched calls of {args.batch}")


if __name__ == "__main__":
    main()
