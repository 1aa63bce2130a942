#!/usr/bin/env python
"""Dataset preparation on the PyTorch port: validate, resample and split wavs.

The port's copy of ``scripts/prepare_dataset.py``, with the same flags and
the same split: ``random.Random(seed)`` shuffles the kept files, so one
corpus and one seed give the same ``train_files.txt`` and
``eval_files.txt`` from either script, line for line.

LJSpeech workflow:
  1. Download + extract LJSpeech-1.1 (https://keithito.com/LJ-Speech-Dataset/)
     — 13,100 wavs at 22050 Hz mono (no resampling needed).
  2. python scripts/prepare_dataset_torch.py --in_dir LJSpeech-1.1/wavs \
         --out_dir data/ljspeech --eval_fraction 0.01

For arbitrary wav corpora the script decodes through the port's codec
(``advoc_tpu_torch.data.audioio``), resamples to the target rate,
peak-checks, rewrites as 16-bit PCM, and emits train/eval file lists. The
work is host-only: no device is touched.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--eval_fraction", type=float, default=0.01)
    p.add_argument("--min_seconds", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--copy", action="store_true",
                   help="rewrite wavs into out_dir (default: only lists, "
                        "rewriting only files that need resampling)")
    args = p.parse_args(argv)

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.utils.config import find_wavs

    fps = find_wavs(args.in_dir)
    if not fps:
        sys.exit(f"no wavs under {args.in_dir!r}")
    out = pathlib.Path(args.out_dir)
    (out / "wavs").mkdir(parents=True, exist_ok=True)

    kept: list[str] = []
    skipped = 0
    for fp in fps:
        try:
            n, sr = audioio.wav_num_frames(fp)
        except Exception as e:
            print(f"[prep] skip {fp}: {e}")
            skipped += 1
            continue
        if n / sr < args.min_seconds:
            skipped += 1
            continue
        if args.copy or sr != args.sample_rate:
            x = audioio.decode_audio(fp, target_sample_rate=args.sample_rate)
            if float(np.abs(x).max()) == 0.0:
                skipped += 1
                continue
            dst = out / "wavs" / pathlib.Path(fp).name
            audioio.save_as_wav(x, dst, args.sample_rate)
            kept.append(str(dst))
        else:
            kept.append(fp)

    rng = random.Random(args.seed)
    rng.shuffle(kept)
    n_eval = max(1, int(len(kept) * args.eval_fraction))
    eval_fps, train_fps = kept[:n_eval], kept[n_eval:]
    (out / "train_files.txt").write_text("\n".join(sorted(train_fps)) + "\n")
    (out / "eval_files.txt").write_text("\n".join(sorted(eval_fps)) + "\n")
    print(f"[prep] {len(train_fps)} train / {len(eval_fps)} eval wavs "
          f"({skipped} skipped) → {out}")


if __name__ == "__main__":
    main()
