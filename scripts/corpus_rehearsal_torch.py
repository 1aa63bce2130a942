#!/usr/bin/env python
"""Corpus-scale dress rehearsal on the PyTorch port, at LJSpeech's shape.

The port's copy of ``scripts/corpus_rehearsal.py``. It synthesizes an
LJSpeech-shaped corpus — 13,100 PCM16 wavs at 22.05 kHz with the LJ
duration distribution (~1–10 s, mean ≈ 6.5 s, ≈ 24 h total); the same seed
gives the same files, bit for bit, as the JAX script's — then runs the
production workflow end to end:

  1. ``scripts/prepare_dataset_torch.py`` over the files (metadata scan,
     peak checks, train/eval split lists) — timed.
  2. ``python -m advoc_tpu_torch.models.advoc.train_evaluate --mode train``
     for ``--max_steps`` steps — steps/s per window, checkpoint cadence and
     stability are read from the live log.
  3. ``--mode eval`` polling the same train_dir CONCURRENTLY, on the same
     card (a CUDA card is shared between processes; the JAX script put the
     eval on the CPU because its training process held the TPU chip
     exclusively), exiting on its own once checkpoints stop appearing.
     Checkpoints appear by rename once written, so it never reads a
     half-written step.
  4. A summary report: steps/s distribution, checkpoint sizes, loader scan
     time.

Usage:
  python scripts/corpus_rehearsal_torch.py --corpus_dir runs/lj_shaped \
      --train_dir runs/r3_corpus --max_steps 10000
Corpus generation is resumable (existing files are kept); pass
``--n_files 0`` to reuse a corpus without checking it file by file. Runs
on the card; ``--device cpu`` runs every stage on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np

CLI = "advoc_tpu_torch.models.advoc.train_evaluate"


def make_corpus(out_dir: pathlib.Path, n_files: int, sample_rate: int,
                seed: int) -> None:
    """LJSpeech-shaped synthetic corpus: durations from a clipped lognormal
    matched to LJ's ~(1.1 s min, 10.1 s max, 6.57 s mean)."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech

    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    made = 0
    for i in range(n_files):
        p = out_dir / f"LJS{i // 1000:03d}-{i % 1000:04d}.wav"
        if p.exists():
            continue
        dur = float(np.clip(rng.lognormal(mean=1.82, sigma=0.35), 1.1, 10.1))
        wav = synthetic_speech(seed * 100003 + i, int(dur * sample_rate), sample_rate)
        audioio.save_as_wav(wav, p, sample_rate)
        made += 1
        if made % 1000 == 0:
            rate = made / (time.perf_counter() - t0)
            print(f"[corpus] {made} files written ({rate:.0f}/s)", flush=True)
    print(f"[corpus] {n_files} files ready in {out_dir} "
          f"({time.perf_counter() - t0:.0f}s this run)", flush=True)


def child_env() -> dict:
    """The environment of a stage: this one, with the repository first on
    PYTHONPATH so ``python -m advoc_tpu_torch…`` resolves in any cwd."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def main(argv=None) -> None:
    tmp = pathlib.Path(tempfile.gettempdir())
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--corpus_dir", default=str(tmp / "lj_shaped"))
    ap.add_argument("--train_dir", default=str(tmp / "r3_corpus"))
    ap.add_argument("--n_files", type=int, default=13100)
    ap.add_argument("--max_steps", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--ckpt_every", type=int, default=1000)
    ap.add_argument("--sample_rate", type=int, default=22050)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_make", action="store_true")
    ap.add_argument("--skip_eval", action="store_true",
                    help="skip the concurrent eval poller")
    ap.add_argument("--model_overrides", default=None,
                    help="comma-separated AdvocConfig overrides for train and eval")
    ap.add_argument("--device", default="cuda",
                    help="device of train and eval (default cuda; they raise without a card)")
    args = ap.parse_args(argv)

    corpus = pathlib.Path(args.corpus_dir)
    train_dir = pathlib.Path(args.train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)

    if not args.skip_make and args.n_files:
        make_corpus(corpus, args.n_files, args.sample_rate, args.seed)

    # 1. Dataset prep (metadata scan + split lists), timed.
    prep_dir = train_dir / "prep"
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).parent / "prepare_dataset_torch.py"),
         "--in_dir", str(corpus), "--out_dir", str(prep_dir), "--eval_fraction", "0.01"],
        check=True, capture_output=True, env=child_env(),
    )
    prep_s = time.perf_counter() - t0
    train_list = prep_dir / "train_files.txt"
    eval_list = prep_dir / "eval_files.txt"
    n_train = len(train_list.read_text().splitlines())
    n_eval = len(eval_list.read_text().splitlines())
    print(f"[rehearsal] prepare_dataset over {n_train + n_eval} files: "
          f"{prep_s:.1f}s (train {n_train} / eval {n_eval})", flush=True)

    # 2+3. Training with a concurrent checkpoint-polling eval on the same device.
    cli = [sys.executable, "-u", "-m", CLI]
    model = ["--device", args.device]
    if args.model_overrides:
        model += ["--model_overrides", args.model_overrides]
    t_train0 = time.perf_counter()
    with open(train_dir / "train.log", "w") as train_log:
        train_p = subprocess.Popen(
            cli + ["--mode", "train", "--train_dir", str(train_dir),
                   "--data_dir", str(train_list), "--batch_size", str(args.batch_size),
                   "--max_steps", str(args.max_steps), "--ckpt_every", str(args.ckpt_every),
                   "--log_every", "100", *model],
            stdout=train_log, stderr=subprocess.STDOUT, env=child_env(),
        )
    eval_p = None
    if not args.skip_eval:
        with open(train_dir / "eval.log", "w") as eval_log:
            eval_p = subprocess.Popen(
                cli + ["--mode", "eval", "--train_dir", str(train_dir),
                       "--data_dir", str(eval_list), "--batch_size", "16",
                       "--eval_timeout_s", "240", *model],
                stdout=eval_log, stderr=subprocess.STDOUT, env=child_env(),
            )
    rc = train_p.wait()
    train_s = time.perf_counter() - t_train0
    if rc != 0:
        if eval_p is not None:
            eval_p.kill()
            eval_p.wait()
        print((train_dir / "train.log").read_text()[-4000:])
        sys.exit(f"training failed rc={rc}")
    if eval_p is not None:
        print("[rehearsal] training done; waiting for eval to drain", flush=True)
        rc_e = eval_p.wait()
        if rc_e != 0:
            print((train_dir / "eval.log").read_text()[-4000:])
            sys.exit(f"eval failed rc={rc_e}")

    # 4. Report.
    log = (train_dir / "train.log").read_text()
    rates = [float(m) for m in re.findall(r"\(([\d.]+) steps/s\)", log)]
    steady = rates[1:] or rates  # window 1 includes the first step's start-up
    ckpts = sorted(int(p.name) for p in train_dir.iterdir() if p.name.isdigit())
    ckpt_mb = (
        sum(f.stat().st_size for f in (train_dir / str(ckpts[-1])).rglob("*")
            if f.is_file()) / 1e6 if ckpts else 0.0
    )
    eval_log = (train_dir / "eval.log").read_text() if eval_p else ""
    eval_rows = re.findall(r"\[eval\] ckpt (\d+): (.*)", eval_log)

    def stat(fn):
        return round(float(fn(steady)), 2) if steady else None

    report = {
        "n_files": n_train + n_eval,
        "prepare_dataset_s": round(prep_s, 1),
        "max_steps": args.max_steps,
        "train_wall_s": round(train_s, 1),
        "steps_per_s_median": stat(np.median),
        "steps_per_s_min": stat(np.min),
        "steps_per_s_max": stat(np.max),
        "steps_per_s_first_windows": [round(r, 2) for r in steady[:5]],
        "steps_per_s_last_windows": [round(r, 2) for r in steady[-5:]],
        "checkpoints": ckpts,
        "checkpoint_mb": round(ckpt_mb, 1),
        "eval_ckpts_scored": [int(s) for s, _ in eval_rows],
        "eval_last": eval_rows[-1][1] if eval_rows else None,
    }
    print("[rehearsal] " + json.dumps(report, indent=2), flush=True)


if __name__ == "__main__":
    main()
