#!/usr/bin/env python
"""One-command corpus runbook on the PyTorch port: prepare → train (+
concurrent eval) → bundle → panel → AOT export → kernel build → serve
selftest.

The port's copy of ``scripts/run_corpus.py``, with the same flags and
result line. Point ``--corpus_dir`` at a directory of wavs and every
production stage runs in order, each a child process that runs only the
port, timed and logged under ``<run_dir>/logs/``, with ONE machine-readable
summary line (``RUN_CORPUS_RESULT {...}``) and a non-zero exit on the first
failure.

  python scripts/run_corpus_torch.py --corpus_dir /data/LJSpeech-1.1/wavs \
      --run_dir runs/lj --max_steps 10000

No corpus? ``--synthetic 13100`` first synthesizes the LJ-shaped rehearsal
corpus (same duration distribution; see ``corpus_rehearsal_torch.py``) and
then runs the identical workflow.

Stages (each skippable with --skip_<stage> for a partial re-run):
  1. prep   scripts/prepare_dataset_torch.py — scan/validate, train/eval split
  2. train  python -m advoc_tpu_torch.models.advoc.train_evaluate --mode train
            (the corpus in the card's memory when it fits: --data_placement
            auto), with the checkpoint-polling --mode eval running
            CONCURRENTLY on the same card (a CUDA card is shared between
            processes; the JAX runbook put this eval on the CPU only because
            its training process held the TPU chip exclusively)
  3. bundle the inference bundle from the final checkpoint (on the CPU)
  4. panel  scripts/stress_eval_torch.py — offline stress/STOI panel through
            the trained generator (the tensor-core G-L kernel on the card)
  5. aot    vocode_cli --aot_export — fixed-shape serving artifacts
  6. build  compile the port's CUDA kernel libraries (ops/kernels/_build.py),
            so that serving starts warm; the counterpart of the JAX runbook's
            compile-cache warmup (--skip_precompile is accepted for
            --skip_build). With --cpu there is nothing to build: the stage is
            reported as skipped, with the reason, in the result line.
  7. serve  python -m advoc_tpu_torch.serve --selftest — end-to-end TCP check

Runs on the card and raises without one; ``--cpu`` passes ``--device cpu``
to every stage that takes a device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(SCRIPTS))

from corpus_rehearsal_torch import child_env, make_corpus  # noqa: E402

STAGES = ("prep", "train", "bundle", "panel", "aot", "build", "serve")

# The bundle stage's child: the final checkpoint's generator, written as a
# port bundle on the CPU (argv: train_dir, bundle_dir, model_size, overrides).
_BUNDLE = """
import sys
from advoc_tpu_torch.train.checkpoint import export_inference_bundle, load_train_generator
train_dir, bundle_dir, size, overrides = sys.argv[1:5]
size, overrides = size or None, overrides or None
g, step = load_train_generator(train_dir, size, overrides)
export_inference_bundle(bundle_dir, g.state_dict(),
                        dict(model_size=size or "full", overrides=overrides))
print(f"bundle of step {step} -> {bundle_dir}")
"""

# The build stage's child: one nvcc per kernel source, all at once.
_BUILD = """
import time
from concurrent.futures import ThreadPoolExecutor
from advoc_tpu_torch.ops.kernels import _build
names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
t0 = time.perf_counter()
with ThreadPoolExecutor(len(names)) as pool:
    paths = list(pool.map(_build.build, names))
for p in paths:
    print(f"built {p.name}")
print(f"BUILD_RESULT {len(names)} libraries in {time.perf_counter() - t0:.1f} s")
"""


def log(msg: str) -> None:
    print(f"[run_corpus] {msg}", flush=True)


def main(argv=None) -> dict:
    """Returns the result line's dict; exits non-zero on a failed stage."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus_dir", required=True,
                   help="directory of wavs (created if --synthetic)")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--synthetic", type=int, default=0, metavar="N_FILES",
                   help="synthesize an LJ-shaped corpus of N files first")
    p.add_argument("--model_size", choices=["full", "small"], default="full")
    p.add_argument("--model_overrides", default=None)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=100,
                   help="training log window (steps/s is read from each window)")
    p.add_argument("--eval_fraction", type=float, default=0.01)
    p.add_argument("--eval_timeout_s", type=float, default=1200.0,
                   help="concurrent eval: exit after this long with no new checkpoint")
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--serve_clients", type=int, default=4)
    p.add_argument("--cpu", action="store_true",
                   help="every stage on the CPU (--device cpu)")
    for s in STAGES:
        p.add_argument(f"--skip_{s}", action="store_true")
    p.add_argument("--skip_precompile", dest="skip_build", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_corpus_torch runs on the card by default and no CUDA device "
                           "is present; pass --cpu to run every stage on the CPU")

    run_dir = pathlib.Path(args.run_dir)
    logs = run_dir / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    corpus = pathlib.Path(args.corpus_dir)
    train_dir = run_dir / "train"
    prep_dir = run_dir / "prep"
    bundle_dir = run_dir / "bundle"
    aot_dir = run_dir / "aot"
    env = child_env()

    model_flags = ["--model_size", args.model_size]
    if args.model_overrides:
        model_flags += ["--model_overrides", args.model_overrides]
    dev_flags = ["--device", device]

    stages: dict[str, float] = {}
    summary: dict[str, object] = {"device": device}

    def stage(name: str, cmd: list) -> pathlib.Path:
        """Run one stage to completion, its output into logs/<name>.log."""
        t0 = time.perf_counter()
        logf = logs / f"{name}.log"
        log(f"stage {name}: {' '.join(map(str, cmd))}")
        with open(logf, "w") as f:
            rc = subprocess.run([str(c) for c in cmd], stdout=f, stderr=subprocess.STDOUT,
                                env=env).returncode
        stages[name] = round(time.perf_counter() - t0, 1)
        if rc != 0:
            print(logf.read_text()[-4000:])
            sys.exit(f"[run_corpus] stage {name} FAILED rc={rc} (log: {logf})")
        log(f"stage {name}: done in {stages[name]}s")
        return logf

    py = [sys.executable, "-u"]

    # 0. Optional synthetic corpus (the rehearsal path).
    if args.synthetic:
        from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P

        t0 = time.perf_counter()
        make_corpus(corpus, args.synthetic, P.sample_rate, seed=0)
        stages["synthesize"] = round(time.perf_counter() - t0, 1)

    # 1. Dataset prep: scan, validate, split (host only).
    if not args.skip_prep:
        stage("prep", py + [SCRIPTS / "prepare_dataset_torch.py",
                            "--in_dir", corpus, "--out_dir", prep_dir,
                            "--eval_fraction", args.eval_fraction])
    train_list = prep_dir / "train_files.txt"
    eval_list = prep_dir / "eval_files.txt"

    # 2. Train, with the checkpoint-polling eval concurrent on the same device.
    # A checkpoint appears by rename once it is written, so the eval never
    # reads a half-written step.
    cli = py + ["-m", "advoc_tpu_torch.models.advoc.train_evaluate"]
    if not args.skip_train:
        t0 = time.perf_counter()
        train_log, eval_log = logs / "train.log", logs / "eval.log"
        log("stage train (+ concurrent eval)")
        with open(train_log, "w") as tf, open(eval_log, "w") as ef:
            train_p = subprocess.Popen(
                [str(c) for c in cli] +
                ["--mode", "train", "--train_dir", str(train_dir),
                 "--data_dir", str(train_list), "--batch_size", str(args.batch_size),
                 "--max_steps", str(args.max_steps), "--ckpt_every", str(args.ckpt_every),
                 "--log_every", str(args.log_every), "--data_placement", "auto", *model_flags, *dev_flags],
                stdout=tf, stderr=subprocess.STDOUT, env=env,
            )
            eval_p = subprocess.Popen(
                [str(c) for c in cli] +
                ["--mode", "eval", "--train_dir", str(train_dir),
                 "--data_dir", str(eval_list), "--batch_size", "16",
                 "--eval_timeout_s", str(args.eval_timeout_s), *model_flags, *dev_flags],
                stdout=ef, stderr=subprocess.STDOUT, env=env,
            )
            rc = train_p.wait()
            stages["train"] = round(time.perf_counter() - t0, 1)
            if rc != 0:
                eval_p.kill()
                eval_p.wait()
                print(train_log.read_text()[-4000:])
                sys.exit(f"[run_corpus] stage train FAILED rc={rc}")
            log("train done; draining concurrent eval")
            rc_e = eval_p.wait()
        stages["eval_drain"] = round(time.perf_counter() - t0 - stages["train"], 1)
        if rc_e != 0:
            print(eval_log.read_text()[-4000:])
            sys.exit(f"[run_corpus] concurrent eval FAILED rc={rc_e}")
        rates = [float(m) for m in
                 re.findall(r"\(([\d.]+) steps/s\)", train_log.read_text())]
        summary["steps_per_s_median"] = (
            round(float(sorted(rates[1:])[len(rates[1:]) // 2]), 2)
            if len(rates) > 1 else None
        )
        summary["steps_per_s_windows"] = rates
        ev = re.findall(r"\[eval\] ckpt (\d+): (.*)", eval_log.read_text())
        summary["eval_last"] = ev[-1][1] if ev else None
        if not ev:
            log("WARNING: concurrent eval evaluated NOTHING "
                "(no checkpoint within --eval_timeout_s?)")

    # 3. Inference bundle from the final checkpoint, on the CPU: a restore and
    # a write, no reason to hold the card.
    if not args.skip_bundle:
        stage("bundle", py + ["-c", _BUNDLE, train_dir, bundle_dir,
                              args.model_size, args.model_overrides or ""])

    # 4. Stress/STOI quality panel through the trained generator.
    if not args.skip_panel:
        logf = stage("panel", py + [SCRIPTS / "stress_eval_torch.py",
                                    "--train_dir", train_dir, "--gl_iters", args.gl_iters,
                                    *model_flags, *dev_flags])
        summary["panel_tail"] = logf.read_text().strip().splitlines()[-8:]

    # 5. AOT serving artifacts (the production shape, from a probe mel).
    if not args.skip_aot:
        import numpy as np

        probe = run_dir / "probe_mels.npy"
        np.save(probe, np.zeros((1, 256, 80), np.float32))
        # The artifact records the port's kernels (advoc:: operators) on the
        # card, and serves where they are registered.
        stage("aot", py + ["-m", "advoc_tpu_torch.infer.vocode_cli",
                           "--input", probe, "--out_dir", run_dir / "aot_out",
                           "--bundle", bundle_dir, "--aot_export", aot_dir,
                           "--aot_allow_custom_calls", "--gl_iters", args.gl_iters,
                           *model_flags, *dev_flags])

    # 6. The kernel libraries, built before serving.
    if not args.skip_build:
        if device == "cpu":
            summary["build"] = {"skipped": "--cpu: no CUDA kernel runs on the CPU "
                                           "(each kernel's plain version does)"}
            log("stage build: skipped (--cpu)")
        else:
            logf = stage("build", py + ["-c", _BUILD])
            m = re.search(r"BUILD_RESULT (.*)", logf.read_text())
            summary["build"] = {"built": m.group(1) if m else None}

    # 7. End-to-end TCP serving selftest against the trained bundle.
    if not args.skip_serve:
        logf = stage("serve", py + ["-m", "advoc_tpu_torch.serve",
                                    "--selftest", args.serve_clients, "--pushes", "6",
                                    "--bundle", bundle_dir, *model_flags, *dev_flags])
        m = re.search(r"VOCODE_SERVER_RESULT (\{.*\})", logf.read_text())
        summary["serve"] = json.loads(m.group(1)) if m else None

    summary["stages_s"] = stages
    summary["ok"] = True
    print("RUN_CORPUS_RESULT " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
