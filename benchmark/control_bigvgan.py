"""The readings the limit of the BigVGAN cell's ``correct`` is set from, on
the card: ``control_generate.py``'s counterpart for the ``bigvgan`` driver.

    python3 benchmark/control_bigvgan.py --workload bigvgan-22khz-80band.ljspeech-b8
        --seeds 1,2,3 --as program|control|<fault> [--seconds 2]

Runs the cell once a seed in one process, with the program (``program``),
the plain reference computed one precision below the configuration's in
the program's place (``control``: float8 e4m3 with one scale a tensor, for
the configuration's bfloat16 convolutions), or the program with a fault
planted where its answer is made, and prints each run's compared numbers as
one JSON line. The limit in the cell's workload file lies between the
largest reading of the program over a dozen seeds or more and the smallest
of the control; ``benchmark/tests/test_bench_bigvgan.py`` holds the control
and the faults at a size a test run holds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import run as bench  # noqa: E402
from reference import bigvgan as rb, quant  # noqa: E402


class ControlBigVGAN:
    """The reference generator in the program's place, computed in ``q``."""

    def __init__(self, cfg: dict, sd: dict, dev, spans, q=quant.fp8):
        self.model, self.sd, self.q = cfg["model"], sd, q
        self.taps = rb.kaiser_sinc().to(dev)

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return rb.generate(mel, self.sd, self.model, self.q, self.taps)

    def close(self) -> None:
        pass


def snake_beta(x, log_alpha, log_beta, *filters):
    """SnakeBeta without the resampling around it."""
    y = x.float()
    y = y + torch.sin(y * log_alpha.exp()[:, None]) ** 2 / (log_beta.exp()[:, None] + 1e-9)
    return y.to(x.dtype)


class Faulty:
    """The port's BigVGAN with one fault planted where its answer is made."""

    def __init__(self, fault: str, cfg: dict, sd: dict, dev, spans):
        self.inner = bench.driver("bigvgan").PortBigVGAN(cfg, sd, dev, spans)
        self.fault, self.last = fault, None
        self.restore = None
        if fault == "no_aa":  # the activations skip the ×2 resampling
            from advoc_tpu_torch.models.bigvgan import model

            self.restore = (model, model.aa_snake_beta)
            model.aa_snake_beta = snake_beta

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        if self.fault == "stale_mel":  # answered from the previous call's mels
            mel, self.last = (mel if self.last is None else self.last), mel
        out = self.inner(mel)
        if self.fault == "half_batch":  # the second half of the rows left out
            h = max(1, mel.shape[0] // 2)
            out = torch.cat([out[:h], out[:h]])[: mel.shape[0]]
        if self.fault == "altered_row":  # one answer altered where it is made
            out = out.clone()
            out[0] = out[0].flip(0)
        return out

    def close(self) -> None:
        if self.restore is not None:
            mod, fn = self.restore
            mod.aa_snake_beta = fn
        self.inner.close()


# The faults the judge has to see.
FAULTS = ("no_aa", "half_batch", "altered_row", "stale_mel")


def maker(kind: str):
    if kind == "program":
        return None
    if kind == "control":
        return ControlBigVGAN
    if kind in FAULTS:
        return lambda cfg, sd, dev, spans: Faulty(kind, cfg, sd, dev, spans)
    raise SystemExit(f"unknown --as {kind!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="kind", default="control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = bench.execute(args.workload, seed, args.seconds, False, args.device,
                            make=maker(args.kind), t0=time.monotonic())
        print(json.dumps({"as": args.kind, "workload": args.workload, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "metrics": res["metrics"],
                          "checks": {k: c["value"] for k, c in res["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
