"""The readings the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --as program|control|<fault>
        [--seconds 2]

Runs the cell's driver once a seed in one process, with the program
(``program``), the plain reference computed one precision below the
configuration's in the program's place (``control``: float8 e4m3 with one
scale a tensor, for the configuration's bfloat16), or the program with a
fault planted under the timed path, and prints each run's compared numbers
as one JSON line. The limits in ``benchmark/workloads/<cell>.json`` lie between the largest
reading of the program over a dozen seeds or more and the smallest of the
control; ``benchmark/tests/test_bench_control.py`` holds both the control
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import run as bench  # noqa: E402
from reference import audio as ra, quant, vocoder as rv  # noqa: E402


class ControlVocoder:
    """The reference vocoder in the program's place, computed in ``q``."""

    def __init__(self, cfg: dict, sd: dict, dev, spans, q=quant.fp8):
        self.cfg, self.sd, self.dev, self.q = cfg, sd, dev, q
        self.a = ra.Audio(**cfg["audio"])
        self.keep, self.kept = False, None

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            rep, wav, _ = rv.vocode(torch.as_tensor(mel, device=self.dev), self.sd,
                                    self.cfg["model"], self.cfg["vocoder"], self.a, self.q)
        if self.keep:
            self.kept = rep
        return wav

    def close(self) -> None:
        pass


class Faulty:
    """The port's Vocoder with one fault planted where its answer is made."""

    def __init__(self, fault: str, cfg: dict, sd: dict, dev, spans):
        self.inner = bench.driver("offline").PortVocoder(cfg, sd, dev, spans)
        self.fault = fault
        if fault == "no_gl":  # the phase loop leaves its state as it came in
            self.inner.voc.gl_iters = 0
        if fault == "no_unet":  # the generator passes its input through
            gen = self.inner.voc.generator

            def identity(x):
                gen(x)
                return x

            self.inner.voc.generator = identity

    @property
    def keep(self):
        return self.inner.keep

    @keep.setter
    def keep(self, v):
        self.inner.keep = v

    @property
    def kept(self):
        return self.inner.kept

    @kept.setter
    def kept(self, v):
        self.inner.kept = v

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        out = self.inner(mel)
        if self.fault == "half_batch":  # the second half of the rows left out
            h = max(1, mel.shape[0] // 2)
            out = torch.cat([out[:h], out[:h]])[: mel.shape[0]]
        if self.fault == "altered_row":  # one answer altered where it is made
            out = out.clone()
            out[0] = out[0].flip(0)
        return out

    def close(self) -> None:
        self.inner.close()


# The faults the judge has to see.
FAULTS = ("no_gl", "no_unet", "half_batch", "altered_row")


def maker(kind: str):
    if kind == "program":
        return None
    if kind == "control":
        return lambda cfg, sd, dev, spans: ControlVocoder(cfg, sd, dev, spans)
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
        t0 = time.monotonic()
        res = bench.execute(args.workload, seed, args.seconds, False, args.device,
                            make=maker(args.kind), t0=t0)
        print(json.dumps({"as": args.kind, "workload": args.workload, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "metrics": res["metrics"],
                          "checks": {k: c["value"] for k, c in res["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
