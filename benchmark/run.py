"""The benchmark of ``advoc_tpu_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: ``benchmark/workloads/<cell>.json``
names its configuration (``benchmark/configs/<config>.json``), its traffic
mix (read by :mod:`traffic`) and its driver (``benchmark/drivers/<driver>.py``),
which builds the program, warms every shape the cell uses, measures for
``--seconds`` and judges the outputs against the plain reference
(``benchmark/reference``). With ``--trace 0`` the result line carries the
cell's end-to-end metrics; with ``--trace 1`` the window is traced and the
line carries the per-layer metrics (``benchmark/metrics/<metric>.py``, each
a reader of the traced run). Logs go to standard error, ending with each
number compared beside its limit; the last line of standard output is the
result. Exits non-zero, printing no result, without the card the cell asks
for, or if JAX or the JAX package is loaded.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import common  # noqa: E402


def driver(name: str):
    path = HERE / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> tuple[dict, dict, dict]:
    """(the BENCHMARK.json entry, the workload file, the config file) of
    ``name``."""
    entry = next((w for w in common.bench_entry()["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"benchmark: BENCHMARK.json lists no cell named {name!r}")
    wl = common.load("workloads", name)
    if (entry["config"], entry["chips"]) != (wl["config"], wl["chips"]):
        raise SystemExit(f"benchmark: {name}: BENCHMARK.json and its workload file disagree")
    return entry, wl, common.load("configs", entry["config"])


def profiler_for(trace: bool, dev: torch.device):
    if not trace:
        return contextlib.nullcontext
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return lambda: profile(activities=acts)


def listing(kind: str, name: str) -> list[dict]:
    """The metrics of BENCHMARK.json's ``kind`` that the cell reports."""
    return [m for m in common.bench_entry()[kind] if name in m.get("workloads", [name])]


def end_to_end(name: str, measured: dict) -> dict:
    """The cell's end-to-end metrics, each the driver's reading of its
    quantity."""
    return {m["name"]: {"value": measured[common.quantity(m["name"])], "unit": m["unit"]}
            for m in listing("end_to_end", name)}


def per_layer(name: str, run: dict) -> dict:
    """The cell's per-layer metrics, each read by its own reader; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in listing("per_layer", name):
        v = common.metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            make=None, t0: float | None = None) -> dict:
    """One run: returns the result line's dict (and logs the checks). Tests
    call it with ``device="cpu"`` and ``make``, a program that stands in."""
    entry, wl, cfg = cell(workload)
    dev = common.device_of(device, entry["chips"])
    seed %= 2**63  # numpy's and torch's generators take non-negative seeds
    if dev.type == "cuda":
        common.pin()
        common.log(f"[bench] {workload} seed {seed}: {torch.cuda.get_device_name(dev)}; "
                   f"nvidia-smi: {common.power_limit()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = {"config": cfg, "workload": wl, "device": dev, "seed": seed, "seconds": seconds,
           "trace": trace, "t0": T0 if t0 is None else t0, "spans": common.Spans(trace, dev),
           "profiler": profiler_for(trace, dev)}
    drv = driver(wl["driver"])
    out = drv.run(ctx) if make is None else drv.run(ctx, make)
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = per_layer(workload, out["run"]) if trace else end_to_end(workload, out["metrics"])
    res = common.result(correct, out["attempted"], out["failed"], metrics, dev, entry["chips"],
                        out["memory_peak_bytes"], checks, out["run"].get("trace"))
    for k, c in checks.items():
        common.log(f"{k} {c['value']} limit {c['limit']}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = common.loaded_forbidden()
    if bad:
        common.log(f"benchmark: the run loaded {bad}; no result")
        raise SystemExit(3)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
