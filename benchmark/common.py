"""What every driver of the benchmark shares: the cell's files by name, the
device's description, the spans the traced run records, the reduction of a
``torch.profiler`` trace, and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "advoc_tpu")
SPAN_PREFIX = "bench."


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"benchmark: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def bench_entry() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def quantity(name: str) -> str:
    """What a metric measures: ``unet_ms.lj`` is the quantity ``unet_ms`` in
    the cells that its entry lists (one quantity split by the end-to-end
    metric that its cells report)."""
    return name.split(".")[0]


def metric_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``, or, where
    there is no such file, that of its quantity's."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_of(name: str, chips: int) -> torch.device:
    """The card, or exit non-zero: the benchmark measures nothing else."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: needs {chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda:0")


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - a description only
        return f"nvidia-smi unavailable ({e!r})"


CORES = sorted(os.sched_getaffinity(0))  # the cores the process started on


def pin() -> None:
    """Keep this thread, and the threads it starts, on the first half of the
    cores the process started on: the same cores in every run, which halves
    the spread of a host-bound cell's rate (PERF.md)."""
    os.sched_setaffinity(0, CORES[: len(CORES) // 2])


class Reservoir:
    """Seeded reservoir sampling of up to ``k`` items of a stream."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self) -> int | None:
        """The slot the next item takes, or None if it is not kept."""
        n, self.n = self.n, self.n + 1
        if n < self.k:
            self.items.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """The benchmark's spans around calls into the program's layers. Off (the
    timed runs) they cost nothing; on (``--trace 1``) each span is a
    ``record_function`` range in the profiler's trace and, for the layers a
    metric times, a pair of CUDA events."""

    def __init__(self, on: bool, dev: torch.device):
        self.on, self.dev = on and dev.type == "cuda", dev
        self.events: dict[str, list] = {}
        self.host: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str, timed: bool = False):
        """A span on any thread: its host times (µs of the wall clock, which
        the profiler's events share up to an offset that the ``window``
        span, recorded both ways, gives) and, where ``timed``, CUDA events."""
        if not self.on:
            yield
            return
        t0 = time.time_ns() / 1e3
        with torch.profiler.record_function(SPAN_PREFIX + name):
            if timed:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                yield
                b.record()
                self.events.setdefault(name, []).append((a, b))
            else:
                yield
        self.host.append((name, t0, time.time_ns() / 1e3))

    def device_ms(self, name: str) -> list[float]:
        sync(self.dev)
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]

    def reset(self) -> None:
        self.events, self.host = {}, []


def reduce_trace(prof, spans_: Spans) -> dict:
    """Device busy time, the top device operations and the longest idle gaps
    (named by the benchmark span the host was in when each began), from a
    profiler over its ``window`` span. The spans are the benchmark's own
    host records (the profiler keeps ranges of the thread that started it
    only), moved onto the profiler's clock by the ``window`` span that both
    hold."""
    dev_ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        d = e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                continue
            dev_ops.append((name, s, s + d))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, s + d, e.start_thread_id()))
    window = [(s, e) for n, s, e, _ in spans if n == "window"]
    mine = [(s, e) for n, s, e in spans_.host if n == "window"]
    if len(window) != 1 or len(mine) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans, not one")
    shift = window[0][0] - mine[0][0]
    spans = [(n, s + shift, e + shift, 0) for n, s, e in spans_.host]
    out = summarize(dev_ops, spans, *window[0])
    log(f"[bench] trace: {len(dev_ops)} device ops, {len(spans)} spans")
    return out


def summarize(dev_ops, spans, t0: float, t1: float) -> dict:
    """The reduction of :func:`reduce_trace` on plain lists: device ops
    (name, start, end) and spans (name, start, end, thread), all in µs."""
    ops = sorted((max(s, t0), min(e, t1), n) for n, s, e in dev_ops if e > t0 and s < t1)
    busy, gaps, by_name = 0.0, [], {}
    cur_s = cur_e = None
    last_end = t0
    for s, e, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1 > last_end:
        gaps.append((last_end, t1))

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
    gap_names: dict[str, float] = {}
    for (s, e), k in zip(gaps, _innermost([g[0] for g in gaps], spans)):
        gap_names[k or "outside"] = gap_names.get(k or "outside", 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "device_ops": [[n, v / 1e6] for n, v in top],
        "idle_gaps": [[n, v / 1e6] for n, v in
                      sorted(gap_names.items(), key=lambda kv: -kv[1])[:10]],
    }


def result(correct: bool, attempted: int, failed: int, metrics: dict, dev: torch.device,
           chips: int, memory_peak: int, checks: dict, trace: dict | None = None) -> dict:
    """The result line's dict; ``checks`` (each number compared beside its
    limit) comes last."""
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"], device["window_s"] = trace["busy_s"], trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    out["checks"] = checks
    return out


def _innermost(times: list[float], spans: list) -> list:
    """For each of ``times``: the name of the latest-started span open at that
    time (None outside every span), by one sweep over the sorted span edges."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    edges = sorted([(s, 1, i) for i, (_, s, e, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, s, e, _) in enumerate(spans)])
    out: list = [None] * len(times)
    open_: dict[int, float] = {}
    j = 0
    for k in order:
        t = times[k]
        while j < len(edges) and (edges[j][0] < t or (edges[j][0] == t and edges[j][1] == 1)):
            _, is_open, i = edges[j]
            if is_open:
                open_[i] = (spans[i][1], -spans[i][2])
            else:
                open_.pop(i, None)
            j += 1
        out[k] = spans[max(open_, key=open_.get)][0] if open_ else None
    return out
