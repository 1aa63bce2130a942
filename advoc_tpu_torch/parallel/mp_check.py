"""Executable multi-process data-parallel check.

The port of ``advoc_tpu.parallel.mp_check``. It spawns N ranks in one
process group (:func:`advoc_tpu_torch.parallel.distributed.launch`), each
taking its rows of one global batch through one advoc GAN step
(``train.gan.data_parallel``: gradients averaged by an all-reduce before
each Adam step, metrics averaged), then runs the same step as one process
on the whole batch, and compares the metrics and the updated parameters'
norms. Every rank must also agree with every other.

    python -m advoc_tpu_torch.parallel.mp_check [--backend gloo|nccl]
        [--device cpu|cuda] [--num_processes N] [--config tiny|full]
        [--timed_steps K]

prints one ``MP_CHECK_RESULT {...}`` JSON line and exits 1 on a mismatch;
:func:`run_check` is the same as a library call. On ``cuda`` rank i runs
on card i mod the visible cards, so gloo can put two ranks on one card
(NCCL cannot). ``--config full`` takes ``AdvocConfig()``'s widths (45.6 M
parameters with the discriminator); ``--timed_steps K`` also times K more
steps and K all-reduces of the gradients' size on every rank.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# The one workload both sides run: a seeded advoc GAN step on a global
# batch of 8 synthetic clips (the JAX check's shapes at "tiny").
_GLOBAL_BATCH = 8
CONFIGS = {
    "tiny": dict(n_frames=64, width=8, depth=4, disc_width=8, dtype="float32"),
    "full": dict(),
}


def _setup(config: str, device: torch.device, group):
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS
    from advoc_tpu_torch.train import gan

    cfg = AdvocConfig(**CONFIGS[config])
    g, d = AdvocGenerator(cfg).to(device), PatchDiscriminator(cfg).to(device)
    gstate, dstate = gan.make_states(g, d, seed=0, group=group)
    length = cfg.n_frames * DEFAULT_PARAMS.hop_length
    wav = torch.tensor(np.stack([synthetic_speech(i, length) for i in range(_GLOBAL_BATCH)]),
                       device=device)
    step = gan.make_advoc_train_step(g, d, cfg, DEFAULT_PARAMS)
    step = gan.data_parallel(step)
    return gstate, dstate, wav, step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(config: str, timed_steps: int, group, device: torch.device) -> dict:
    """One step (plus ``timed_steps`` timed ones) on ``device``; the
    numbers to compare, and the times. cuDNN's TF32 convolutions are off
    while it runs: the check holds float32 arithmetic (the "tiny" config)
    to float32 tolerances."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run_step(config, timed_steps, group, device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _run_step(config: str, timed_steps: int, group, device: torch.device) -> dict:
    import torch.distributed as dist

    from advoc_tpu_torch.parallel import distributed
    from advoc_tpu_torch.train.gan import all_reduce_mean

    gstate, dstate, wav, step = _setup(config, device, group)
    generator = torch.Generator(device=device).manual_seed(7)
    gstate, dstate, metrics = step(gstate, dstate, wav, generator)
    out = {
        "rank": distributed.rank(),
        "world_size": distributed.world_size(),
        "backend": dist.get_backend(group) if group is not None else None,
        "device": str(device),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "g_norm": float(torch.sqrt(sum((p.detach().double() ** 2).sum() for p in gstate.params))),
        "d_norm": float(torch.sqrt(sum((p.detach().double() ** 2).sum() for p in dstate.params))),
        "n_params": sum(p.numel() for p in gstate.params + dstate.params),
    }
    if timed_steps:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            gstate, dstate, metrics = step(gstate, dstate, wav, generator)
        _sync(device)
        out["step_ms"] = 1e3 * (time.perf_counter() - t0) / timed_steps
        if group is not None:
            # One step's gradient traffic: G's and D's gradients, one
            # coalesced all-reduce each.
            grads = [torch.ones(p.shape, device=device) for p in gstate.params + dstate.params]
            n_g = len(gstate.params)
            all_reduce_mean(grads[:n_g], group)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                all_reduce_mean(grads[:n_g], group)
                all_reduce_mean(grads[n_g:], group)
            _sync(device)
            out["allreduce_ms"] = 1e3 * (time.perf_counter() - t0) / timed_steps
            out["allreduce_bytes"] = 4 * out["n_params"]
    return out


def _worker(config: str, timed_steps: int, device_type: str) -> dict:
    """A rank of the data-parallel run (inside :func:`distributed.launch`)."""
    import torch.distributed as dist

    from advoc_tpu_torch.parallel import distributed

    return _run(config, timed_steps, dist.group.WORLD, distributed.local_device(device_type))


def _devices(num_processes: int, device: str) -> list[str]:
    if device == "cpu":
        return ["cpu"] * num_processes
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("mp_check --device cuda: no CUDA device is visible")
    return [f"cuda:{i % n}" for i in range(num_processes)]


def run_check(num_processes: int = 2, device: str = "cpu", backend: str | None = None,
              config: str = "tiny", timed_steps: int = 0, rtol: float = 2e-4,
              atol: float = 1e-5, timeout_s: float = 600.0) -> dict:
    """Spawn the data-parallel run, then run the reference in this process
    (after the ranks are done: the parent makes no CUDA context before the
    spawn); returns ``{"match": bool, ...}`` with both sides' numbers.

    A rank's metrics and norms match the reference's within ``rtol`` ·
    |value| + ``atol`` (the ranks' mean gradient sums in another order than
    the whole batch's, and Adam's first update is ≈ lr · sign(g)); the
    ranks agree with each other within 1e-12 relative (one all-reduce
    gives every rank the same gradients)."""
    from advoc_tpu_torch.parallel import distributed
    from advoc_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(devices=_devices(num_processes, device))
    threads = None if device == "cuda" else max(1, torch.get_num_threads() // num_processes)
    workers = distributed.launch(_worker, mesh, (config, timed_steps, device), backend=backend,
                                 threads=threads, timeout_s=timeout_s)
    reference = _run(config, timed_steps, None, mesh.devices[0])

    keys = sorted(reference["metrics"]) + ["g_norm", "d_norm"]

    def vals(rec: dict) -> dict:
        return {k: rec["metrics"].get(k, rec.get(k)) for k in keys}

    v_ref = vals(reference)
    match = all(
        w["world_size"] == num_processes
        and all(abs(vals(w)[k] - v_ref[k]) <= rtol * abs(v_ref[k]) + atol for k in keys)
        and all(abs(vals(w)[k] - vals(workers[0])[k]) <= 1e-12 * max(1.0, abs(v_ref[k]))
                for k in keys)
        for w in workers)
    report = {
        "match": match,
        "num_processes": num_processes,
        "device": device,
        "devices": [w["device"] for w in workers],
        "backend": workers[0]["backend"],
        "config": config,
        "n_params": reference["n_params"],
        "reference": v_ref,
        "workers": [vals(w) for w in workers],
    }
    if timed_steps:
        report["step_ms"] = [w["step_ms"] for w in workers]
        report["allreduce_ms"] = [w["allreduce_ms"] for w in workers]
        report["allreduce_bytes"] = workers[0]["allreduce_bytes"]
        report["reference_step_ms"] = reference["step_ms"]
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                   help="default: nccl on cuda, gloo on the cpu")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    p.add_argument("--timed_steps", type=int, default=0)
    args = p.parse_args(argv)
    report = run_check(args.num_processes, args.device, args.backend, args.config,
                       args.timed_steps)
    print("MP_CHECK_RESULT " + json.dumps(report), flush=True)
    if not report["match"]:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
