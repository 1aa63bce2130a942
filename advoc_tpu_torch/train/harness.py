"""The GAN training and evaluation loops.

The port of ``advoc_tpu.train.harness``: checkpoints every N steps and
resume from the latest, TensorBoard summaries, periodic step logs, a stop
at ``max_steps``, and two guards that end a diverged run loudly after
saving it. ``step_fn(gstate, dstate, batch, generator)`` is a step of
:mod:`advoc_tpu_torch.train.gan`; the loop owns its ``torch.Generator``,
seeded from ``seed`` on the states' device, where the JAX loop splits a
``PRNGKey``. The training CLIs share :func:`train_device`,
:func:`launch_training` (their data-parallel ranks) and
:func:`restore_latest` (their infer modes).

In a data-parallel run every rank runs the loop on its rows of each batch
(``train.gan.data_parallel``) and restores the same checkpoint; rank 0
alone logs, writes summaries, ``config.json`` and checkpoints, and every
rank waits at a barrier after each save, so a run killed after a
checkpoint resumes on every rank from that step.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from advoc_tpu_torch.parallel import distributed
from advoc_tpu_torch.parallel.mesh import shard_rows
from advoc_tpu_torch.train import metrics as metrics_lib
from advoc_tpu_torch.train.checkpoint import CheckpointManager


def train_device(device) -> torch.device:
    """This process's device of the CLIs' ``--device``: cpu, or (cuda,
    which raises without a card) this rank's card, ``cuda:LOCAL_RANK``
    (:func:`~advoc_tpu_torch.parallel.distributed.local_device`)."""
    from advoc_tpu_torch.infer.vocoder import _resolve_device

    return distributed.local_device(_resolve_device(device))


def rank_rows(batch_size: int, n_stacked: int = 1) -> list[int] | None:
    """This rank's rows of a global loader batch of ``n_stacked`` stacked
    batches of ``batch_size`` rows (the critics' (n_stacked·B, …) flat
    batch): rows r·b … (r+1)·b − 1 of each, b = batch_size / the ranks;
    None in a single process (every row)."""
    n = distributed.world_size()
    if n == 1:
        return None
    index = np.arange(n_stacked * batch_size).reshape(n_stacked, batch_size)
    return shard_rows(index, 1, distributed.rank(), n).reshape(-1).tolist()


def _rank_train(train_fn: Callable, args) -> tuple[int, int, int]:
    gstate, dstate, step = train_fn(args, dist.group.WORLD)
    return gstate.step, dstate.step, step


def launch_training(train_fn: Callable, args):
    """Run ``train_fn(args, group)`` (it returns the train loop's (gstate,
    dstate, final_step)) as the run's data-parallel ranks, ``group`` their
    process group or None for one process, and return what it returns.

    Under torchrun (``WORLD_SIZE`` > 1 in the environment) this process
    joins the group as its rank. Otherwise ``args.n_devices`` (default: the
    visible cards, shrunk to divide ``args.batch_size``, as
    :func:`~advoc_tpu_torch.parallel.mesh.data_mesh` sizes a mesh) ranks
    are spawned on this host, one a card (``--device cpu``: gloo ranks on
    the CPU, each with its share of torch's threads), and each rank's
    (gstate.step, dstate.step, final_step) is returned, in rank order.
    One rank runs in this process. ``--n_devices`` above the visible cards
    or not dividing the batch raises.
    """
    from advoc_tpu_torch.infer.vocoder import _resolve_device
    from advoc_tpu_torch.parallel.mesh import data_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if args.n_devices not in (None, world):
            raise ValueError(f"--n_devices {args.n_devices} in a run of WORLD_SIZE={world} "
                             "processes")
        if args.batch_size % world:
            raise ValueError(f"--batch_size {args.batch_size} is not divisible by the "
                             f"{world} processes")
        distributed.initialize(device=args.device)
        try:
            return train_fn(args, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    device = _resolve_device(args.device)
    devices = None if device.type == "cuda" else [device] * (args.n_devices or 1)
    mesh = data_mesh(args.n_devices, args.batch_size, devices)
    if mesh.size == 1:
        return train_fn(args, None)
    threads = None if device.type == "cuda" else max(1, torch.get_num_threads() // mesh.size)
    # No deadline: a run lasts as long as its steps; a rank that fails ends it.
    return distributed.launch(_rank_train, mesh, (train_fn, args), threads=threads,
                              timeout_s=None)


def restore_latest(train_dir: str, template: dict) -> int | None:
    """Load ``train_dir``'s latest checkpoint into ``template`` (``{"g":
    gstate, "d": dstate}``) for inference and say so; returns its step, or
    None (the states keep their random init)."""
    mgr = CheckpointManager(train_dir)
    step = mgr.latest_step()
    if step is not None:
        mgr.restore(step, template=template)
        print(f"[infer] restored step {step}", flush=True)
    else:
        print("[infer] no checkpoint — random init", flush=True)
    mgr.close()
    return step


def check_run_config(train_dir: str, config: dict) -> None:
    """Record ``config`` as ``train_dir/config.json``; on resume, raise a
    clear error if it differs from the recorded one. Keys are compared on
    the intersection, so a new config field keeps old runs resumable."""
    path = pathlib.Path(train_dir) / "config.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        recorded = json.loads(path.read_text())
        diff = {k: (recorded[k], config[k]) for k in recorded.keys() & config.keys()
                if recorded[k] != config[k]}
        if diff:
            raise ValueError(
                f"run config mismatch in {train_dir}: this run was trained with different "
                f"model hyperparameters (recorded → current): {diff}. Pass matching "
                f"--model_overrides to resume it, or use a fresh train_dir."
            )
    else:
        path.write_text(json.dumps(config, indent=2, sort_keys=True))


def _save_and_raise(save: Callable, mgr: CheckpointManager, step: int, msg: str):
    save(step, wait=True)
    mgr.close()
    raise FloatingPointError(msg)


def train_loop(
    step_fn: Callable,
    gstate,
    dstate,
    data_it: Iterator,
    train_dir: str,
    max_steps: int = 100000,
    ckpt_every: int = 1000,
    log_every: int = 50,
    summary_every: int = 100,
    seed: int = 0,
    nan_check_every: int = 200,
    explode_ratio: float = 50.0,
    config: dict | None = None,
):
    """Run the alternating-GAN loop; returns (gstate, dstate, final_step).

    Resumes from the latest checkpoint in ``train_dir``. ``config`` is
    recorded as ``train_dir/config.json`` and checked on resume
    (:func:`check_run_config`).

    NaN guard: every ``nan_check_every`` steps the metrics are read back;
    on a non-finite value the loop saves a checkpoint at that step and
    raises ``FloatingPointError``. Explosion guard, at the same cadence:
    each ``*loss*`` metric is tracked with an EMA of its magnitude, and a
    value above ``explode_ratio`` × max(EMA, 1) saves and raises the same
    way (the first check only seeds the EMA). 0 disables either guard.
    """
    main = distributed.is_main()
    if config is not None:  # rank 0 records it, the others read it after
        distributed.main_first(check_run_config, train_dir, config)
    mgr = CheckpointManager(train_dir, max_to_keep=5)
    bundle, start = mgr.restore_or_init({"g": gstate, "d": dstate})
    gstate, dstate = bundle["g"], bundle["d"]
    if start and main:
        print(f"[train] resumed from step {start} in {train_dir}", flush=True)

    def save(step: int, wait: bool = False) -> None:
        # Data-parallel, the save is on disk before the barrier lets any
        # rank past this step.
        if main:
            mgr.save(step, {"g": gstate, "d": dstate}, wait=wait or distributed.world_size() > 1)
        distributed.barrier()

    writer = metrics_lib.SummaryWriter(f"{train_dir}/tb") if main else None
    generator = torch.Generator(device=gstate.device).manual_seed(seed)
    step = steps_at_last = start
    t_last = time.perf_counter()
    loss_emas: dict[str, float] = {}
    for batch in data_it:
        if step >= max_steps:
            break
        gstate, dstate, m = step_fn(gstate, dstate, batch, generator)
        step += 1

        if nan_check_every and step % nan_check_every == 0:
            host = metrics_lib.to_host(m)
            bad = {k: v for k, v in host.items() if not np.isfinite(v)}
            if bad:
                _save_and_raise(save, mgr, step,
                                f"non-finite training metrics at step {step}: {bad} "
                                f"(diverged checkpoint saved to {train_dir})")
            blown = {}
            for k, v in host.items() if explode_ratio else ():
                if "loss" not in k:
                    continue
                ema = loss_emas.get(k)
                if ema is not None and abs(v) > explode_ratio * max(ema, 1.0):
                    blown[k] = (v, ema)
                loss_emas[k] = abs(v) if ema is None else 0.9 * ema + 0.1 * abs(v)
            if blown:
                detail = ", ".join(f"{k}={v:.4g} (EMA {e:.4g})" for k, (v, e) in blown.items())
                _save_and_raise(save, mgr, step,
                                f"training explosion at step {step}: {detail} exceeded "
                                f"{explode_ratio}× max(EMA, 1) while still finite, which the "
                                f"NaN guard cannot see. Diverged checkpoint saved to "
                                f"{train_dir}; resume from the last healthy periodic checkpoint.")

        if step % log_every == 0 and main:
            host = metrics_lib.to_host(m)  # waits for the device: the rate is honest
            dt = time.perf_counter() - t_last
            rate = (step - steps_at_last) / max(dt, 1e-9)
            t_last, steps_at_last = time.perf_counter(), step
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(host.items()))
            print(f"[train] step {step} ({rate:.2f} steps/s) {msg}", flush=True)
        if step % summary_every == 0 and main:
            writer.scalars(step, metrics_lib.to_host(m))
        if step % ckpt_every == 0:
            save(step)
            if main:
                print(f"[train] checkpoint @ {step}", flush=True)

    if step > start and step % ckpt_every != 0:
        save(step)
    mgr.close()  # waits for an in-flight save
    if writer is not None:
        writer.close()
    close = getattr(data_it, "close", None)
    if close is not None:  # release the loader's producer thread promptly
        close()
    return gstate, dstate, step


def eval_loop(
    eval_fn: Callable,
    make_states: Callable,
    data_fn: Callable[[], Iterator],
    train_dir: str,
    once: bool = False,
    timeout_s: float = 3600.0,
    audio_fn: Callable | None = None,
    image_fn: Callable | None = None,
    eval_takes_bundle: bool = False,
):
    """Poll ``train_dir`` for new checkpoints and evaluate each.

    ``eval_fn(generator, batch)`` → metric dict, averaged over the pass
    from ``data_fn()`` and written to ``train_dir/tb_eval``;
    ``audio_fn(generator)`` returns (tag, waveform, sample_rate) tuples and
    ``image_fn(generator)`` (tag, H×W image in [0, 1]) tuples to summarize.
    ``eval_takes_bundle``: ``eval_fn`` gets the whole restored
    ``{"g": gstate, "d": dstate}`` in place of the generator, for an eval
    that scores with the trained discriminator (MelSpecGAN's); ``audio_fn``
    and ``image_fn`` still get the generator. Returns the last step
    evaluated, or None.
    """
    mgr = CheckpointManager(train_dir)
    writer = metrics_lib.SummaryWriter(f"{train_dir}/tb_eval")
    gstate, dstate = make_states()
    template = {"g": gstate, "d": dstate}

    seen = None
    for step in mgr.poll(last_seen=None, interval_s=5.0, timeout_s=0.0 if once else timeout_s):
        seen = step
        bundle = mgr.restore(step, template=template)
        generator = bundle["g"].model
        eval_arg = bundle if eval_takes_bundle else generator
        sums: dict[str, float] = {}
        n = 0
        for batch in data_fn():
            for k, v in metrics_lib.to_host(eval_fn(eval_arg, batch)).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        writer.scalars(step, means)
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
        print(f"[eval] ckpt {step}: {msg}", flush=True)
        for tag, wav, sr in audio_fn(generator) if audio_fn is not None else ():
            writer.audio(step, tag, np.asarray(wav), sr)
        for tag, img in image_fn(generator) if image_fn is not None else ():
            writer.image(step, tag, np.asarray(img))
        if once:
            break
    if seen is None:
        print(f"[eval] no checkpoint appeared in {train_dir} within {timeout_s:.0f}s — "
              "evaluated NOTHING", flush=True)
    mgr.close()
    writer.close()
    return seen
