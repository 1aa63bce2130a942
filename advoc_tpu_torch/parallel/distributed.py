"""Process groups for data-parallel training: join one, or start one.

The port of ``advoc_tpu.parallel.distributed``. Where JAX runs one process
a host over all its chips, the port runs one process a device, and the
ranks average their gradients over a ``torch.distributed`` process group
(``train.gan.data_parallel``). :func:`initialize` joins the group a
launcher set up (torchrun's environment: ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or the one its arguments
name; a single process joins nothing. :func:`launch` starts one rank per
device of a mesh on this host (the CLIs' ``--n_devices``) and returns what
each rank's function returned.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from advoc_tpu_torch.parallel.mesh import Mesh


def local_device(device="cuda") -> torch.device:
    """This process's device of ``device``'s type: a CUDA device without an
    index is the card :func:`initialize` made current in a process group,
    else ``cuda:LOCAL_RANK``; any other device is itself."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda") -> bool:
    """Join the default process group when the run has several processes;
    returns whether it did.

    ``world_size`` and ``rank`` default to the environment's ``WORLD_SIZE``
    and ``RANK``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``). A single process (no ``WORLD_SIZE``, or 1) returns
    False and touches nothing. The backend is NCCL for a CUDA device and
    gloo for the CPU; a CUDA device becomes the current card
    (:func:`local_device`). A collective that waits
    :data:`COLLECTIVE_TIMEOUT_S` for a rank that died raises.
    """
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size <= 1:
        return False
    rank = int(os.environ["RANK"]) if rank is None else rank
    _join(init_method or "env://", world_size, rank, device, None, COLLECTIVE_TIMEOUT_S)
    return True


def _join(init_method: str, world_size: int, rank_: int, device, backend: str | None,
          timeout_s: float) -> None:
    dev = local_device(device)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank_} wants {dev}, but {torch.cuda.device_count()} "
                               "CUDA device(s) are visible")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world_size, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process logs and writes: rank 0, or a single process."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; a single process returns at once."""
    if dist.is_initialized():
        dist.barrier()


def main_first(fn: Callable, *args):
    """``fn(*args)`` on rank 0, then, once it has returned, on the other
    ranks: for work whose files the other ranks read (a fixture set that
    rank 0 writes and they find)."""
    if is_main():
        out = fn(*args)
        barrier()
        return out
    barrier()
    return fn(*args)


def spans_hosts() -> bool:
    """Whether the ranks run on more than one host (torchrun's
    ``WORLD_SIZE`` > ``LOCAL_WORLD_SIZE``)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return world_size() > local


# A collective that waits this long for a rank that died raises.
COLLECTIVE_TIMEOUT_S = 600.0


def _rank_main(fn, args, rank_: int, devices: list, init_file: str, backend, threads,
               out: multiprocessing.Queue) -> None:
    n = len(devices)
    os.environ.update(RANK=str(rank_), LOCAL_RANK=str(rank_), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n))
    if threads:
        torch.set_num_threads(threads)
    try:
        _join(f"file://{init_file}", n, rank_, devices[rank_], backend, COLLECTIVE_TIMEOUT_S)
        out.put((rank_, True, fn(*args)))
    except BaseException:
        out.put((rank_, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _collect(procs: list, out, timeout_s: float | None) -> tuple[dict[int, Any], str | None]:
    """Each rank's result from ``out`` as the ranks put them, until all
    have or one fails: ({rank: result}, None), or the results so far and
    why the launch failed (a rank raised, died without a word, or the
    ranks outran ``timeout_s``; None: no deadline)."""
    results: dict[int, Any] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while len(results) < len(procs):
        try:
            r, ok, value = out.get(timeout=0.2)
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and i not in results]
            if dead:  # died without a word (killed, or a crash in C)
                return results, f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
            if deadline is not None and time.monotonic() > deadline:
                return results, f"the ranks did not finish within {timeout_s:.0f} s"
            continue
        if not ok:
            return results, f"rank {r} failed:\n{value}"
        results[r] = value
    return results, None


def launch(fn: Callable, mesh: Mesh, args: tuple = (), backend: str | None = None,
           threads: int | None = None, timeout_s: float | None = None) -> list[Any]:
    """Run ``fn(*args)`` in one spawned process per device of ``mesh``, rank
    i on ``mesh.devices[i]``, all in one process group (a file store in a
    temporary directory; ``backend`` defaults as :func:`initialize` picks
    it; a mesh of one device makes a group of one); returns each rank's
    result, in rank order.

    ``fn`` and ``args`` are pickled (a module-level function), and so are
    the results. ``threads`` sets torch's intra-op threads in each rank.
    A rank that raises or dies, or a run past ``timeout_s`` (None, the
    default: no deadline, as a training run has none), ends every rank and
    raises ``RuntimeError`` with the failing rank's traceback. A collective
    that waits :data:`COLLECTIVE_TIMEOUT_S` for a rank raises in the ranks.
    The parent makes no CUDA context.
    """
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    devices = [str(d) for d in mesh.devices]
    with tempfile.TemporaryDirectory(prefix="advoc_dist_") as tmp:
        init_file = str(pathlib.Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, args, r, devices, init_file, backend,
                                                      threads, out))
                 for r in range(len(devices))]
        for p in procs:
            p.start()
        failure = "the launch was interrupted"
        try:
            results, failure = _collect(procs, out, timeout_s)
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    if failure is not None:
        raise RuntimeError(f"data-parallel launch on {devices}: {failure}")
    return [results[r] for r in range(len(procs))]
