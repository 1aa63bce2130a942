"""A one-axis ('data',) device mesh and its replicate and shard helpers.

The port of ``advoc_tpu.parallel.mesh``. A :class:`Mesh` is the ordered
devices of one process that a batch is split over; a device may repeat
(several shards on one card, or on the CPU, the analog of JAX's
``xla_force_host_platform_device_count``). Training across processes has a
process group in place of a mesh (:mod:`advoc_tpu_torch.parallel.distributed`).
"""

from __future__ import annotations

import copy
import dataclasses
import weakref

import torch


def canonical(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card's ``cuda:i``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a ('data',) mesh, in shard order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(canonical(d) for d in self.devices))

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def data_mesh(n_devices: int | None = None, batch_size: int | None = None,
              devices=None) -> Mesh:
    """A ('data',) mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card, ``cuda:0`` … ``cuda:n−1``; all of them without
    ``n_devices``).

    With ``batch_size`` and no ``n_devices`` the mesh shrinks to the largest
    device count that divides the batch, so a batch-2 debug run on an
    8-card host takes 2 cards. An explicit ``n_devices`` that does not divide
    the batch raises ``ValueError``, and so does one above the devices there
    are: neither shrinks silently.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical(d) for d in devices]
    if not devices:
        raise RuntimeError("data_mesh: no CUDA device is visible; pass devices= (e.g. CPU "
                           "devices) to build a mesh without a card")
    if n_devices is not None:
        if n_devices < 1 or n_devices > len(devices):
            raise ValueError(f"--n_devices {n_devices} is not in 1 … {len(devices)}, the "
                             f"devices there are")
        if batch_size is not None and batch_size % n_devices:
            raise ValueError(f"--batch_size {batch_size} is not divisible by "
                             f"--n_devices {n_devices}")
        devices = devices[:n_devices]
    elif batch_size is not None:
        devices = devices[: max(d for d in range(1, len(devices) + 1) if batch_size % d == 0)]
    return Mesh(tuple(devices))


# module → {device: (its copy there, the module's weight versions when
# copied)}; an entry goes with its module.
_REPLICAS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _versions(module: torch.nn.Module) -> tuple[int, ...]:
    """The in-place version counters of a module's weights: loading a state
    dict or an optimizer step changes them."""
    return tuple(t._version for t in (*module.parameters(), *module.buffers()))


def replicate(module_or_tensors, mesh: Mesh) -> list:
    """One copy of a module or of a tensor (or a tuple or list of them) per
    mesh shard, each on its shard's device; shards on one device share a
    copy. A module's copies are built once and cached for the module (in
    eval mode, as the vocoders run it), and reloaded when its weights have
    changed in place since; a module already on a device is its own copy
    there. Tensors are copied at each call."""
    x = module_or_tensors
    if isinstance(x, torch.nn.Module):
        per_device = _REPLICAS.setdefault(x, {})
        home = canonical(next(iter(x.parameters()), torch.empty(0)).device)
        versions = _versions(x)
        out = []
        for dev in mesh.devices:
            if dev == home:
                out.append(x)
                continue
            replica, seen = per_device.get(dev, (None, None))
            if replica is None:
                replica = copy.deepcopy(x).to(dev).eval()
            elif seen != versions:
                replica.load_state_dict(x.state_dict())
            per_device[dev] = (replica, versions)
            out.append(replica)
        return out
    if isinstance(x, (tuple, list)):
        return [type(x)(t.to(dev, non_blocking=True) for t in x) for dev in mesh.devices]
    return [x.to(dev, non_blocking=True) for dev in mesh.devices]


def shard_rows(x, axis: int, rank: int, n: int):
    """Shard ``rank`` of ``n`` of ``x`` (tensor or numpy): its contiguous
    ``1/n`` along ``axis``, the split of :func:`shard_batch` and of a
    data-parallel rank's rows. ``x.shape[axis]`` must divide by ``n``."""
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} is not divisible by {n} "
                         "shards")
    b = x.shape[axis] // n
    return x[(slice(None),) * (axis % x.ndim) + (slice(rank * b, (rank + 1) * b),)]


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> list[torch.Tensor]:
    """One contiguous slice of ``x`` per shard along ``axis``, each on its
    shard's device. ``x.shape[axis]`` must divide over the mesh."""
    return [shard_rows(x, axis, i, mesh.size).to(dev, non_blocking=True)
            for i, dev in enumerate(mesh.devices)]
