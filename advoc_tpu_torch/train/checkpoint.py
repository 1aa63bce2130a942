"""Training checkpoints and inference bundles.

The port of ``advoc_tpu.train.checkpoint``.

:class:`CheckpointManager` saves a training state (``{"g": gstate, "d":
dstate}``, or any nesting of dicts, tensors, numbers and objects with a
``state_dict``) every N steps into ``train_dir/<step>/state.pt``, keeps the
latest k, restores the latest at startup and lets an eval loop poll for new
steps. A save is atomic: it is written into a temporary directory that is
then renamed to its step, so :meth:`~CheckpointManager.latest_step` and
:meth:`~CheckpointManager.poll` see only finished steps. Saves are
asynchronous by default: the state is copied to the CPU at the call and
written on a thread while training goes on; the next save, ``close()`` or
``wait_until_finished()`` waits for it. Files are read with
``weights_only=True`` (tensors and plain containers, no pickled code). A
JAX (orbax) ``train_dir`` becomes one with ``scripts/ckpt_to_torch.py``.

An inference bundle is a directory that holds ``config.json`` (the same
keys the JAX package's bundles carry, whatever the exporter passed) and
``g_state.pt``, a ``torch.save`` of the generator's ``state_dict`` on the
CPU. A JAX bundle becomes one with ``scripts/bundle_to_torch.py``.
:func:`load_generator` builds a bundle's generator and
:func:`load_train_generator` a training run's, for the CLIs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator

import torch

STATE_FILE = "g_state.pt"
CONFIG_FILE = "config.json"
CKPT_FILE = "state.pt"


def _snapshot(state: Any) -> Any:
    """A CPU copy of ``state``: tensors copied, ``state_dict`` objects and
    containers walked, other leaves kept."""
    if hasattr(state, "state_dict"):
        return _snapshot(state.state_dict())
    if isinstance(state, dict):
        return {k: _snapshot(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_snapshot(v) for v in state)
    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    return state


def _load_into(template: Any, data: Any) -> Any:
    """``data`` loaded into ``template``'s objects where they have a
    ``load_state_dict``; the template's structure is returned."""
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(data)
        return template
    if isinstance(template, dict):
        return {k: _load_into(v, data[k]) for k, v in template.items()}
    return data


class CheckpointManager:
    """Save and restore training states by step; keep-k; poll the latest."""

    def __init__(self, train_dir: str | pathlib.Path, max_to_keep: int = 5,
                 save_interval_steps: int = 1, use_async: bool = True):
        """``save_interval_steps``: :meth:`save` writes only steps that are
        multiples of it (and the first), as orbax's cadence does."""
        self.dir = pathlib.Path(train_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._pool = ThreadPoolExecutor(max_workers=1) if use_async else None
        self._pending: Future | None = None

    def all_steps(self) -> list[int]:
        """The finished steps in the directory, in order."""
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / CKPT_FILE).is_file())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, snapshot: Any) -> None:
        tmp = self.dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / CKPT_FILE, "wb") as f:
            torch.save(snapshot, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self.dir / str(step))
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)

    def save(self, step: int, state: Any, force: bool = False, wait: bool = False) -> bool:
        """Save ``state`` at ``step`` unless that step is saved already or,
        without ``force``, the cadence skips it: a step at or before the
        latest, or (once there is a checkpoint) off the save interval.
        ``wait``: return only when it is on disk (a synchronous manager
        always does). Returns whether a save was made."""
        self.wait_until_finished()  # one write at a time: keep-k never races it
        if (self.dir / str(step)).exists():
            return False
        latest = self.latest_step()
        if not force and latest is not None and (step <= latest
                                                 or step % self.save_interval_steps):
            return False
        snapshot = _snapshot(state)
        if self._pool is None:
            self._write(step, snapshot)
            return True
        self._pending = self._pool.submit(self._write, step, snapshot)
        if wait:
            self.wait_until_finished()
        return True

    def wait_until_finished(self) -> None:
        """Wait for an in-flight save; its error, if any, is raised here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """The state saved at ``step`` (default: the latest), loaded into
        ``template``'s objects when given, else as saved (tensors on the
        CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        data = torch.load(self.dir / str(step) / CKPT_FILE, map_location="cpu",
                          weights_only=True)
        return data if template is None else _load_into(template, data)

    def restore_or_init(self, state: Any) -> tuple[Any, int]:
        """(the latest checkpoint loaded into ``state``, its step), or
        (``state``, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        return self.restore(step, template=state), step

    def poll(self, last_seen: int | None = None, interval_s: float = 5.0,
             timeout_s: float | None = None) -> Iterator[int]:
        """Yield new checkpoint steps as they appear, re-reading the
        directory each time; stop after ``timeout_s`` without a new one."""
        waited = 0.0
        while True:
            step = self.latest_step()
            if step is not None and (last_seen is None or step > last_seen):
                last_seen = step
                waited = 0.0
                yield step
            else:
                if timeout_s is not None and waited >= timeout_s:
                    return
                time.sleep(interval_s)
                waited += interval_s

    def close(self) -> None:
        """Finish an in-flight save and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


def export_inference_bundle(
    path: str | pathlib.Path, g_state: dict[str, torch.Tensor], config: dict
) -> None:
    """Write ``g_state`` (a generator's ``state_dict``, moved to the CPU)
    and ``config`` as a bundle directory."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in g_state.items()}, path / STATE_FILE)
    (path / CONFIG_FILE).write_text(json.dumps(config, indent=2))


def load_inference_bundle(
    path: str | pathlib.Path, device="cpu"
) -> tuple[dict[str, torch.Tensor], dict]:
    """(state_dict on ``device``, config) of a bundle directory. The state
    is read with ``weights_only=True``: tensors only, no pickled code."""
    path = pathlib.Path(path)
    config = json.loads((path / CONFIG_FILE).read_text())
    state = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
    return state, config


def generator_config(config: dict, model_size: str | None = None,
                     overrides: str | None = None, default_size: str = "full"):
    """The ``AdvocConfig`` a bundle's generator was built with: ``model_size``
    ("full" or "small") and ``overrides`` where given, else the bundle
    config's keys of the same names, else ``default_size`` and none."""
    from advoc_tpu_torch.models.advoc.model import AdvocConfig, small_config
    from advoc_tpu_torch.utils import apply_overrides

    size = model_size or config.get("model_size") or default_size
    if overrides is None:
        overrides = config.get("overrides")
    return apply_overrides(small_config() if size == "small" else AdvocConfig(), overrides)


def load_generator(path: str | pathlib.Path, model_size: str | None = None,
                   overrides: str | None = None, default_size: str = "full"):
    """(``AdvocGenerator`` holding a bundle's weights on the CPU, the bundle's
    config), its ``AdvocConfig`` as :func:`generator_config` resolves it."""
    from advoc_tpu_torch.models.advoc.model import AdvocGenerator

    state, config = load_inference_bundle(path)
    generator = AdvocGenerator(generator_config(config, model_size, overrides, default_size))
    generator.load_state_dict(state)
    return generator, config


def train_config(train_dir: str | pathlib.Path, model_size: str | None = None,
                 overrides: str | None = None, default_size: str = "full"):
    """The ``AdvocConfig`` of a training run: ``model_size`` and ``overrides``
    where either is given, else the run's recorded ``config.json`` (every
    field, written by the harness), else ``default_size``."""
    from advoc_tpu_torch.models.advoc.model import AdvocConfig

    recorded = pathlib.Path(train_dir) / CONFIG_FILE
    if model_size is None and overrides is None and recorded.is_file():
        fields = {f.name for f in dataclasses.fields(AdvocConfig)}
        return AdvocConfig(**{k: v for k, v in json.loads(recorded.read_text()).items()
                              if k in fields})
    return generator_config({}, model_size, overrides, default_size)


def load_train_generator(train_dir: str | pathlib.Path, model_size: str | None = None,
                         overrides: str | None = None, default_size: str = "full"):
    """(``AdvocGenerator`` holding the latest checkpoint's generator on the
    CPU, its step), the config as :func:`train_config` resolves it. Raises
    ``FileNotFoundError`` when the run has no checkpoint."""
    from advoc_tpu_torch.models.advoc.model import AdvocGenerator

    mgr = CheckpointManager(train_dir, use_async=False)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {mgr.dir}")
    generator = AdvocGenerator(train_config(train_dir, model_size, overrides, default_size))
    generator.load_state_dict(mgr.restore(step)["g"]["params"])
    mgr.close()
    return generator, step
