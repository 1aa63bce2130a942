"""Inference bundles: the generator's weights and a config, for serving.

The inference half of ``advoc_tpu.train.checkpoint``. A bundle is a
directory that holds ``config.json`` (the same keys the JAX package's
bundles carry, whatever the exporter passed) and ``g_state.pt``, a
``torch.save`` of the generator's ``state_dict`` on the CPU. A JAX (orbax)
bundle becomes one with ``scripts/bundle_to_torch.py``.
:func:`load_generator` builds a bundle's generator, for the CLIs. The training
checkpoints of the JAX package (``CheckpointManager``) are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

import json
import pathlib

import torch

STATE_FILE = "g_state.pt"
CONFIG_FILE = "config.json"


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
