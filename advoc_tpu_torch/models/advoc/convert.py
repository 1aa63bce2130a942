"""Flax generator parameters → the port's ``state_dict``.

``flax_to_torch_state_dict(params, cfg)`` takes the JAX package's
``AdvocGenerator`` parameter tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns a ``state_dict``
for :class:`~advoc_tpu_torch.models.advoc.model.AdvocGenerator`. It imports
nothing of JAX. Kernel layouts:

* ``Conv`` kernel (kh, kw, cin, cout) → ``weight`` (cout, cin, kh, kw);
* ``ConvTranspose`` kernel (kh, kw, cin, cout), not transposed by flax →
  flipped spatially, then ``weight`` (cin, cout, kh, kw);
* ``GroupNorm`` scale/bias → ``weight``/``bias``.

Under ``fast_head`` the tree has no ``up{depth-1}`` and ``head`` is the 3×3
conv to 4·freq_pack outputs; the same layouts apply.

It raises on a missing or unexpected leaf and on any shape mismatch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from advoc_tpu_torch.models.advoc.model import AdvocConfig, AdvocGenerator


def _flat(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _name_map(cfg: AdvocConfig) -> dict[str, tuple[str, str]]:
    """flax leaf path → (torch key, layout) for every generator parameter."""
    m = {}

    def conv(flax: str, torch_: str, layout: str) -> None:
        m[f"{flax}/kernel"] = (f"{torch_}.weight", layout)
        m[f"{flax}/bias"] = (f"{torch_}.bias", "vector")

    def norm(flax: str, torch_: str) -> None:
        m[f"{flax}/scale"] = (f"{torch_}.weight", "vector")
        m[f"{flax}/bias"] = (f"{torch_}.bias", "vector")

    for i in range(cfg.depth):
        conv(f"down{i}/conv", f"downs.{i}.conv", "conv")
        if i > 0:
            norm(f"down{i}/norm", f"downs.{i}.norm")
    conv("bottleneck", "bottleneck", "conv")
    for i in range(cfg.depth - 1 if cfg.fast_head else cfg.depth):
        conv(f"up{i}/conv", f"ups.{i}.conv", "conv_transpose")
        norm(f"up{i}/norm", f"ups.{i}.norm")
    conv("head", "head", "conv")
    return m


def _to_torch(a: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)
    if layout == "conv_transpose":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def flax_to_torch_state_dict(
    params: Mapping, cfg: AdvocConfig = AdvocConfig()
) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 tensors) from a flax parameter tree."""
    flat = _flat(params)
    names = _name_map(cfg)
    missing = sorted(set(names) - set(flat))
    unexpected = sorted(set(flat) - set(names))
    if missing or unexpected:
        raise ValueError(f"flax tree mismatch: missing {missing}, unexpected {unexpected}")
    want = {k: v.shape for k, v in AdvocGenerator(cfg).state_dict().items()}
    out = {}
    for path, (key, layout) in names.items():
        arr = np.ascontiguousarray(_to_torch(flat[path], layout), dtype=np.float32)
        if arr.shape != tuple(want[key]):
            raise ValueError(
                f"{path}: shape {flat[path].shape} does not fit {key} {tuple(want[key])}"
            )
        out[key] = torch.tensor(arr)
    return out
