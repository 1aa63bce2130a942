"""Flax parameter trees (nested dicts of numpy arrays) → the port's state
dicts, for any module whose layers bear their flax names.

:func:`flax_to_state_dict` maps the flax leaf ``a/b/kernel`` onto the
module's ``a.b.weight`` (``bias`` onto ``bias``, a ``GroupNorm``'s
``scale`` onto ``weight``) in the layout of the layer found there:

* ``Dense`` kernel (in, out) → ``Linear.weight`` (out, in);
* ``Conv`` kernel (k…, cin, cout) → ``weight`` (cout, cin, k…);
* ``ConvTranspose`` kernel (k…, cin, cout), not transposed by flax →
  flipped spatially, then ``weight`` (cin, cout, k…)
  (:func:`~advoc_tpu_torch.models.layers.conv_transpose_same`).

It raises on a missing or unexpected leaf and on any shape mismatch. The
WaveGAN, conditional-WaveGAN and MelSpecGAN models convert with it;
:mod:`advoc_tpu_torch.models.advoc.convert` names the advoc models'
layers itself. :func:`state_dict_from_flax` takes a model of any family,
and :func:`optax_adam_to_torch` turns optax's ``ScaleByAdamState``
(``count``, ``mu``, ``nu``: moment trees shaped like the parameters) into a
``torch.optim.Adam`` ``state_dict`` for the module the parameters load
into, so that a JAX training state continues in the port. It imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from advoc_tpu_torch.models.layers import GroupNorm


def flat(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a/b/kernel": array, ...}`` of a nested tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def to_torch_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """A flax leaf in the layout of its torch parameter (module docstring)."""
    spatial = a.ndim - 2
    if layout == "dense":
        return a.T
    if layout == "conv":
        return a.transpose(spatial + 1, spatial, *range(spatial))
    if layout == "conv_transpose":
        return a[(slice(None, None, -1),) * spatial].transpose(spatial, spatial + 1,
                                                                 *range(spatial))
    return a


def convert_tree(params: Mapping, names: dict[str, tuple[str, str]],
                 module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict (float32) from the flax ``params``, by
    ``names``: flax leaf path → (state-dict key, layout)."""
    leaves = flat(params)
    missing = sorted(set(names) - set(leaves))
    unexpected = sorted(set(leaves) - set(names))
    if missing or unexpected:
        raise ValueError(f"flax tree mismatch: missing {missing}, unexpected {unexpected}")
    want = {k: v.shape for k, v in module.state_dict().items()}
    out = {}
    for path, (key, layout) in names.items():
        arr = np.ascontiguousarray(to_torch_layout(leaves[path], layout), dtype=np.float32)
        if arr.shape != tuple(want[key]):
            raise ValueError(
                f"{path}: shape {leaves[path].shape} does not fit {key} {tuple(want[key])}"
            )
        out[key] = torch.tensor(arr)
    return out


def flax_names(module: nn.Module) -> dict[str, tuple[str, str]]:
    """flax leaf path → (state-dict key, layout) for every layer of a
    module whose submodule names are flax's."""
    names = {}
    for name, m in module.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, nn.Linear):
            layout = "dense"
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            layout = "conv_transpose"
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            layout = "conv"
        elif isinstance(m, GroupNorm):
            names[f"{path}/scale"] = (f"{name}.weight", "vector")
            names[f"{path}/bias"] = (f"{name}.bias", "vector")
            continue
        else:
            continue
        names[f"{path}/kernel"] = (f"{name}.weight", layout)
        names[f"{path}/bias"] = (f"{name}.bias", "vector")
    return names


def flax_to_state_dict(params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict from a flax tree of the same model (a
    WaveGAN, conditional-WaveGAN or MelSpecGAN generator or discriminator)."""
    return convert_tree(params, flax_names(module), module)


def state_dict_from_flax(params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict from a flax tree of the same model: an
    ``AdvocGenerator`` or ``PatchDiscriminator`` by the advoc name maps, a
    model of another family by :func:`flax_to_state_dict`."""
    # Imported here: the advoc converter builds on this module.
    from advoc_tpu_torch.models.advoc import convert as advoc

    if isinstance(module, advoc.AdvocGenerator):
        return advoc.flax_to_torch_state_dict(params, module.cfg)
    if isinstance(module, advoc.PatchDiscriminator):
        return advoc.flax_disc_to_torch_state_dict(params, module.cfg)
    return flax_to_state_dict(params, module)


def optax_adam_to_torch(
    mu: Mapping, nu: Mapping, count: int, module: nn.Module,
    lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
) -> dict:
    """``torch.optim.Adam(module.parameters(), lr, (b1, b2), eps=1e-8)``'s
    ``state_dict`` holding optax's first and second moments (``mu``, ``nu``,
    converted like the parameters of ``module``, by
    :func:`state_dict_from_flax`) and its step ``count``. optax's Adam keeps
    no learning rate in its state: pass the one it was built with."""
    m1, m2 = state_dict_from_flax(mu, module), state_dict_from_flax(nu, module)
    sd = torch.optim.Adam(module.parameters(), lr=lr, betas=(b1, b2), eps=1e-8).state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m1[name], "exp_avg_sq": m2[name]}
        for i, (name, _) in enumerate(module.named_parameters())
    }
    return sd
