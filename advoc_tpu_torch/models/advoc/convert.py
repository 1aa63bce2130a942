"""Flax parameters and optax Adam state → the port's state dicts.

``flax_to_torch_state_dict(params, cfg)`` takes the JAX package's
``AdvocGenerator`` parameter tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns a ``state_dict``
for :class:`~advoc_tpu_torch.models.advoc.model.AdvocGenerator`;
``flax_disc_to_torch_state_dict`` does the same for the
``PatchDiscriminator`` (flax ``conv{i}``, ``norm{i}``, ``logit`` →
``convs.{i}``, ``norms.{i}``, ``logit``). ``optax_adam_to_torch`` turns
optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``: moment trees
shaped like the parameters) into a ``torch.optim.Adam`` ``state_dict``
for the module the parameters load into, so that a JAX training state
continues in the port. It imports nothing of JAX. Kernel layouts:

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

from advoc_tpu_torch.models.advoc.model import AdvocConfig, AdvocGenerator, PatchDiscriminator


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


def _disc_name_map(cfg: AdvocConfig) -> dict[str, tuple[str, str]]:
    """flax leaf path → (torch key, layout) for every discriminator parameter."""
    m = {}
    for i in range(cfg.disc_layers):
        m[f"conv{i}/kernel"], m[f"conv{i}/bias"] = (f"convs.{i}.weight", "conv"), (f"convs.{i}.bias", "vector")
        if i > 0:
            m[f"norm{i}/scale"], m[f"norm{i}/bias"] = (f"norms.{i}.weight", "vector"), (f"norms.{i}.bias", "vector")
    m["logit/kernel"], m["logit/bias"] = ("logit.weight", "conv"), ("logit.bias", "vector")
    return m


def _to_torch(a: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)
    if layout == "conv_transpose":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def _convert(params: Mapping, names: dict, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    flat = _flat(params)
    missing = sorted(set(names) - set(flat))
    unexpected = sorted(set(flat) - set(names))
    if missing or unexpected:
        raise ValueError(f"flax tree mismatch: missing {missing}, unexpected {unexpected}")
    want = {k: v.shape for k, v in module.state_dict().items()}
    out = {}
    for path, (key, layout) in names.items():
        arr = np.ascontiguousarray(_to_torch(flat[path], layout), dtype=np.float32)
        if arr.shape != tuple(want[key]):
            raise ValueError(
                f"{path}: shape {flat[path].shape} does not fit {key} {tuple(want[key])}"
            )
        out[key] = torch.tensor(arr)
    return out


def flax_to_torch_state_dict(
    params: Mapping, cfg: AdvocConfig = AdvocConfig()
) -> dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` (float32 tensors) from a flax
    parameter tree."""
    return _convert(params, _name_map(cfg), AdvocGenerator(cfg))


def flax_disc_to_torch_state_dict(
    params: Mapping, cfg: AdvocConfig = AdvocConfig()
) -> dict[str, torch.Tensor]:
    """The port's ``PatchDiscriminator`` ``state_dict`` from a flax tree."""
    return _convert(params, _disc_name_map(cfg), PatchDiscriminator(cfg))


def optax_adam_to_torch(
    mu: Mapping, nu: Mapping, count: int, module: torch.nn.Module,
    lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
) -> dict:
    """``torch.optim.Adam(module.parameters(), lr, (b1, b2), eps=1e-8)``'s
    ``state_dict`` holding optax's first and second moments (``mu``, ``nu``,
    converted like the parameters of ``module``, an ``AdvocGenerator`` or a
    ``PatchDiscriminator``) and its step ``count``. optax's Adam keeps no
    learning rate in its state: pass the one it was built with."""
    convert = (flax_disc_to_torch_state_dict if isinstance(module, PatchDiscriminator)
               else flax_to_torch_state_dict)
    m1, m2 = convert(mu, module.cfg), convert(nu, module.cfg)
    sd = torch.optim.Adam(module.parameters(), lr=lr, betas=(b1, b2), eps=1e-8).state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m1[name], "exp_avg_sq": m2[name]}
        for i, (name, _) in enumerate(module.named_parameters())
    }
    return sd
