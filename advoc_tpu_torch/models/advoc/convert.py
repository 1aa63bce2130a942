"""Flax parameters and optax Adam state → the port's state dicts.

``flax_to_torch_state_dict(params, cfg)`` takes the JAX package's
``AdvocGenerator`` parameter tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns a ``state_dict``
for :class:`~advoc_tpu_torch.models.advoc.model.AdvocGenerator`;
``flax_disc_to_torch_state_dict`` does the same for the
``PatchDiscriminator`` (flax ``conv{i}``, ``norm{i}``, ``logit`` →
``convs.{i}``, ``norms.{i}``, ``logit``).
:func:`~advoc_tpu_torch.models.convert.state_dict_from_flax` dispatches
here for the advoc models. It imports nothing of JAX. Kernel layouts:

* ``Conv`` kernel (kh, kw, cin, cout) → ``weight`` (cout, cin, kh, kw);
* ``ConvTranspose`` kernel (kh, kw, cin, cout), not transposed by flax →
  flipped spatially, then ``weight`` (cin, cout, kh, kw);
* ``GroupNorm`` scale/bias → ``weight``/``bias``.

Under ``fast_head`` the tree has no ``up{depth-1}`` and ``head`` is the 3×3
conv to 4·freq_pack outputs; the same layouts apply. Under the
"pixelshuffle", "subpixel" and "resize" decoders each ``up{i}/conv`` is a
``Conv`` (3×3 to 4F, 2×2 to 4F, 4×4 to F) and takes the ``Conv`` layout.

It raises on a missing or unexpected leaf and on any shape mismatch.
"""

from __future__ import annotations

from typing import Mapping

import torch

from advoc_tpu_torch.models.advoc.model import AdvocConfig, AdvocGenerator, PatchDiscriminator
from advoc_tpu_torch.models.convert import convert_tree


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
    # Only the default decoder's up convs are transposed convolutions.
    up_layout = "conv_transpose" if cfg.upsample == "convtranspose" else "conv"
    for i in range(cfg.depth - 1 if cfg.fast_head else cfg.depth):
        conv(f"up{i}/conv", f"ups.{i}.conv", up_layout)
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


def flax_to_torch_state_dict(
    params: Mapping, cfg: AdvocConfig = AdvocConfig()
) -> dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` (float32 tensors) from a flax
    parameter tree."""
    return convert_tree(params, _name_map(cfg), AdvocGenerator(cfg))


def flax_disc_to_torch_state_dict(
    params: Mapping, cfg: AdvocConfig = AdvocConfig()
) -> dict[str, torch.Tensor]:
    """The port's ``PatchDiscriminator`` ``state_dict`` from a flax tree."""
    return convert_tree(params, _disc_name_map(cfg), PatchDiscriminator(cfg))
