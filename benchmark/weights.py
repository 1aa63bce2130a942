"""Random weights for a module's state dict, made on the device from a seed.

One ``torch.randn`` call on the device's own generator fills every tensor,
which is then scaled by its role: kernels by 1/√fan_in (the head's by a tenth
more, so that the generator predicts a small residual, as a trained one
does), biases by 0.02, norm scales to 1 ± 0.1 and norm shifts by 0.1. Both
the program and the reference get these same float32 tensors.
"""

from __future__ import annotations

import math

import torch


def make(shapes: dict[str, torch.Size], seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at : at + n].reshape(shape)
        at += n
        parts = name.split(".")
        norm = any(p.startswith("norm") for p in parts)
        if norm and parts[-1] == "weight":
            x = 1.0 + 0.1 * x
        elif norm:
            x = 0.1 * x
        elif parts[-1] == "bias":
            x = 0.02 * x
        else:
            x = x / math.sqrt(n / shape[0]) * (0.1 if "head" in parts[:2] else 1.0)
        out[name] = x.contiguous()
    return out
