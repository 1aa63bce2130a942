"""The precisions a control computes in: each rounds a float32 tensor to the
values of a lower format and returns them as float32, so that a float32
product of two rounded operands is that format's product accumulated in
float32 (TF32 off)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def fp8(x: Tensor) -> Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at 448), as
    a per-tensor-scaled fp8 GEMM takes its operands."""
    x = x.float()
    s = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s

