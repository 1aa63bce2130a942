"""advoc U-Net generator in PyTorch: heuristic magnitude → repaired magnitude.

The port of ``advoc_tpu.models.advoc.model`` at its default decoder (k4/s2
transposed convolutions). Layout is NCHW with the frequency bins packed into
channels: the (B, T, 512) body of the normalized-dB magnitude becomes
(B, freq_pack, T, 512/freq_pack), bin = w·freq_pack + c, as the JAX
package's NHWC (B, T, 512/p, p). The Nyquist bin passes through unchanged.

As in flax, parameters are float32 and every convolution, activation and
norm output runs in ``cfg.dtype`` (bfloat16 by default). The flax layers map
onto torch as follows (checked by ``tests/test_torch_model.py``):

* ``Conv(k4, s2, "SAME")`` pads (1, 1) per axis: ``conv2d(stride=2,
  padding=1)``; ``Conv(k3, "SAME")``: ``padding=1``.
* ``ConvTranspose(k4, s2, "SAME")`` is ``conv_transpose2d(stride=2,
  padding=1)`` with the kernel flipped spatially (flax does not transpose
  it); :mod:`.convert` does the flip.
* ``GroupNorm`` has eps 1e-6 (torch's default is 1e-5), f32 statistics with
  var = E[x²] − E[x]², and its output in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdvocConfig:
    """Hyperparameters of the advoc GAN; the JAX package's fields and
    defaults. Of the generator's modes only the default one is ported: the
    others raise ``NotImplementedError`` (ROADMAP.md queue A)."""

    n_frames: int = 256
    n_freq: int = 513
    width: int = 64
    depth: int = 6
    disc_width: int = 64
    disc_layers: int = 4
    norm_groups: int = 8
    dtype: str = "bfloat16"
    upsample: str = "convtranspose"
    fast_head: bool = False
    freq_pack: int = 2
    head_kernel: int = 1
    gan_type: str = "lsgan"
    l1_weight: float = 100.0
    gp_weight: float = 10.0
    condition_on: str = "estimate"
    packed_tail: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]


class GroupNorm(nn.Module):
    """flax ``GroupNorm``: eps 1e-6, f32 statistics (fast variance, clamped
    at 0), output cast to ``dtype``. Parameters ``weight``/``bias`` (f32)."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        b, c = x.shape[:2]
        xf = x.to(torch.float32)
        g = xf.reshape(b, self.groups, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        shape = (b, c) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(c // self.groups, 1).reshape(shape)
        inv = torch.rsqrt(var + 1e-6).repeat_interleave(c // self.groups, 1).reshape(shape)
        w = self.weight.reshape((1, c) + (1,) * (x.ndim - 2))
        bias = self.bias.reshape(w.shape)
        return ((xf - mean) * (inv * w) + bias).to(self.dtype)


def _conv(x: Tensor, conv: nn.Conv2d, dtype: torch.dtype, **kw) -> Tensor:
    """flax ``Conv(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    stride=conv.stride, padding=conv.padding, **kw)


class _Down(nn.Module):
    """Stride-2 k4 conv → GroupNorm (not at level 0) → LeakyReLU(0.2)."""

    def __init__(self, cin: int, features: int, cfg: AdvocConfig, use_norm: bool):
        super().__init__()
        self.dtype = cfg.compute_dtype
        self.conv = nn.Conv2d(cin, features, 4, stride=2, padding=1)
        self.norm = GroupNorm(cfg.norm_groups, features, self.dtype) if use_norm else None

    def forward(self, x: Tensor) -> Tensor:
        x = _conv(x, self.conv, self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, 0.2)


class _Up(nn.Module):
    """×2 k4/s2 transposed conv → GroupNorm → ReLU."""

    def __init__(self, cin: int, features: int, cfg: AdvocConfig):
        super().__init__()
        if cfg.upsample != "convtranspose":
            raise NotImplementedError(
                f"upsample={cfg.upsample!r} is not ported yet (ROADMAP.md queue A)"
            )
        self.dtype = cfg.compute_dtype
        self.conv = nn.ConvTranspose2d(cin, features, 4, stride=2, padding=1)
        self.norm = GroupNorm(cfg.norm_groups, features, self.dtype)

    def forward(self, x: Tensor) -> Tensor:
        c = self.conv
        x = F.conv_transpose2d(x.to(self.dtype), c.weight.to(self.dtype),
                               c.bias.to(self.dtype), stride=2, padding=1)
        return F.relu(self.norm(x))


class AdvocGenerator(nn.Module):
    """U-Net over the normalized-dB heuristic estimate, residual head.

    (B, T, n_freq) in [0, 1] → (B, T, n_freq) = clip(est + Δ) on the first
    n_freq − 1 bins, the Nyquist bin passed through.
    """

    def __init__(self, cfg: AdvocConfig = AdvocConfig()):
        super().__init__()
        if cfg.fast_head:
            raise NotImplementedError("fast_head is not ported yet (ROADMAP.md queue A)")
        if cfg.packed_tail:
            raise NotImplementedError(
                "packed_tail is not ported yet (ROADMAP.md queue A; kernel B4)"
            )
        p = cfg.freq_pack
        if (cfg.n_freq - 1) % p:
            raise ValueError(f"freq_pack {p} must divide n_freq − 1 = {cfg.n_freq - 1}")
        self.cfg = cfg
        feats = [min(cfg.width * 2**i, cfg.width * 8) for i in range(cfg.depth)]
        self.downs = nn.ModuleList()
        cin = p
        for i, f in enumerate(feats):
            self.downs.append(_Down(cin, f, cfg, use_norm=i > 0))
            cin = f
        self.bottleneck = nn.Conv2d(cin, feats[-1], 3, padding=1)
        self.ups = nn.ModuleList()
        x_ch = feats[-1]
        for i, f in enumerate(reversed(feats)):
            skip_ch = feats[len(feats) - 1 - i]
            self.ups.append(_Up(x_ch + skip_ch, f, cfg))
            x_ch = f
        k = cfg.head_kernel
        if k % 2 == 0:
            raise NotImplementedError(
                f"head_kernel={k}: flax pads an even kernel asymmetrically; not ported yet"
            )
        self.head = nn.Conv2d(x_ch, p, k, padding=k // 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun_normal kernels (truncated normal at ±2σ,
        σ = 1/√fan_in / 0.8796), zero biases, GroupNorm scale 1, bias 0.
        fan_in = kh·kw·cin, for the transposed convs too, as in flax."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    kh, kw = m.kernel_size
                    cin = m.in_channels
                    std = 1.0 / math.sqrt(kh * kw * cin) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.bias.zero_()
                elif isinstance(m, GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def forward(self, est: Tensor, truncate_after: str | None = None) -> Tensor:
        if truncate_after is not None:
            raise NotImplementedError("truncate_after is not ported (profiling hook)")
        cfg = self.cfg
        if est.shape[-1] != cfg.n_freq:
            raise ValueError(f"expected {cfg.n_freq} bins, got {est.shape[-1]}")
        dt = cfg.compute_dtype
        p = cfg.freq_pack
        n_bins = cfg.n_freq - 1
        body, nyquist = est[..., :n_bins], est[..., n_bins:]
        b, t = body.shape[:2]
        x = (body * 2.0 - 1.0).to(dt)
        x = x.reshape(b, t, n_bins // p, p).permute(0, 3, 1, 2)  # (B, p, T, W)
        skips = []
        for down in self.downs:
            x = down(x)
            skips.append(x)
        x = F.relu(_conv(x, self.bottleneck, dt))
        for i, up in enumerate(self.ups):
            x = up(torch.cat([x, skips[len(skips) - 1 - i].to(x.dtype)], dim=1))
        delta = _conv(x, self.head, dt).to(torch.float32)  # (B, p, T, W)
        delta = delta.permute(0, 2, 3, 1).reshape(b, t, n_bins)
        repaired = torch.clamp(body + delta, 0.0, 1.0)
        return torch.cat([repaired, nyquist], dim=-1)


class PatchDiscriminator(nn.Module):
    """Not ported yet: training is ROADMAP.md queue A7."""

    def __init__(self, cfg: AdvocConfig = AdvocConfig()):
        raise NotImplementedError("PatchDiscriminator is not ported yet (ROADMAP.md queue A)")
