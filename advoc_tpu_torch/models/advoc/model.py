"""advoc U-Net generator in PyTorch: heuristic magnitude → repaired magnitude.

The port of ``advoc_tpu.models.advoc.model``, every decoder mode of
``AdvocConfig.upsample``: k4/s2 transposed convolutions (the default),
"pixelshuffle" (3×3 conv to 4F channels, then depth-to-space),
"subpixel" (one k2/s1 conv to 4F channels padded by one on each side and
the parity interleave: exactly the transposed convolution's map) and
"resize" (nearest ×2, then a 4×4 SAME conv). Layout is NCHW with the frequency bins packed into
channels: the (B, T, 512) body of the normalized-dB magnitude becomes
(B, freq_pack, T, 512/freq_pack), bin = w·freq_pack + c, as the JAX
package's NHWC (B, T, 512/p, p). The Nyquist bin passes through unchanged.

As in flax, parameters are float32 and every convolution, activation and
norm output runs in ``cfg.dtype`` (bfloat16 by default). The flax layers map
onto torch as follows (checked by ``tests/test_torch_model.py``), through
the families' shared :mod:`advoc_tpu_torch.models.layers`:

* ``Conv(k4, s2, "SAME")`` pads (1, 1) per axis on even sizes and
  ``Conv(k3, "SAME")`` (1, 1): :func:`~advoc_tpu_torch.models.layers.conv_same`.
* ``ConvTranspose(k4, s2, "SAME")`` is ``conv_transpose2d(stride=2,
  padding=1)`` with the kernel flipped spatially (flax does not transpose
  it; :mod:`.convert` does the flip):
  :func:`~advoc_tpu_torch.models.layers.conv_transpose_same`.
* ``GroupNorm`` has eps 1e-6 (torch's default is 1e-5), f32 statistics with
  var = E[x²] − E[x]², and its output in the compute dtype.
* An even ``head_kernel`` k pads as flax's SAME: (k − 1) // 2 before and
  k // 2 after (:func:`~advoc_tpu_torch.models.layers.conv_same`).

``forward(est, truncate_after=name)`` is the JAX profiling hook: it
returns ``mean(x)`` in float32 right after the named stage (``down{i}``,
``bottleneck``, ``up{i}``) and runs nothing after it.

Under a profiler every convolution (with its casts) is the range
``advoc.conv`` and every normalisation with its activation ``advoc.norm``
(:func:`~advoc_tpu_torch.utils.profiling.span`). Each ``_Down`` and ``_Up``
level normalises and activates through
:func:`~advoc_tpu_torch.models.layers.group_norm_act`: on the card without
autograd one CUDA kernel pair in the convolution's layout, else the plain
``GroupNorm`` and activation. Where the pair takes the level and the
convolution's bias is per channel of the normalised tensor (``_Down``;
``_Up`` in the ``convtranspose`` and ``resize`` modes), the level decides so
before its convolution (:func:`folds_bias`), runs it without the bias and
hands the bias to the pair, which adds it as the convolution would have:
the same bits, one pass over the activation fewer
(``_build.launches["conv_bias_folded"]``, 11 a call of the full-width
generator).

``AdvocConfig(packed_tail=True)`` computes the finest decoder level and the
1×1 head in the packed layout (B, T, W, 2f) of the JAX package
(:class:`_PackedTailUp`), with the same parameters and function.
``AdvocConfig(fast_head=True)`` (and :func:`small_config`, the streaming
generator) stops the decoder one level early and predicts the residual at
half resolution, as the JAX package does; ``packed_tail`` is then ignored.

:class:`PatchDiscriminator` is the JAX package's PatchGAN over (condition,
magnitude) pairs, the adversary of training (:mod:`advoc_tpu_torch.train.gan`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.models.layers import (
    DTYPES,
    GroupNorm,
    _conv,
    conv_same,
    conv_transpose_same,
    flax_init,
    group_norm_act,
    norm_kernel_takes,
)
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels.packed_up import packed_up_kernel, packed_up_plain
from advoc_tpu_torch.utils import profiling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdvocConfig:
    """Hyperparameters of the advoc GAN; the JAX package's fields and
    defaults, every generator mode included."""

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
        return DTYPES[self.dtype]


def folds_bias(level: _Down | _Up, x: Tensor) -> bool:
    """Whether ``level`` runs its convolution of ``x`` without the bias and
    hands the bias to the GroupNorm pair: where the bias is per channel of
    the normalised tensor (``level.per_channel_bias``) and the pair takes
    the level (:func:`~advoc_tpu_torch.models.layers.norm_kernel_takes` over
    x, the convolution and the norm)."""
    return level.per_channel_bias and norm_kernel_takes(x, level.conv, level.norm)


class _Down(nn.Module):
    """Stride-2 k4 conv → GroupNorm (not at level 0) → LeakyReLU(0.2)."""

    def __init__(self, cin: int, features: int, cfg: AdvocConfig, use_norm: bool):
        super().__init__()
        self.dtype = cfg.compute_dtype
        self.conv = nn.Conv2d(cin, features, 4, stride=2, padding=1)
        self.norm = GroupNorm(cfg.norm_groups, features, self.dtype) if use_norm else None
        self.per_channel_bias = use_norm

    def forward(self, x: Tensor) -> Tensor:
        fold = folds_bias(self, x)
        x = conv_same(x, self.conv, self.dtype, bias=not fold)
        if self.norm is None:
            return F.leaky_relu(x, 0.2)
        with profiling.span("norm"):
            return group_norm_act(x, self.norm, "leaky_relu", self.conv.bias if fold else None)


class _Up(nn.Module):
    """×2 upsampling (``cfg.upsample``) → GroupNorm → ReLU."""

    def __init__(self, cin: int, features: int, cfg: AdvocConfig):
        super().__init__()
        self.dtype, self.mode, self.features = cfg.compute_dtype, cfg.upsample, features
        if self.mode == "convtranspose":
            self.conv = nn.ConvTranspose2d(cin, features, 4, stride=2, padding=1)
        elif self.mode == "pixelshuffle":
            self.conv = nn.Conv2d(cin, 4 * features, 3)
        elif self.mode == "subpixel":
            self.conv = nn.Conv2d(cin, 4 * features, 2)
        elif self.mode == "resize":
            self.conv = nn.Conv2d(cin, features, 4)
        else:
            raise ValueError(f"unknown upsample mode {self.mode!r}")
        self.norm = GroupNorm(cfg.norm_groups, features, self.dtype)
        # The two depth-to-space modes' bias is per channel of the
        # convolution's 4F outputs, before the shuffle.
        self.per_channel_bias = self.mode in ("convtranspose", "resize")

    def forward(self, x: Tensor) -> Tensor:
        f, dt = self.features, self.dtype
        fold = folds_bias(self, x)
        if self.mode == "convtranspose":
            x = conv_transpose_same(x, self.conv, dt, bias=not fold)
        elif self.mode == "pixelshuffle":
            # Depth-to-space: channel (dy·2 + dx)·F + c of pixel (h, w) is
            # output pixel (2h + dy, 2w + dx), channel c (flax's reshape).
            z = conv_same(x, self.conv, dt)
            b, _, h, w = z.shape
            x = z.reshape(b, 2, 2, f, h, w).permute(0, 3, 4, 1, 5, 2).reshape(b, f, 2 * h, 2 * w)
        elif self.mode == "subpixel":
            # Channel (p·2 + q)·F + c of the k2 window at (m, n) (windows
            # −1 … H−1, so one row and column of padding on each side) is
            # output pixel (2m + p, 2n + q) of the transposed convolution,
            # the p = 0 rows from windows {m − 1, m}, p = 1 from {m, m + 1}.
            z = _conv(F.conv2d, x, self.conv, dt, padding=1)
            b, _, h1, w1 = z.shape
            h, w = h1 - 1, w1 - 1
            z = z.reshape(b, 2, 2, f, h1, w1)
            top = torch.stack([z[:, 0, 0, :, :h, :w], z[:, 0, 1, :, :h, 1:]], dim=-1)
            bot = torch.stack([z[:, 1, 0, :, 1:, :w], z[:, 1, 1, :, 1:, 1:]], dim=-1)
            x = torch.stack([top, bot], dim=3).reshape(b, f, 2 * h, 2 * w)
        else:  # resize: nearest ×2 (each pixel repeated, as jax.image.resize), 4×4 SAME conv
            x = conv_same(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3),
                          self.conv, dt, bias=not fold)
        with profiling.span("norm"):
            return group_norm_act(x, self.norm, "relu", self.conv.bias if fold else None)


class _PackedTailUp(nn.Module):
    """The finest :class:`_Up` level in the packed layout of the JAX
    package's ``_PackedTailUp``: NHWC (B, H, W, cin) in, (B, 2H, W, 2f) out,
    lane q·f + c of row 2m + p holding output pixel (2m + p, 2n + q),
    channel c. Same parameters (``conv``, ``norm``) and function as ``_Up``.

    The transpose-conv, its bias and the per-lane Σy, Σy² come from kernel
    B4 (:mod:`advoc_tpu_torch.ops.kernels.packed_up`) whenever the compute
    dtype is bfloat16 and ``x`` is a CUDA tensor, with tm the largest of 16,
    8, 4, 2, 1 that divides H and H // 2. The JAX package also asks
    (H // 2) % 8 == 0 (``model.py:294-298``), a limit of the TPU's tiles
    that the CUDA kernel does not have. Otherwise (a CPU tensor, or
    float32 compute, the JAX XLA branch) from its plain version in the
    compute dtype. The kernel takes cin and f that are multiples of 8, as
    every documented width (16, 24, 32, 64) gives; other widths raise on
    the card.
    GroupNorm then projects the lane sums onto groups (the same element
    sets as the standard layout), folds its affine into x·A + B per
    (batch, lane) in f32 and casts to the compute dtype; then ReLU.
    """

    def __init__(self, cin: int, features: int, cfg: AdvocConfig):
        super().__init__()
        self.dtype, self.features = cfg.compute_dtype, features
        self.conv = nn.ConvTranspose2d(cin, features, 4, stride=2, padding=1)
        self.norm = GroupNorm(cfg.norm_groups, features, self.dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, _ = x.shape
        f, groups = self.features, self.norm.groups
        # The converter flips the flax kernel; B4 takes flax's (4, 4, cin, f).
        with profiling.span("conv"):
            wt = self.conv.weight.flip(2, 3).permute(2, 3, 0, 1)
            if self.dtype == torch.bfloat16 and x.is_cuda:
                if _build.records((x, *self.parameters())):
                    raise NotImplementedError("packed_tail (kernel B4) has no backward: call it "
                                              "under no_grad, or train with packed_tail=False")
                tm = next(t for t in (16, 8, 4, 2, 1) if h % t == 0 and (h // 2) % t == 0)
                y, s1, s2 = packed_up_kernel(x.to(self.dtype).contiguous(), wt, self.conv.bias,
                                             f=f, tm=tm, with_stats=True)
            else:  # tm does not change the function; 1 divides every H // 2
                y, s1, s2 = packed_up_plain(x.to(self.dtype), wt, self.conv.bias, f=f, tm=1,
                                            with_stats=True)
        with profiling.span("norm"):
            lane_group = (torch.arange(groups, device=x.device)
                          .repeat_interleave(f // groups).repeat(2))
            onehot = F.one_hot(lane_group, groups).to(torch.float32)  # (2f, G)
            count = 2 * h * w * 2 * (f // groups)
            mean = (s1 @ onehot) / count
            var = (s2 @ onehot) / count - mean * mean
            inv = torch.rsqrt(var + 1e-6)
            scale = (inv @ onehot.T) * self.norm.weight.repeat(2)  # (B, 2f)
            shift = self.norm.bias.repeat(2) - (mean @ onehot.T) * scale
            # Out of place: y (and Σy, Σy² from it) stays as autograd saved it.
            yf = torch.addcmul(shift[:, None, None], y.to(torch.float32), scale[:, None, None])
            return F.relu(yf.to(self.dtype))


class AdvocGenerator(nn.Module):
    """U-Net over the normalized-dB heuristic estimate, residual head.

    (B, T, n_freq) in [0, 1] → (B, T, n_freq) = clip(est + Δ) on the first
    n_freq − 1 bins, the Nyquist bin passed through.
    """

    def __init__(self, cfg: AdvocConfig = AdvocConfig()):
        super().__init__()
        # As in the JAX generator, fast_head has no finest decoder level, so
        # packed_tail is ignored under it.
        self.packed_tail = cfg.packed_tail and not cfg.fast_head
        if self.packed_tail and (cfg.upsample != "convtranspose" or cfg.head_kernel != 1):
            raise ValueError(
                "packed_tail requires upsample='convtranspose' and "
                f"head_kernel=1 (got {cfg.upsample!r}, {cfg.head_kernel})"
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
        n_ups = len(feats) - 1 if cfg.fast_head else len(feats)
        for i, f in enumerate(list(reversed(feats))[:n_ups]):
            skip_ch = feats[len(feats) - 1 - i]
            up = _PackedTailUp if self.packed_tail and i == len(feats) - 1 else _Up
            self.ups.append(up(x_ch + skip_ch, f, cfg))
            x_ch = f
        if cfg.fast_head:
            # Half-resolution head on [x | skips[0]]: a 3×3 conv to the 2×2
            # sub-pixels of p packed bins, channel order (dy, dx, k).
            self.head = nn.Conv2d(x_ch + feats[0], 4 * p, 3, padding=1)
            return
        k = cfg.head_kernel
        self.head = nn.Conv2d(x_ch, p, k)  # conv_same pads it as flax's SAME

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, est: Tensor, truncate_after: str | None = None) -> Tensor:
        cfg = self.cfg

        def cut(x: Tensor, name: str) -> Tensor | None:
            return x.to(torch.float32).mean() if name == truncate_after else None

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
        for i, down in enumerate(self.downs):
            x = down(x)
            skips.append(x)
            if (c := cut(x, f"down{i}")) is not None:
                return c
        x = F.relu(conv_same(x, self.bottleneck, dt))
        if (c := cut(x, "bottleneck")) is not None:
            return c
        for i, up in enumerate(self.ups):
            skip = skips[len(skips) - 1 - i].to(x.dtype)
            if isinstance(up, _PackedTailUp):
                # The concat written directly in NHWC order, B4's input.
                cat = x.new_empty((b, x.shape[2], x.shape[3], x.shape[1] + skip.shape[1]))
                cat[..., : x.shape[1]] = x.permute(0, 2, 3, 1)
                cat[..., x.shape[1] :] = skip.permute(0, 2, 3, 1)
                x = up(cat)
            else:
                x = up(torch.cat([x, skip], dim=1))
            if (c := cut(x, f"up{i}")) is not None:
                return c
        if cfg.fast_head:
            d = conv_same(torch.cat([x, skips[0].to(x.dtype)], dim=1), self.head, dt)
            h, w = d.shape[2:]
            # Depth-to-space: channel dy·2p + dx·p + k of half-res pixel
            # (h, w) is frame 2h + dy, bin (2w + dx)·p + k.
            delta = (d.to(torch.float32).reshape(b, 2, 2, p, h, w)
                     .permute(0, 4, 1, 5, 2, 3).reshape(b, 2 * h, 2 * w * p))
        elif self.packed_tail:
            # 1×1 head in the packed layout: the block-diagonal (2f → 2p)
            # product maps lane q·f + c to lane q·p + k with the shared
            # weights, and flattening (w, q, k) is the bin axis.
            f = x.shape[-1] // 2
            with profiling.span("conv"):
                wh = self.head.weight[:, :, 0, 0].T  # (f, p)
                wblk = wh.new_zeros((2 * f, 2 * p))
                wblk[:f, :p] = wh
                wblk[f:, p:] = wh
                delta = x @ wblk.to(dt) + self.head.bias.repeat(2).to(dt)
            delta = delta.to(torch.float32).reshape(b, t, n_bins)
        else:
            delta = conv_same(x, self.head, dt).to(torch.float32)  # (B, p, T, W)
            delta = delta.permute(0, 2, 3, 1).reshape(b, t, n_bins)
        # jnp.clip's gradient, half at a tie (torch.clamp passes all of it):
        # body + delta is exactly 0 where the estimate is at the dB floor and
        # the head's output is its zero bias (at initialization, in quiet bins).
        x = body + delta
        repaired = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
        return torch.cat([repaired, nyquist], dim=-1)


def small_config(**overrides) -> AdvocConfig:
    """AdVoc-small, the streaming generator: width 24, depth 6, 64-frame
    chunks, the half-resolution head (the JAX package's ``small_config``)."""
    base = dict(width=24, depth=6, disc_width=32, n_frames=64, fast_head=True)
    base.update(overrides)
    return AdvocConfig(**base)


class PatchDiscriminator(nn.Module):
    """PatchGAN over (condition, magnitude) pairs, the JAX package's.

    ``condition`` (B, T, n_freq), or (B, T, n_mels) under
    ``condition_on="mel"``, resampled linearly onto the n_freq axis, and
    ``mag`` (B, T, n_freq), both normalized dB in [0, 1]. Returns the patch
    logits in flax's layout, (B, T / 2^(L−1), W / 2^(L−1), 1) with
    W = (n_freq − 1) / freq_pack.

    ``stack([cond, mag]) · 2 − 1`` without the Nyquist bin, its bins packed
    into channels as in flax (channel k·2 + c of packed column w holds bin
    w·p + k of input c, cond first), then ``disc_layers`` k4 convs of
    width min(disc_width·2^i, 8·disc_width), stride 2 but the last (1), each
    followed by GroupNorm (i > 0, in the compute dtype) and LeakyReLU(0.2);
    then a float32 k4/s1 logit conv. Every conv pads as flax's "SAME".
    """

    def __init__(self, cfg: AdvocConfig = AdvocConfig()):
        super().__init__()
        p = cfg.freq_pack
        if (cfg.n_freq - 1) % p:
            raise ValueError(f"freq_pack {p} must divide n_freq − 1 = {cfg.n_freq - 1}")
        self.cfg = cfg
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleDict()  # keyed by layer, as flax's norm{i}
        cin = 2 * p
        for i in range(cfg.disc_layers):
            f = min(cfg.disc_width * 2**i, cfg.disc_width * 8)
            stride = 2 if i < cfg.disc_layers - 1 else 1
            self.convs.append(nn.Conv2d(cin, f, 4, stride=stride))
            if i > 0:
                self.norms[str(i)] = GroupNorm(cfg.norm_groups, f, cfg.compute_dtype)
            cin = f
        self.logit = nn.Conv2d(cin, 1, 4)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (:func:`~advoc_tpu_torch.models.layers.flax_init`)."""
        flax_init(self, generator)

    def forward(self, condition: Tensor, mag: Tensor) -> Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        if condition.shape[-1] != mag.shape[-1]:
            # jax.image.resize(method="linear") when upsampling: half-pixel
            # centres, the edge samples take the edge bins (its weights
            # renormalized there), as F.interpolate's clamped source index.
            condition = F.interpolate(condition, size=mag.shape[-1], mode="linear",
                                      align_corners=False)
        b, t = mag.shape[:2]
        p, n_bins = cfg.freq_pack, cfg.n_freq - 1
        x = torch.stack([condition, mag], dim=-1)[..., :n_bins, :] * 2.0 - 1.0
        x = x.to(dt).reshape(b, t, n_bins // p, 2 * p).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            x = conv_same(x, conv, dt)
            if i > 0:
                x = self.norms[str(i)](x)
            x = F.leaky_relu(x, 0.2)
        logits = conv_same(x.to(torch.float32), self.logit, torch.float32)
        return logits.permute(0, 2, 3, 1)
