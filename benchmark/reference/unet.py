"""Plain PyTorch reference of the AdVoc U-Net generator (arXiv:1904.07944).

Written from the architecture's description, not from the code under test:
the normalised-dB magnitude's first n_freq − 1 bins, scaled to [−1, 1] and
packed ``freq_pack`` bins to a channel, go through ``depth`` stride-2 k4
convolutions (GroupNorm from the second on, LeakyReLU 0.2), a 3×3
bottleneck (ReLU), and as many ×2 k4 transposed convolutions with skip
concatenation (GroupNorm, ReLU), then a 1×1 head whose output is a residual
added to the input and clipped to [0, 1]; the Nyquist bin passes through.
The fast head (the streaming generator) stops one decoder level early and
predicts the residual's 2×2 sub-pixels with a 3×3 convolution. GroupNorm
has eps 1e-6. Weights come as a state dict with the module names of the
program's generator (``downs.i.conv``, ``downs.i.norm``, ``bottleneck``,
``ups.i.conv``, ``ups.i.norm``, ``head``): the benchmark makes the tensors
and hands the same ones to both sides.

``q`` rounds every convolution's input, kernel, bias and output and every
norm's output: the identity for the reference, a lower precision for the
control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .audio import ident

Tensor = torch.Tensor


def _conv(x, w, b, q, **kw):
    return q(F.conv2d(q(x), q(w), q(b), **kw))


def _gn(x, w, b, groups, q):
    return q(F.group_norm(x.float(), groups, w, b, eps=1e-6))


def generator(est: Tensor, sd: dict, cfg: dict, q=ident) -> Tensor:
    """(N, T, n_freq) normalised dB → repaired (N, T, n_freq), float32."""
    p, g, depth = cfg["freq_pack"], cfg["norm_groups"], cfg["depth"]
    nb = cfg["n_freq"] - 1
    n, t = est.shape[:2]
    body, nyq = est[..., :nb].float(), est[..., nb:]
    x = q((body * 2.0 - 1.0).reshape(n, t, nb // p, p).permute(0, 3, 1, 2))
    skips = []
    for i in range(depth):
        x = _conv(x, sd[f"downs.{i}.conv.weight"], sd[f"downs.{i}.conv.bias"], q,
                  stride=2, padding=1)
        if i > 0:
            x = _gn(x, sd[f"downs.{i}.norm.weight"], sd[f"downs.{i}.norm.bias"], g, q)
        x = F.leaky_relu(x, 0.2)
        skips.append(x)
    x = F.relu(_conv(x, sd["bottleneck.weight"], sd["bottleneck.bias"], q, padding=1))
    n_ups = depth - 1 if cfg["fast_head"] else depth
    for i in range(n_ups):
        x = torch.cat([x, skips[depth - 1 - i]], dim=1)
        w, b = sd[f"ups.{i}.conv.weight"], sd[f"ups.{i}.conv.bias"]
        x = q(F.conv_transpose2d(q(x), q(w), q(b), stride=2, padding=1))
        x = F.relu(_gn(x, sd[f"ups.{i}.norm.weight"], sd[f"ups.{i}.norm.bias"], g, q))
    if cfg["fast_head"]:
        d = _conv(torch.cat([x, skips[0]], dim=1), sd["head.weight"], sd["head.bias"], q,
                  padding=1)
        h, w = d.shape[2:]
        delta = d.reshape(n, 2, 2, p, h, w).permute(0, 4, 1, 5, 2, 3).reshape(n, 2 * h, 2 * w * p)
    else:
        k = sd["head.weight"].shape[-1]
        d = _conv(F.pad(x, ((k - 1) // 2, k // 2, (k - 1) // 2, k // 2)), sd["head.weight"],
                  sd["head.bias"], q)
        delta = d.permute(0, 2, 3, 1).reshape(n, t, nb)
    return torch.cat([(body + delta.float()).clamp(0.0, 1.0), nyq.float()], dim=-1)
