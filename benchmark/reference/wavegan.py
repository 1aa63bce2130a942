"""Plain PyTorch reference of the WaveGAN generator (Donahue, McAuley and
Puckette, Adversarial Audio Synthesis, arXiv:1802.04208).

Written from the published layer (the authors' ``wavegan.py``), not from
the code under test: z (B, latent_dim) → ``Linear`` → reshape (B, 16, c0)
→ ReLU, then ``n_up`` stride-``stride`` transposed 1-D convolutions of
kernel length ``kernel`` with max(width, c0 / 2^(i+1)) features at level i
and one at the last, ReLU after each level but the last, tanh at the
output: (B, 16 · stride^n_up). No normalisation. c0 = width · 2^n_up / 2
(``dim_mul`` 32 at the 65,536 slice).

Each transposed convolution is TensorFlow's ``padding="SAME"``: its full
output, length (n − 1)·s + k, cropped to n·s by the padding a SAME
convolution of the same kernel and stride would take, k − s in all,
(k − s) // 2 before and the rest after: (10, 10) at k 24, (10, 11) at k 25.

Weights come as a state dict in the program's layout (``project.weight``
(16·c0, latent_dim), ``project.bias``, ``upconv{i}.weight`` (C_in, C_out,
k), ``upconv{i}.bias``), which is ``torch.nn.functional.conv_transpose1d``'s
own: the kernel is applied in the orientation the program applies it, by
construction, whatever orientation another framework stores it in.

Float32 throughout; the caller turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), or the card computes these products
in a lower precision. ``q`` rounds every product's input, weight, bias and
output: the identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def ident(x: Tensor) -> Tensor:
    return x


def n_up(model: dict) -> int:
    """The levels: 16 · stride^n_up == slice_len."""
    n, size = 0, 16
    while size < model["slice_len"]:
        size *= model["stride"]
        n += 1
    if size != model["slice_len"]:
        raise ValueError(f"slice_len {model['slice_len']} is not 16 * stride^k")
    return n


def same_crop(k: int, s: int) -> tuple[int, int]:
    """What SAME takes off the full transposed output at each end."""
    total = max(k - s, 0)
    return total // 2, total - total // 2


def pre_tanh(z: Tensor, sd: dict, model: dict, q=ident) -> Tensor:
    """The last level's output before tanh, (B, slice_len) float32."""
    n, k, s = n_up(model), model["kernel"], model["stride"]
    c0 = model["width"] * 2**n // 2
    x = q(F.linear(q(z.float()), q(sd["project.weight"]), q(sd["project.bias"])))
    x = F.relu(x.reshape(z.shape[0], 16, c0).permute(0, 2, 1))
    lo, hi = same_crop(k, s)
    for i in range(n):
        y = q(F.conv_transpose1d(q(x), q(sd[f"upconv{i}.weight"]), q(sd[f"upconv{i}.bias"]),
                                 stride=s))
        x = y[..., lo : y.shape[-1] - hi]
        if i < n - 1:
            x = F.relu(x)
    return x[:, 0]


def generate(z: Tensor, sd: dict, model: dict, q=ident) -> Tensor:
    """z (B, latent_dim) → waveform (B, slice_len) in [−1, 1], float32."""
    return torch.tanh(pre_tanh(z, sd, model, q))
