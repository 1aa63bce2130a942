"""Plain PyTorch reference of BigVGAN's generator (Lee, Ping, Ginsburg,
Catanzaro and Yoon, BigVGAN: A Universal Neural Vocoder with Large-Scale
Training, arXiv:2206.04658) and of its log-mel.

Written from the published modules (NVIDIA's ``github.com/NVIDIA/BigVGAN``:
``bigvgan.py`` ``BigVGAN`` and ``AMPBlock1``, ``activations.py``
``SnakeBeta``, ``alias_free_activation/torch/{filter,resample,act}.py``,
``meldataset.py`` ``mel_spectrogram``), not from the code under test:

* ``conv_pre`` (k7, padding 3); a level per upsample rate u: a transposed
  convolution of kernel k and padding (k − u) / 2 to half the channels,
  then the mean of one AMPBlock1 per resblock kernel size;
  ``activation_post``, ``conv_post`` (k7, padding 3), tanh.
* AMPBlock1: for each dilation d, x ← x + conv2(act2(conv1_d(act1(x)))),
  conv1_d of dilation d and padding d·(k − 1)/2, conv2 of dilation 1.
* Activation1d: ``UpSample1d(2)`` (replicate-pad 5, depthwise
  ``conv_transpose1d`` of stride 2 with the 12-tap Kaiser-sinc filter,
  times 2, 15 samples cut off each end), SnakeBeta x + 1/(e^β + 1e-9) ·
  sin²(e^α · x), ``DownSample1d(2)`` (replicate-pad (5, 6), depthwise
  ``conv1d`` of stride 2 with the filter of cutoff 0.25, half-width 0.3).
* The log-mel: reflect-pad (n_fft − hop) / 2, ``torch.stft`` without
  centring under a periodic Hann window, √(re² + im² + 1e-9), the Slaney
  filterbank (librosa's ``mel`` with ``norm="slaney"``, :mod:`.audio`'s),
  ln(max(·, 1e-5)).

Departures from NVIDIA's code: weight norm is folded (``weight`` is what
``remove_weight_norm`` leaves); the state dict is the program's
(``ups.<i>`` where NVIDIA has ``ups.<i>.0``); the filter is computed in
float64 and rounded to float32 (NVIDIA computes it in float32: within an
ulp); the Snake is on the log scale only (the configuration's
``snake_logscale``).

Float32 throughout; :func:`generate` turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), or the card would compute these
products in a lower precision. ``q`` rounds every convolution's input, weight, bias
and output: the identity for the reference, a lower precision for the
control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .audio import Audio, mel_basis

Tensor = torch.Tensor
TAPS, CUTOFF, HALF_WIDTH = 12, 0.25, 0.3  # UpSample1d / DownSample1d at ratio 2


def ident(x: Tensor) -> Tensor:
    return x


def kaiser_sinc(cutoff: float = CUTOFF, half_width: float = HALF_WIDTH,
                taps: int = TAPS) -> Tensor:
    """``kaiser_sinc_filter1d``: (taps,) float32, summing to 1."""
    half = taps // 2
    att = 2.285 * (half - 1) * np.pi * 4 * half_width + 7.95
    if att > 50.0:
        beta = 0.1102 * (att - 8.7)
    elif att >= 21.0:
        beta = 0.5842 * (att - 21.0) ** 0.4 + 0.07886 * (att - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(taps, periodic=False, beta=beta, dtype=torch.float64)
    if taps % 2 == 0:
        t = torch.arange(-half, half, dtype=torch.float64) + 0.5
    else:
        t = torch.arange(taps, dtype=torch.float64) - half
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (h / h.sum()).float()


def activation(x: Tensor, alpha: Tensor, beta: Tensor, taps: Tensor) -> Tensor:
    """Activation1d(SnakeBeta(alpha_logscale=True)) of (B, C, T), float32."""
    c, k = x.shape[1], taps.shape[0]
    f = taps.to(x.device).reshape(1, 1, k).expand(c, 1, k)
    pad = k // 2 - 1
    y = 2 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), f, stride=2, groups=c)
    lo, hi = pad * 2 + (k - 2) // 2, pad * 2 + (k - 1) // 2
    y = y[..., lo : y.shape[-1] - hi]
    a, b = alpha.exp()[None, :, None], beta.exp()[None, :, None]
    y = y + 1.0 / (b + 1e-9) * torch.sin(y * a) ** 2
    return F.conv1d(F.pad(y, (k // 2 - 1, k // 2), mode="replicate"), f, stride=2, groups=c)


def conv(x: Tensor, sd: dict, name: str, q=ident, dilation: int = 1) -> Tensor:
    """A same-length Conv1d of odd kernel k: padding d·(k − 1)/2."""
    w = sd[f"{name}.weight"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return q(F.conv1d(q(x), q(w), q(sd[f"{name}.bias"]), padding=pad, dilation=dilation))


def n_blocks(model: dict) -> int:
    return len(model["resblock_kernel_sizes"])


def generate(mel: Tensor, sd: dict, model: dict, q=ident, taps: Tensor | None = None) -> Tensor:
    """log-mel (B, num_mels, T) → waveform (B, T·Π upsample_rates) in
    [−1, 1], float32."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    taps = kaiser_sinc() if taps is None else taps
    x = conv(mel.float(), sd, "conv_pre", q)
    nk = n_blocks(model)
    for i, (u, k) in enumerate(zip(model["upsample_rates"], model["upsample_kernel_sizes"])):
        x = q(F.conv_transpose1d(q(x), q(sd[f"ups.{i}.weight"]), q(sd[f"ups.{i}.bias"]),
                                 stride=u, padding=(k - u) // 2))
        xs = None
        for j, dils in enumerate(model["resblock_dilation_sizes"]):
            p = f"resblocks.{i * nk + j}"
            h = x
            for r, d in enumerate(dils):
                a1, a2 = f"{p}.activations.{2 * r}.act", f"{p}.activations.{2 * r + 1}.act"
                xt = activation(h, sd[f"{a1}.alpha"], sd[f"{a1}.beta"], taps)
                xt = conv(xt, sd, f"{p}.convs1.{r}", q, dilation=d)
                xt = activation(xt, sd[f"{a2}.alpha"], sd[f"{a2}.beta"], taps)
                h = h + conv(xt, sd, f"{p}.convs2.{r}", q)
            xs = h if xs is None else xs + h
        x = xs / nk
    x = activation(x, sd["activation_post.act.alpha"], sd["activation_post.act.beta"], taps)
    return torch.tanh(conv(x, sd, "conv_post", q)[:, 0])


def log_mel(wav: Tensor, a: Audio) -> Tensor:
    """Waveform (…, L) → ln mel (…, n_mels, L // hop) at BigVGAN's settings
    (``a``: n_fft, hop, the filterbank's band and size)."""
    lead = wav.shape[:-1]
    x = wav.reshape(-1, wav.shape[-1]).float()
    pad = (a.n_fft - a.hop_length) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(a.n_fft, device=x.device)
    spec = torch.stft(x, a.n_fft, hop_length=a.hop_length, win_length=a.n_fft, window=window,
                      center=False, return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.as_tensor(mel_basis(a), dtype=torch.float32, device=x.device)
    mel = torch.log(torch.clamp(fb @ mag, min=a.amp_floor))
    return mel.reshape(lead + mel.shape[-2:])
