"""Fused featurizer, waveform → r9y9 normalized mel: a CUDA kernel and its plain version.

Replaces ``advoc_tpu/ops/pallas/featurizer.py:fused_melspec`` (B3), the JAX
package's one-pass featurizer. Its function: reflect-pad the audio by
n_fft/2, cut it into hop blocks, and for frame i take the windowed DFT of
blocks i..i+3 as four banded (frames, hop) @ (hop, F_KEPT) products (the
Hann window folded into the cos/sin maps, only the F_KEPT = 384 bins the
mel filterbank can reach), then |·|, the 80-band mel, dB, normalize and
clip. It yields L//hop frames, not 1 + L//hop.

Design on Hopper (``csrc/featurizer.cu``): one CTA per (row, frame tile):
128 frames where those tiles fill the card and the window fits (hop ≤ 256),
64 otherwise. The tile's (frames + 3) hop blocks of audio are copied into
shared memory once (the reflect padding done by the index map), each
zero-padded to hb = hop rounded up to 16 samples, so frames never exist in
device memory: frame t's band k is hop block t + k, the banded form of the
JAX kernel. Any hop up to 736 runs (the window fills shared memory). Every product runs on the tensor cores (``wgmma``) in 3xTF32:
operands are split into a TF32 big part (round to nearest, ties away) and
the TF32 rounding of the rest, and big·big + big·small + small·big is
summed in f32, which keeps fp32 accuracy. bf16 with one hi/lo split does
not: on a quiet stretch it reaches the 1e-3 gate in normalized units
(``tests/test_torch_featurizer.py::test_bf16_hi_lo_split_is_not_enough``),
because the featurizer's dB scale turns the cancellation in quiet bins into
large errors at reduced precision (the JAX kernel records 0.22 for the
MXU's bf16 default). The host stores the split maps K-major,
(768, 4 hb), zero in each band's padding: each 128-row chunk is 64 cosine bins then the same 64 sine
bins, so a thread's accumulator holds both parts of its bins and |X| is
taken in registers. The mel fold is a second such product whose A operand
is |X| straight from that accumulator, against the split filterbank with
each 8-bin group reordered (:data:`MEL_K_ORDER`, :func:`_tc_operands`); only
the (128, 80) dB / normalize / clip epilogue is written.

Bound: operations. Per frame 2·2·n_fft·F_KEPT + 2·F_KEPT·80 FLOP; at
B=128 × 65536 samples (32768 frames) ≈ 53.6 GFLOP against ≈ 47 MB of audio,
maps and mel, so ≈ 0.054 ms at the H100's 989 TFLOP/s dense bf16 rate.
3xTF32 does every product three times at the 495 TFLOP/s TF32 rate: a
ceiling of ≈ 0.32 ms for this form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from advoc_tpu_torch.ops import reference as ref
from advoc_tpu_torch.ops.cache import device_cache
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.reference import AudioParams, DEFAULT_PARAMS

Tensor = torch.Tensor

F_KEPT = 384  # rFFT bins kept (mel support ends at bin 353 for fmax=7600)
MEL_PAD = 128  # mel map padded to 128 columns, as in the JAX package


@functools.lru_cache(maxsize=4)
def _kernel_consts(params: AudioParams):
    """(W_cos, W_sin, mel_T) float32, window folded into the DFT matrices:
    (n_fft, F_KEPT), (n_fft, F_KEPT), (F_KEPT, MEL_PAD)."""
    n_fft, hop = params.n_fft, params.hop_length
    assert n_fft % hop == 0 and n_fft // hop == 4, "kernel assumes 4 bands"
    win = ref.hann_window(params.win_length)
    if params.win_length < n_fft:
        lpad = (n_fft - params.win_length) // 2
        win = np.pad(win, (lpad, n_fft - params.win_length - lpad))
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(F_KEPT, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w_cos = (win[:, None] * np.cos(ang)).astype(np.float32)
    w_sin = (win[:, None] * -np.sin(ang)).astype(np.float32)
    fb = ref.create_mel_filterbank(params)
    assert np.allclose(fb[:, F_KEPT:], 0.0), "mel filterbank has support above the kept bins"
    mel_t = np.zeros((F_KEPT, MEL_PAD), np.float32)
    mel_t[:, : params.n_mels] = fb[:, :F_KEPT].T
    return w_cos, w_sin, mel_t


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, by integer rounding of the bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """a ≈ big + small, both TF32: the 3xTF32 operands."""
    big = _tf32_rna(a)
    return big, _tf32_rna(np.asarray(a, np.float32) - big)


# Each 8-bin group of the kernel's filterbank operand in this order: the
# DFT accumulator gives a thread bins 2t and 2t + 1 of a group, which the
# mel product reads as the fragment's columns t and t + 4.
MEL_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def block_width(hop: int) -> int:
    """The kernel's hop block: hop rounded up to a 16-sample K slice."""
    return -(-hop // 16) * 16


def _tc_operands(params: AudioParams) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's B operands in float32, K-major: the maps (2·F_KEPT,
    4·hb), rows 128c .. 128c + 63 W_cos's bins 64c .. 64c + 63 and rows
    128c + 64 .. 128c + 127 W_sin's same bins, band k's samples at columns
    k·hb .. k·hb + hop - 1 and zero up to (k + 1)·hb; the filterbank (80,
    F_KEPT), each 8-bin group in MEL_K_ORDER."""
    w_cos, w_sin, mel_t = _kernel_consts(params)
    hop = params.hop_length
    maps = np.stack([w_cos.T.reshape(F_KEPT // 64, 64, 4, hop),
                     w_sin.T.reshape(F_KEPT // 64, 64, 4, hop)], axis=1)
    maps = np.pad(maps, [(0, 0)] * 4 + [(0, block_width(hop) - hop)])
    order = (np.arange(F_KEPT) // 8) * 8 + np.tile(MEL_K_ORDER, F_KEPT // 8)
    return maps.reshape(2 * F_KEPT, -1), np.ascontiguousarray(mel_t[order, :80].T)


@functools.lru_cache(maxsize=4)
def _tc_consts(params: AudioParams) -> tuple[np.ndarray, ...]:
    """What the kernel reads: the big and small TF32 parts of the maps, then
    of the filterbank (:func:`_tc_operands`)."""
    maps, mel = _tc_operands(params)
    return (*_tf32_split(maps), *_tf32_split(mel))


@device_cache(maxsize=8)
def _consts_on(params: AudioParams, device: torch.device) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(torch.as_tensor(c, device=device) for c in _kernel_consts(params))


@device_cache(maxsize=8)
def _tc_consts_on(params: AudioParams, device: torch.device) -> tuple[Tensor, ...]:
    return tuple(torch.as_tensor(c, device=device) for c in _tc_consts(params))


def _check(wav: Tensor, params: AudioParams) -> None:
    if params.n_fft != 4 * params.hop_length:
        raise ValueError("the fused featurizer needs n_fft == 4 · hop_length")
    if wav.ndim < 1 or wav.shape[-1] <= params.n_fft // 2:
        raise ValueError(
            f"the fused featurizer reflect-pads by n_fft/2 = {params.n_fft // 2}: "
            f"needs more than that many samples, got shape {tuple(wav.shape)}"
        )


def _normalize(mel: Tensor, params: AudioParams) -> Tensor:
    db = 20.0 * torch.log10(torch.clamp(mel, min=params.amp_floor)) - params.ref_level_db
    return torch.clamp((db - params.min_level_db) / -params.min_level_db, 0.0, 1.0)


def fused_melspec_plain(wav: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """The kernel's function in plain PyTorch fp32: (..., L) → (..., L//hop, n_mels).

    Reflect pad n_fft/2 on both sides, zero pad to whole hop blocks, frames
    as four banded products over hop blocks, then |·|, mel, dB, normalize
    and clip. The CPU path of :func:`fused_melspec_kernel` and the
    reference the kernel is held to.
    """
    _check(wav, params)
    if wav.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fused_melspec_plain needs allow_tf32 False (true fp32)")
    hop, pad = params.hop_length, params.n_fft // 2
    lead, length = wav.shape[:-1], wav.shape[-1]
    n = length // hop
    x = wav.reshape(-1, length).to(torch.float32)
    xp = F.pad(x, (pad, pad), mode="reflect")
    needed = (n + 3) * hop
    xp = F.pad(xp, (0, max(0, needed - xp.shape[1])))[:, :needed]
    blocks = xp.reshape(x.shape[0], n + 3, hop)
    w_cos, w_sin, mel_t = _consts_on(params, wav.device)
    re = sum(blocks[:, k : k + n] @ w_cos[k * hop : (k + 1) * hop] for k in range(4))
    im = sum(blocks[:, k : k + n] @ w_sin[k * hop : (k + 1) * hop] for k in range(4))
    mel = torch.sqrt(re * re + im * im) @ mel_t[:, : params.n_mels]
    return _normalize(mel, params).reshape(lead + (n, params.n_mels))


_LIB = _build.Library("featurizer", "fused_melspec",
                      fused_melspec=[_build.PTR] * 6 + [_build.INT] * 4 + [_build.FLOAT] * 3)


def fused_melspec_kernel(wav: Tensor, params: AudioParams = DEFAULT_PARAMS) -> Tensor:
    """(..., L) float32 waveform → (..., L//hop, n_mels) normalized mel.

    By ``_build``'s rule: on the card one launch
    (``launches["fused_melspec"]``), raising on a tensor or AudioParams the
    kernel does not take or a failed launch (a hop above 736, whose audio
    window would not fit in shared memory); under grad a ``wav`` that
    requires it raises (no backward, nor has the Pallas kernel):
    differentiate ``waveform_to_r9y9_melspec(impl="xla")``. On the CPU
    :func:`fused_melspec_plain`, differentiable; traced
    ``advoc::fused_melspec``."""
    _check(wav, params)
    return _KERNEL(wav, params)


def _by_rows(fn, wav: Tensor, params: AudioParams) -> Tensor:
    """``fn`` of a contiguous (B, L) tensor applied to (..., L) ``wav``."""
    lead, length = wav.shape[:-1], wav.shape[-1]
    out = fn(wav.reshape(-1, length).contiguous(), params)
    return out.reshape(lead + out.shape[1:])


def _op(wav: Tensor, params: AudioParams) -> Tensor:
    from advoc_tpu_torch.ops.kernels import registered

    return _by_rows(lambda x, p: registered.fused_melspec_op(x, registered.params_list(p)), wav,
                    params)


def _launch(x: Tensor, params: AudioParams) -> Tensor:
    """The kernel on a contiguous (B, L) CUDA tensor."""
    if x.dtype != torch.float32:
        raise ValueError("fused_melspec_kernel needs a float32 waveform")
    if params.n_mels > 80:
        raise ValueError("fused_melspec_kernel needs n_mels <= 80")
    hop, length = params.hop_length, x.shape[-1]
    b, n = x.shape[0], length // hop
    if b * max(length, n * params.n_mels) >= 2**31:
        raise ValueError("fused_melspec_kernel indexes with 32-bit offsets")
    consts = _tc_consts_on(params, x.device)
    out = torch.empty((b, n, params.n_mels), dtype=torch.float32, device=x.device)
    _LIB.launch(x.device, "fused_melspec", x.data_ptr(), *(c.data_ptr() for c in consts),
                out.data_ptr(), b, length, hop, params.n_mels, params.amp_floor,
                params.ref_level_db, params.min_level_db)
    return out


_KERNEL = _build.kernel("fused_melspec_kernel", plain=fused_melspec_plain,
                        launch=functools.partial(_by_rows, _launch), op=_op, pallas=True,
                        instead='the STFT path, impl="xla"')
