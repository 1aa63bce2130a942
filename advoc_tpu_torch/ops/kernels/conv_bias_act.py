"""Bias + crop + activation after a 1-D transposed convolution: a CUDA kernel and its plain version.

Replaces no Pallas kernel: the JAX package leaves this to XLA, which fuses
it into the convolution. In the port each WaveGAN level but the last
(:func:`~advoc_tpu_torch.models.wavegan.model.run_up_stack`) ran three
PyTorch passes over cuDNN's output: the broadcast bias add (PyTorch's
strided elementwise kernel), the activation on the view cropped to flax's
SAME length, and before the float32 last level a cast to float32.

Design on Hopper (``csrc/conv_bias_act.cu``): one launch a level, reading
cuDNN's un-biased output ``y`` (B, C, L_full) once and writing the next
level's input once, 8 outputs a thread with 16-byte stores. At k25 the full
length is 4n + 1, so rows of ``y`` start off 16-byte boundaries; a thread
loads the aligned 16-byte groups around its 8 inputs and shifts them in
registers, so no padded copy is made. The grid comes from the shape.

Bound (:func:`~advoc_tpu_torch.utils.roofline.conv_bias_act_bytes`): one
read of ``y`` and one write of the output, 0 FLOP a byte. At the
65,536-sample WaveGAN on 256 latents the five levels read 1.04 GB of bf16
and write 1.58 GB (bf16, then float32 at the level before the last): 2.62
GB, 0.78 ms at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels.group_norm import ACTS, DTYPES, activate

Tensor = torch.Tensor


def conv_bias_act_plain(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
                        out_dtype: torch.dtype) -> Tensor:
    """The kernel's function in plain PyTorch, the ops the port ran before
    it: ``y + bias`` in y's dtype (as PyTorch adds a convolution's bias),
    the crop of ``cut_lo`` and ``cut_hi`` steps off the ends of the last
    axis, ``act`` (:func:`~advoc_tpu_torch.ops.kernels.group_norm.activate`)
    and the cast to ``out_dtype``. The reference the kernel is held to."""
    z = y + bias.reshape(1, -1, 1)
    z = z.narrow(-1, cut_lo, y.shape[-1] - cut_lo - cut_hi)
    return activate(z, act).to(out_dtype)


def _check(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
           out_dtype: torch.dtype) -> int:
    """Raise on what the kernel does not take; the output length."""
    if y.ndim != 3:
        raise ValueError(f"y must be (B, C, L), got {tuple(y.shape)}")
    b, c, lf = y.shape
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if y.dtype not in DTYPES:
        raise ValueError(f"conv_bias_act_kernel needs a bfloat16, float16 or float32 y, got "
                         f"{y.dtype}")
    if tuple(bias.shape) != (c,) or bias.dtype != y.dtype or bias.device != y.device:
        raise ValueError(f"bias must be ({c},) in y's dtype {y.dtype} on {y.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if out_dtype not in (y.dtype, torch.float32):
        raise ValueError(f"out_dtype must be y's dtype or float32, got {out_dtype}")
    length = lf - cut_lo - cut_hi
    if cut_lo < 0 or cut_hi < 0 or length < 0 or length % 8:
        raise ValueError(f"conv_bias_act_kernel needs cuts >= 0 leaving a length that is a "
                         f"multiple of 8 (L {lf}, cuts ({cut_lo}, {cut_hi}))")
    if not y.is_contiguous() or not bias.is_contiguous():
        raise ValueError(f"conv_bias_act_kernel needs y and bias contiguous, got strides "
                         f"{y.stride()} and {bias.stride()}")
    if b * c * length // 8 >= 2**31:
        raise ValueError(f"conv_bias_act_kernel takes fewer than 2^34 outputs, got "
                         f"{b * c * length}")
    return length


_LIB = _build.Library("conv_bias_act", "conv_bias_act",
                      conv_bias_act=[_build.PTR] * 3 + [_build.INT64] + [_build.INT] * 7)


def conv_bias_act_kernel(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
                         out_dtype: torch.dtype) -> Tensor:
    """act(y + bias) cropped to ``y[..., cut_lo : L_full − cut_hi]``, in
    ``out_dtype``: a new contiguous (B, C, L) tensor from cuDNN's un-biased
    transposed-convolution output ``y`` (B, C, L_full) in bf16, f16 or f32
    and its ``bias`` (C,) in y's dtype; ``act`` ``"relu"`` or
    ``"leaky_relu"`` (slope 0.2); ``out_dtype`` y's dtype or float32. Raises
    on what the kernel does not take (another dtype or layout, L not a
    multiple of 8, a bias of another length, dtype or device; on the card y
    not 16-byte aligned). By ``_build``'s rule: one launch on the card
    (``launches["conv_bias_act"]``), bit-equal to
    :func:`conv_bias_act_plain`, which runs on the CPU;
    ``advoc::conv_bias_act`` traced; it stands for no Pallas kernel."""
    _check(y, bias, cut_lo, cut_hi, act, out_dtype)
    return _KERNEL(y, bias, cut_lo, cut_hi, act, out_dtype)


def _op(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
        out_dtype: torch.dtype) -> Tensor:
    from advoc_tpu_torch.ops.kernels import registered

    return registered.conv_bias_act_op(y, bias, cut_lo, cut_hi, act, out_dtype)


def _launch(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
            out_dtype: torch.dtype) -> Tensor:
    """The kernel on a CUDA tensor that :func:`_check` passed."""
    if y.data_ptr() % 16:
        raise ValueError("conv_bias_act_kernel needs y 16-byte aligned")
    b, c, lf = y.shape
    length = lf - cut_lo - cut_hi
    out = torch.empty((b, c, length), dtype=out_dtype, device=y.device)
    _LIB.launch(y.device, "conv_bias_act", y.data_ptr(), bias.data_ptr(), out.data_ptr(), b * c,
                c, lf, length, cut_lo, ACTS.index(act), DTYPES.index(y.dtype),
                int(out_dtype != y.dtype))
    return out


_KERNEL = _build.kernel("conv_bias_act_kernel", plain=conv_bias_act_plain, launch=_launch, op=_op,
                        pallas=False,
                        instead="conv_bias_act_plain (models.layers.conv_transpose_act takes it)")
