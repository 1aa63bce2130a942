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

import contextlib
import ctypes
import functools

import torch

from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels.group_norm import ACTS, activate

Tensor = torch.Tensor

DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # the kernel's codes 0, 1, 2


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


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_bias_act")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_bias_act.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, p]
    lib.conv_bias_act.restype = i
    return lib


def conv_bias_act_kernel(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
                         out_dtype: torch.dtype) -> Tensor:
    """act(y + bias) cropped to ``y[..., cut_lo : L_full − cut_hi]``, in
    ``out_dtype``: a new contiguous (B, C, L) tensor from cuDNN's un-biased
    transposed-convolution output ``y`` (B, C, L_full) in bf16, f16 or f32
    and its ``bias`` (C,) in y's dtype; ``act`` ``"relu"`` or
    ``"leaky_relu"`` (slope 0.2); ``out_dtype`` y's dtype or float32.

    On a CUDA tensor: one launch of the CUDA kernel on y's device and its
    current stream, counted in ``conv_bias_act_kernel.launches``, bit-equal
    to :func:`conv_bias_act_plain`; it raises on what the kernel does not
    take (another dtype or layout, y not 16-byte aligned, L not a multiple
    of 8, a bias of another length, dtype or device) or a failed launch, and
    under autograd (no backward). On a CPU tensor: the same checks, then
    :func:`conv_bias_act_plain`.
    """
    length = _check(y, bias, cut_lo, cut_hi, act, out_dtype)
    if not y.is_cuda:
        return conv_bias_act_plain(y, bias, cut_lo, cut_hi, act, out_dtype)
    _build.refuse_grad([y, bias], "conv_bias_act_kernel",
                       "conv_bias_act_plain (models.layers.conv_transpose_act takes it)")
    if y.data_ptr() % 16:
        raise ValueError("conv_bias_act_kernel needs y 16-byte aligned")
    b, c, lf = y.shape
    dev = y.device
    out = torch.empty((b, c, length), dtype=out_dtype, device=dev)
    lib = _lib()
    # The launcher launches on the current device.
    on_dev = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev))
    with on_dev:
        code = lib.conv_bias_act(
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), b * c, c, lf, length, cut_lo,
            ACTS.index(act), DTYPES.index(y.dtype), int(out_dtype != y.dtype),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check(lib, code, "conv_bias_act")
    conv_bias_act_kernel.launches += 1
    return out


conv_bias_act_kernel.launches = 0
