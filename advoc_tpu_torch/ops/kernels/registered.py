"""The port's CUDA kernels as registered PyTorch operators, ``torch.ops.advoc``.

``torch.export`` cannot record a ctypes call, so each hand-written kernel is
also an operator of the ``advoc`` namespace (``torch.library.custom_op``):

* ``advoc::griffin_lim`` (B1/B2, :mod:`.griffin_lim`),
* ``advoc::fused_melspec`` (B3, :mod:`.featurizer`),
* ``advoc::packed_up`` (B4, :mod:`.packed_up`),
* ``advoc::group_norm_act`` (the U-Net's GroupNorm + activation,
  :mod:`.group_norm`),
* ``advoc::conv_bias_act`` (WaveGAN's bias + crop + activation,
  :mod:`.conv_bias_act`).

Each operator's CUDA implementation launches the kernel (counted in
``_build.launches``), its CPU implementation is the plain version, and its
fake gives the output shapes and dtypes (and ``group_norm_act``'s strides)
for tracing. ``_build``'s one rule sends a
traced wrapper here, except that inside ``_build.plain_when_traced`` the
two kernels that stand for no Pallas kernel (``group_norm_act``,
``conv_bias_act``) trace as their plain aten ops. An exported program that
records one of these operators needs this module imported before
``torch.export.load``, and runs only on a device the operator has an
implementation for (CUDA or the CPU). It imports torch and the port's
``ops`` only, so an artifact loads without any model code.
"""

import dataclasses
from typing import Optional

import torch

from advoc_tpu_torch.ops.kernels import (
    conv_bias_act,
    featurizer,
    griffin_lim,
    group_norm,
    packed_up,
)
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS, AudioParams

Tensor = torch.Tensor

NAMESPACE = "advoc"
OPS = ("griffin_lim", "fused_melspec", "packed_up", "group_norm_act", "conv_bias_act")


def params_list(params: AudioParams) -> list[float]:
    """AudioParams as the operators' ``float[]`` argument."""
    return [float(v) for v in dataclasses.astuple(params)]


def _own(x: Tensor) -> Tensor:
    """``x`` in storage of its own, as the fake implementations describe it
    (a cropped view of a larger result has a storage offset)."""
    if x.storage_offset() == 0 and x.is_contiguous():
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _params(values: list[float]) -> AudioParams:
    kinds = [type(getattr(DEFAULT_PARAMS, f.name)) for f in dataclasses.fields(AudioParams)]
    return AudioParams(*(k(v) for k, v in zip(kinds, values, strict=True)))


# -- advoc::griffin_lim ------------------------------------------------------

@torch.library.custom_op("advoc::griffin_lim", mutates_args=(), device_types="cuda")
def griffin_lim_op(mag: Tensor, cos0: Optional[Tensor], sin0: Optional[Tensor], n_iters: int,
                   momentum: float, loop_dtype: str, params: list[float]) -> Tensor:
    init = None if cos0 is None else (cos0, sin0)
    return _own(griffin_lim._launch(mag, n_iters, momentum, init, _params(params), loop_dtype))


@griffin_lim_op.register_kernel("cpu")
def _(mag, cos0, sin0, n_iters, momentum, loop_dtype, params):
    init = None if cos0 is None else (cos0, sin0)
    return _own(griffin_lim.griffin_lim_plain(mag, n_iters, momentum, init, _params(params),
                                              loop_dtype=loop_dtype))


@griffin_lim_op.register_fake
def _(mag, cos0, sin0, n_iters, momentum, loop_dtype, params):
    b, t, _ = mag.shape
    return mag.new_empty((b, t * _params(params).hop_length), dtype=torch.float32)


# -- advoc::fused_melspec ----------------------------------------------------

@torch.library.custom_op("advoc::fused_melspec", mutates_args=(), device_types="cuda")
def fused_melspec_op(wav: Tensor, params: list[float]) -> Tensor:
    return featurizer._launch(wav, _params(params))


@fused_melspec_op.register_kernel("cpu")
def _(wav, params):
    return featurizer.fused_melspec_plain(wav, _params(params))


@fused_melspec_op.register_fake
def _(wav, params):
    p = _params(params)
    return wav.new_empty((wav.shape[0], wav.shape[1] // p.hop_length, p.n_mels),
                         dtype=torch.float32)


# -- advoc::packed_up --------------------------------------------------------

@torch.library.custom_op("advoc::packed_up", mutates_args=(), device_types="cuda")
def packed_up_op(x: Tensor, wt: Tensor, bias: Tensor, f: int, tm: int,
                 with_stats: bool) -> tuple[Tensor, Tensor, Tensor]:
    """(y, Σy, Σy²); without ``with_stats`` the sums are empty (B, 0)."""
    out = packed_up._launch(x, wt, bias, f, tm, with_stats)
    return out if with_stats else (out, *_no_stats(x))


@packed_up_op.register_kernel("cpu")
def _(x, wt, bias, f, tm, with_stats):
    out = packed_up.packed_up_plain(x.to(torch.bfloat16), wt, bias, f=f, tm=tm,
                                    with_stats=with_stats)
    return out if with_stats else (out, *_no_stats(x))


@packed_up_op.register_fake
def _(x, wt, bias, f, tm, with_stats):
    b, h, w, _ = x.shape
    y = x.new_empty((b, 2 * h, w, 2 * f), dtype=torch.bfloat16)
    if not with_stats:
        return (y, *_no_stats(x))
    return y, x.new_empty((b, 2 * f), dtype=torch.float32), x.new_empty((b, 2 * f),
                                                                        dtype=torch.float32)


def _no_stats(x: Tensor) -> tuple[Tensor, Tensor]:
    return tuple(x.new_empty((x.shape[0], 0), dtype=torch.float32) for _ in range(2))


# -- advoc::group_norm_act ---------------------------------------------------

@torch.library.custom_op("advoc::group_norm_act", mutates_args=(), device_types="cuda")
def group_norm_act_op(x: Tensor, weight: Tensor, bias: Tensor, groups: int, act: str,
                      conv_bias: Optional[Tensor] = None) -> Tensor:
    """act(GroupNorm(x + conv_bias)) in x's layout (channels-last or
    contiguous NCHW); no bias added where ``conv_bias`` is None."""
    group_norm._check(x, weight, bias, groups, act, conv_bias)
    return group_norm._launch(x, weight, bias, groups, act, conv_bias)[0]


@group_norm_act_op.register_kernel("cpu")
def _(x, weight, bias, groups, act, conv_bias=None):
    # The plain version's elementwise ops keep x's layout.
    return group_norm.group_norm_act_plain(x, weight, bias, groups, act, conv_bias)


@group_norm_act_op.register_fake
def _(x, weight, bias, groups, act, conv_bias=None):
    return torch.empty_like(x)


# -- advoc::conv_bias_act ----------------------------------------------------

@torch.library.custom_op("advoc::conv_bias_act", mutates_args=(), device_types="cuda")
def conv_bias_act_op(y: Tensor, bias: Tensor, cut_lo: int, cut_hi: int, act: str,
                     out_dtype: torch.dtype) -> Tensor:
    """act(y + bias) cropped by (cut_lo, cut_hi), in out_dtype, contiguous."""
    conv_bias_act._check(y, bias, cut_lo, cut_hi, act, out_dtype)
    return conv_bias_act._launch(y, bias, cut_lo, cut_hi, act, out_dtype)


@conv_bias_act_op.register_kernel("cpu")
def _(y, bias, cut_lo, cut_hi, act, out_dtype):
    return conv_bias_act.conv_bias_act_plain(y, bias, cut_lo, cut_hi, act, out_dtype)


@conv_bias_act_op.register_fake
def _(y, bias, cut_lo, cut_hi, act, out_dtype):
    b, c, lf = y.shape
    return y.new_empty((b, c, lf - cut_lo - cut_hi), dtype=out_dtype)


def recorded(graph_module) -> list[str]:
    """Names of the ``advoc`` operators a traced graph calls, in graph order."""
    names = []
    for node in graph_module.graph.nodes:
        target = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(target):
            name = target()
            if name.startswith(NAMESPACE + "::"):
                names.append(name)
    return names
