"""The WaveGAN levels' bias + crop + activation epilogue
(advoc_tpu_torch.ops.kernels.conv_bias_act) on the CPU.

The plain version, applied to the transposed convolution without its bias,
is the level as the port ran it (:func:`conv_transpose_same` with the bias,
then the activation and the cast), bit for bit, and rounds as the kernel
does; the generators' up-stacks take the plain path on the CPU, with and
without autograd, and compute what they computed before the kernel (tests/
test_torch_cuda.py holds the kernel to the plain version on the card); the
wrapper on a CPU tensor is the plain version and refuses what the kernel
does not take; the level shapes and bytes are the cell's.
"""

import pytest
import torch
import torch.nn.functional as F

from advoc_tpu_torch.models import layers
from advoc_tpu_torch.models.wavegan import (
    CondWaveGANConfig,
    CondWaveGANGenerator,
    WaveGANConfig,
    WaveGANGenerator,
)
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import conv_bias_act as tcba
from advoc_tpu_torch.ops.kernels.group_norm import ACTS, activate
from advoc_tpu_torch.utils.roofline import bound, conv_bias_act_bytes, conv_bias_act_levels

# (kernel, stride, input length): k24/s4 crops (10, 10), all inside the
# convolution; k25/s4 (10, 11), one step left, a full length of 4n + 1; k5/s2
# (1, 2), one step left, 2n + 1. The full lengths 68, 65, 63 are odd but the first.
_GEOMETRY = [(24, 4, 17), (25, 4, 16), (5, 2, 31)]


def _dyadic(shape, seed, steps):
    """Values k / steps for small integers k, so that every sum the
    convolutions take here is exact in bf16 as in float32."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-steps, steps + 1, shape, generator=g).float() / steps


def _level(k, s, cin=4, cout=16, seed=0):
    conv = torch.nn.ConvTranspose1d(cin, cout, k, stride=s)
    with torch.no_grad():
        conv.weight.copy_(_dyadic(conv.weight.shape, seed, 2))
        conv.bias.copy_(_dyadic(conv.bias.shape, seed + 1, 4))
    return conv


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("k,s,n", _GEOMETRY, ids=[f"k{k}s{s}" for k, s, _ in _GEOMETRY])
def test_plain_is_the_level_as_it_ran(k, s, n, act, out_dtype):
    """On the transposed convolution without its bias, the plain version is
    ``act(conv_transpose_same(x))`` cast to ``out_dtype``, bit for bit: the
    crop (0, 0) or (0, 1) left after the convolution's padding, the
    activation, the cast. Inputs, kernels and biases are multiples of 1/2
    and 1/4 (every sum exact in bf16), so the CPU's float32 convolution and
    the card's bf16 one with a separate bias add give the same bits."""
    dt = torch.bfloat16
    conv = _level(k, s)
    x = _dyadic((2, 4, n), seed=k, steps=1).to(dt)
    padding, extra, ((cut_lo, cut_hi),) = layers.transpose_geometry(conv.kernel_size, conv.stride)
    with torch.no_grad():
        want = activate(layers.conv_transpose_same(x, conv, dt), act).to(out_dtype)
        y = layers._conv(F.conv_transpose1d, x, conv, dt, bias=False, stride=conv.stride,
                         padding=padding, output_padding=extra)
        got = tcba.conv_bias_act_plain(y, conv.bias.to(dt), cut_lo, cut_hi, act, out_dtype)
    assert y.shape[-1] == n * s + cut_lo + cut_hi and cut_lo == 0
    assert cut_hi == (0 if k == 24 else 1)
    assert got.dtype == out_dtype and got.shape == (2, 16, n * s) and got.is_contiguous()
    assert torch.equal(got, want)
    assert bool((want != 0).any()) and bool((want < 0).any()) == (act == "leaky_relu")


@pytest.mark.parametrize("dtype", tcba.DTYPES)
def test_plain_rounds_as_the_kernel(dtype):
    """The kernel's formula: the float32 sum of y and the bias rounded once
    to the compute dtype, the activation on the rounded value (LeakyReLU's
    product in float32, rounded again), widened exactly to float32; the
    plain version gives the same bits on random y, whose sums round."""
    g = torch.Generator().manual_seed(7)
    y = (torch.randn((3, 8, 33), generator=g) * 3).to(dtype)
    b = (torch.randn(8, generator=g) * 0.1).to(dtype)
    t = (y.float() + b.float()[:, None]).to(dtype)[..., :32].float()
    for act, want in (("relu", torch.where(t > 0, t, 0.0)),
                      ("leaky_relu", torch.where(t > 0, t, (t * 0.2).to(dtype).float()))):
        got = tcba.conv_bias_act_plain(y, b, 0, 1, act, torch.float32)
        assert torch.equal(got, want), act
        assert torch.equal(tcba.conv_bias_act_plain(y, b, 0, 1, act, dtype), want.to(dtype))
    if dtype != torch.float32:  # the sums did round
        assert not torch.equal(t, y.float()[..., :32] + b.float()[:, None])


def _up_stack_before(x, layers_, dtype, act):
    """The up-stack as the port ran it before the epilogue kernel."""
    for i, up in enumerate(layers_):
        last = i == len(layers_) - 1
        x = layers.conv_transpose_same(x.to(torch.float32) if last else x, up,
                                       torch.float32 if last else dtype)
        x = torch.tanh(x[:, 0]) if last else act(x)
    return x


@pytest.mark.parametrize("kernel", [24, 25])
def test_generators_take_the_plain_path_on_the_cpu(monkeypatch, kernel):
    """WaveGANGenerator and CondWaveGANGenerator on CPU tensors, with and
    without autograd, never reach the kernel's wrapper and give the bits
    they gave before it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(layers, "conv_bias_act_kernel", refuse)
    before = _build.launches["conv_bias_act"]
    wave = WaveGANGenerator(WaveGANConfig(slice_len=1024, width=4, kernel=kernel))
    wave.reset_parameters(torch.Generator().manual_seed(0))
    cond = CondWaveGANGenerator(CondWaveGANConfig(n_frames=8, hop=64, width=4, kernel=kernel))
    cond.reset_parameters(torch.Generator().manual_seed(1))
    z = torch.randn((2, 100), generator=torch.Generator().manual_seed(2))
    mel = torch.rand((2, 8, 80), generator=torch.Generator().manual_seed(3))
    for ctx in (torch.inference_mode, torch.enable_grad):
        with ctx():
            got = wave(z)
            dt = wave.cfg.compute_dtype
            x = F.relu(layers.dense(z, wave.project, dt).reshape(2, 16, wave.c0).permute(0, 2, 1))
            assert torch.equal(got, _up_stack_before(x, wave.ups, dt, F.relu))
            got = cond(mel)
            x = (mel * 2.0 - 1.0).to(dt).permute(0, 2, 1)
            x = F.leaky_relu(layers.conv_same(x, cond.trunk, dt), 0.2)
            want = _up_stack_before(x, cond.ups, dt, lambda y: F.leaky_relu(y, 0.2))
            assert torch.equal(got, want)
            assert got.shape == (2, 8 * 64) and got.requires_grad == (ctx is torch.enable_grad)
    assert _build.launches["conv_bias_act"] == before


@pytest.mark.parametrize("dtype", tcba.DTYPES)
def test_wrapper_on_the_cpu_is_the_plain_version(dtype):
    """In each compute dtype, to y's dtype and to float32, both activations."""
    g = torch.Generator().manual_seed(4)
    y = torch.randn((2, 8, 65), generator=g).to(dtype)
    b = torch.randn(8, generator=g).to(dtype)
    for act in ACTS:
        for out in {dtype, torch.float32}:
            got = tcba.conv_bias_act_kernel(y, b, 0, 1, act, out)
            assert torch.equal(got, tcba.conv_bias_act_plain(y, b, 0, 1, act, out))
            assert got.dtype == out and got.shape == (2, 8, 64) and got.is_contiguous()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    y = torch.randn((2, 8, 65)).to(torch.bfloat16)
    b = torch.zeros(8, dtype=torch.bfloat16)
    cases = [
        ((y[0], b, 0, 1, "relu", torch.bfloat16), r"\(B, C, L\)"),
        ((y, b, 0, 1, "gelu", torch.bfloat16), "act"),
        ((y.double(), b.double(), 0, 1, "relu", torch.float64), "float16 or float32"),
        ((y, b[:4], 0, 1, "relu", torch.bfloat16), r"bias must be \(8,\)"),
        ((y, b.float(), 0, 1, "relu", torch.bfloat16), "y's dtype"),
        ((y, b, 0, 1, "relu", torch.float16), "out_dtype"),
        ((y, b, 0, 0, "relu", torch.bfloat16), "multiple of 8"),
        ((y, b, -1, 2, "relu", torch.bfloat16), "cuts >= 0"),
        ((y[..., :-1].transpose(1, 2).contiguous().transpose(1, 2), b, 0, 0, "relu",
          torch.bfloat16), "contiguous"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            tcba.conv_bias_act_kernel(*args)


def test_levels_are_the_cells():
    """wavegan-65536.gen-b256: five levels up0–up4 at k25 (crop (0, 1)),
    1.04 GB of bf16 read and 1.58 GB written (float32 at up4): 0.78 ms at
    3.35 TB/s. At k24 the crop is (0, 0)."""
    levels = conv_bias_act_levels(WaveGANConfig(slice_len=65536, kernel=25), 256)
    assert [n for n, *_ in levels] == [f"up{i}" for i in range(5)]
    assert levels[0][1:] == ((256, 1024, 65), (0, 1), 2)
    assert levels[-1][1:] == ((256, 64, 16385), (0, 1), 4)
    read = sum(2 * s[0] * s[1] * s[2] for _, s, _, _ in levels)
    total = sum(conv_bias_act_bytes(s, c, 2, o) for _, s, c, o in levels)
    assert abs(read / 1e9 - 1.041) < 1e-3 and abs((total - read) / 1e9 - 1.577) < 1e-3
    assert abs(bound(0.0, total)[0] - 0.7816) < 1e-3
    assert {c for _, _, c, _ in conv_bias_act_levels(WaveGANConfig(), 2)} == {(0, 0)}
