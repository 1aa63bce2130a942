"""The port's BigVGAN generator against the benchmark's plain reference
(``benchmark/reference/bigvgan.py``), on the CPU at small widths; the
anti-aliased SnakeBeta, its filter, the dilated and transposed convolutions
it is built from; the published shapes; the ranges a call records."""

import dataclasses
import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.models import layers
from advoc_tpu_torch.models.bigvgan import BigVGANConfig, BigVGANGenerator
from advoc_tpu_torch.models.bigvgan import model as bigvgan_model
from advoc_tpu_torch.utils import profiling

# Two levels of the published kind (k8/s4, k4/s2), two AMPBlock1 kernels.
SMALL = dict(upsample_initial_channel=32, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The benchmark's plain reference, loaded by its path as the package
    ``reference`` (it imports its sibling ``audio``)."""
    bench = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
    spec = importlib.util.spec_from_file_location(
        "reference", bench / "reference" / "__init__.py",
        submodule_search_locations=[str(bench / "reference")])
    pkg = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("reference")
    sys.modules["reference"] = pkg
    try:
        spec.loader.exec_module(pkg)
        sub = importlib.util.spec_from_file_location("reference.bigvgan",
                                                     bench / "reference" / "bigvgan.py")
        mod = importlib.util.module_from_spec(sub)
        sys.modules["reference.bigvgan"] = mod
        sub.loader.exec_module(mod)
    finally:
        for name in ("reference.bigvgan", "reference.audio"):
            sys.modules.pop(name, None)
        if saved is None:
            sys.modules.pop("reference", None)
        else:
            sys.modules["reference"] = saved
    return mod


def _carrying(g: BigVGANGenerator, seed: int) -> dict:
    """Weights under which every level carries signal and tanh stays near
    its linear range: kernels normal at 1/√fan-in (C_in·k, C_in·k/u for a
    transposed convolution), conv_pre's by 1/7 (a log-mel's rms), each
    AMPBlock1's second convolution's by 0.5 and conv_post's by 0.2; log-scale
    α and β 0.1·normal; biases 0.02·normal. Loaded into ``g``."""
    gen = torch.Generator().manual_seed(seed)
    rates = g.cfg.upsample_rates
    sd = {}
    for name, v in g.state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        if name.endswith((".alpha", ".beta")):
            x *= 0.1
        elif name.endswith("bias"):
            x *= 0.02
        elif name.startswith("ups."):
            x /= math.sqrt(v.shape[0] * v.shape[2] / rates[int(name.split(".")[1])])
        else:
            gain = (1 / 7 if name.startswith("conv_pre.") else 0.2 if name.startswith("conv_post.")
                    else 0.5 if ".convs2." in name else 1.0)
            x *= gain / math.sqrt(v.shape[1] * v.shape[2])
        sd[name] = x
    g.load_state_dict(sd)
    return sd


def _mel(b: int, t: int, seed: int) -> torch.Tensor:
    """A log-mel-like (b, 80, t): ln of a smooth positive spectrum, a few
    units either side of −5."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 80, t, generator=gen)
    return -5.0 + 2.0 * F.avg_pool1d(x, 3, 1, 1) + torch.linspace(1, -2, 80)[:, None]


def _small(dtype: str, seed: int = 3):
    cfg = BigVGANConfig(dtype=dtype, **SMALL)
    g = BigVGANGenerator(cfg).eval()
    return g, _carrying(g, seed), dataclasses.asdict(cfg)


def _gap(got, want):
    return (got - want).norm(dim=1) / want.norm(dim=1)


class TestReference:
    def test_float32_equals_reference(self, reference):
        """float32: the same products in the same order, within 1e-5
        relative (measured 0)."""
        g, sd, model = _small("float32")
        mel = _mel(2, 16, 1)
        with torch.no_grad():
            got = g(mel)
        want = reference.generate(mel, sd, model)
        assert got.shape == want.shape == (2, 16 * 8) and got.dtype == torch.float32
        assert float(_gap(got, want).max()) < 1e-5

    def test_bf16_near_reference(self, reference):
        """The configuration's bf16: each row within 5e-2 relative L2 of the
        float32 reference. bf16 keeps 8 bits, so each convolution's rounded
        input, kernel and output and each stored activation is off by ≈ 2^-9
        relative, about fifty of them compounding through the residual
        stream (measured 0.011–0.015 here, ≈ 0.016 at the published widths);
        the reference in float8 e4m3 reads 0.13–0.18 here."""
        g, sd, model = _small("bfloat16")
        mel = _mel(3, 16, 2)
        with torch.no_grad():
            got = g(mel)
        want = reference.generate(mel, sd, model)
        gap = _gap(got, want)
        assert got.dtype == torch.float32 and float(gap.max()) < 5e-2
        assert float(gap.min()) > 0  # bf16 did round

    def test_without_resampling_fails(self, reference, monkeypatch):
        """A generator whose activations skip the ×2 resampling (SnakeBeta
        alone) is far outside the bf16 tolerance (measured ≈ 1.4)."""

        def snake_only(x, log_alpha, log_beta, *filters):
            y = x.float()
            a, b = log_alpha.exp()[:, None], log_beta.exp()[:, None]
            return (y + torch.sin(y * a) ** 2 / (b + 1e-9)).to(x.dtype)

        g, sd, model = _small("float32")
        monkeypatch.setattr(bigvgan_model, "aa_snake_beta", snake_only)
        mel = _mel(2, 16, 1)
        with torch.no_grad():
            got = g(mel)
        assert float(_gap(got, reference.generate(mel, sd, model)).min()) > 5e-2


class TestActivation:
    def test_taps_are_the_kaiser_sinc_formula(self, reference):
        """12 taps: numpy's Kaiser window at Kaiser's β for the attenuation
        2.285·5·π·1.2 + 7.95 dB (β ≈ 4.66) times the sinc of cutoff 0.25 at
        half-sample times, normalised; they sum to 1 and equal the
        reference's."""
        taps = layers.kaiser_sinc_filter()
        att = 2.285 * 5 * math.pi * 4 * 0.3 + 7.95
        beta = 0.1102 * (att - 8.7)
        t = np.arange(-6, 6) + 0.5
        h = np.kaiser(12, beta) * 0.5 * np.sinc(0.5 * t)
        assert taps.dtype == torch.float32 and abs(beta - 4.66) < 0.01
        np.testing.assert_allclose(taps.numpy(), h / h.sum(), rtol=1e-6, atol=1e-8)
        assert abs(float(taps.double().sum()) - 1.0) < 1e-6
        assert torch.equal(taps, reference.kaiser_sinc())

    def test_phase_filters_hold_the_taps(self):
        """The up-sampling's two phase filters hold the odd and the even taps,
        each twice (the ×2 of ``UpSample1d``); the down-sampling's hold every
        tap once; both 7 wide at 12 taps."""
        taps = layers.kaiser_sinc_filter()
        up, down = layers.aa_filters(taps.tolist())
        assert up.shape == down.shape == (2, 7)
        nonzero = lambda w: sorted(v for v in w.flatten().tolist() if v != 0)  # noqa: E731
        assert nonzero(up / 2) == nonzero(down) == sorted(taps.tolist())
        assert nonzero(up[0] / 2) == sorted(taps[1::2].tolist())

    @pytest.mark.parametrize("t", [1, 3, 37])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_equals_reference_activation(self, reference, dtype, t):
        """(B, C, T) in, (B, C, T) out in x's dtype; float32 arithmetic: the
        reference's Activation1d to float32 rounding, then x's dtype's; at
        T = 1 and 3 every output sample reads the replicated ends."""
        gen = torch.Generator().manual_seed(t)
        x = (2 * torch.randn(2, 5, t, generator=gen)).to(dtype)
        la, lb = 0.3 * torch.randn(5, generator=gen), 0.3 * torch.randn(5, generator=gen)
        taps = layers.kaiser_sinc_filter()
        got = layers.aa_snake_beta(x, la, lb, *layers.aa_filters(taps.tolist()))
        want = reference.activation(x.float(), la, lb, taps)
        assert got.shape == x.shape and got.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8
        assert float((got.float() - want).abs().max()) <= tol * float(want.abs().max())


class TestConvolutions:
    @pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5), (3, 5)])
    def test_dilated_conv_same(self, k, d):
        """A dilated ``conv_same`` is PyTorch's same-length convolution,
        padding d·(k − 1)/2."""
        gen = torch.Generator().manual_seed(k * d)
        conv = nn.Conv1d(4, 6, k, dilation=d)
        x = torch.randn(2, 4, 40, generator=gen)
        want = F.conv1d(x, conv.weight, conv.bias, padding=d * (k - 1) // 2, dilation=d)
        got = layers.conv_same(x, conv, torch.float32)
        assert got.shape == want.shape and torch.equal(got, want)

    @pytest.mark.parametrize("nd", [1, 2])
    def test_undilated_conv_same_keeps_its_bits(self, nd):
        """Today's callers (dilation 1): the convolution they ran before."""
        gen = torch.Generator().manual_seed(nd)
        conv = (nn.Conv1d if nd == 1 else nn.Conv2d)(3, 5, 4, stride=2)
        x = torch.randn((2, 3) + (16,) * nd, generator=gen)
        fn = F.conv1d if nd == 1 else F.conv2d
        want = fn(x, conv.weight, conv.bias, stride=conv.stride, padding=[1] * nd)
        assert torch.equal(layers.conv_same(x, conv, torch.float32), want)

    @pytest.mark.parametrize("k,u", [(8, 4), (4, 2)])
    def test_transposed_published_padding(self, k, u):
        """``conv_transpose_same`` at BigVGAN's geometries is PyTorch's
        ``ConvTranspose1d(padding=(k − u) // 2)``: length u·T."""
        gen = torch.Generator().manual_seed(k)
        conv = nn.ConvTranspose1d(6, 3, k, stride=u)
        x = torch.randn(2, 6, 9, generator=gen)
        want = F.conv_transpose1d(x, conv.weight, conv.bias, stride=u, padding=(k - u) // 2)
        got = layers.conv_transpose_same(x, conv, torch.float32)
        assert got.shape == (2, 3, 9 * u) and torch.equal(got, want)


def test_published_shapes():
    """``BigVGANConfig()`` is bigvgan_22khz_80band: 112.2 M parameters
    (0.86 M in conv_pre, 12.2 M in the transposed convolutions, 99.1 M in
    the AMP blocks' convolutions), hop 256."""
    with torch.device("meta"):
        g = BigVGANGenerator(BigVGANConfig())
    count = lambda prefix: sum(p.numel() for n, p in g.named_parameters()  # noqa: E731
                               if n.startswith(prefix))
    assert abs(count("") / 1e6 - 112.2) < 0.1
    assert round(count("conv_pre") / 1e6, 2) == 0.86 and round(count("ups") / 1e6, 1) == 12.2
    amp = sum(p.numel() for n, p in g.named_parameters() if ".convs" in n)
    assert round(amp / 1e6, 1) == 99.1 and math.prod(g.cfg.upsample_rates) == 256
    assert g.ups[0].weight.shape == (1536, 768, 8) and g.conv_post.weight.shape == (1, 24, 7)
    assert not {"aa_up", "aa_down"} & set(g.state_dict())


def test_ranges_per_call():
    """Under a profiler a call is ``advoc.bigvgan`` ⊃ ``pre``, ``up0``…
    ``up5``, ``post``; each ``up<i>`` holds its transposed convolution's
    ``conv`` and ``mrf``, which holds every ``aa_act`` and ``conv``: 109
    ``advoc.aa_act`` at the published block structure (6 levels × 3 blocks
    × 6, and ``activation_post``), at width 64."""
    g = BigVGANGenerator(BigVGANConfig(upsample_initial_channel=64, dtype="float32")).eval()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g(torch.zeros(1, 80, 2))
    got = [(e.name, e.cpu_parent.name if e.cpu_parent else None)
           for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    names = [n for n, _ in got]
    assert names.count("advoc.aa_act") == 109 and names.count("advoc.bigvgan") == 1
    tops = [n for n, p in got if p == "advoc.bigvgan"]
    assert tops == ["advoc.pre"] + [f"advoc.up{i}" for i in range(6)] + ["advoc.post"]
    assert {p for n, p in got if n == "advoc.aa_act"} == {"advoc.mrf", "advoc.post"}
    assert {p for n, p in got if n == "advoc.mrf"} == {f"advoc.up{i}" for i in range(6)}
    assert names.count("advoc.conv") == 1 + 6 + 6 * 3 * 6 + 1
