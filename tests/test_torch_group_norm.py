"""The U-Net's GroupNorm + activation (advoc_tpu_torch.ops.kernels.group_norm) on the CPU.

The plain version, which is also the port's ``GroupNorm``, is GroupNorm
followed by the level's activation, held to torch's own ``F.group_norm`` in
float64 at every normalised level; the U-Net's levels take the plain path
on the CPU (the kernel runs only on the card, where tests/test_torch_cuda.py
holds it to the plain version); the wrapper on a CPU tensor is the plain
version in the input's layout and refuses what the kernel does not take,
and inside ``_build.plain_when_traced`` it traces as plain aten (as does
WaveGAN's epilogue); the tiles follow
the shape. A convolution's bias handed to the pair (``conv_bias``) is the
bias added in x's dtype first, and the levels hand it over only where the
kernel pair takes them and the bias is per channel of the normalised tensor.
"""

import pytest
import torch
import torch.nn.functional as F

from advoc_tpu_torch.models import layers
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import group_norm as tgn
from advoc_tpu_torch.utils.roofline import group_norm_levels

# AdvocConfig()'s levels at 64 frames: the widths and groups of the full
# generator, a quarter of its frames.
_LEVELS = group_norm_levels(AdvocConfig(n_frames=64), 2)


def _x(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("act", tgn.ACTS)
@pytest.mark.parametrize("name,shape", [(n, s) for n, _, s in _LEVELS],
                         ids=[n for n, _, _ in _LEVELS])
def test_plain_is_groupnorm_then_activation(name, shape, act):
    """The bf16 result within its rounding (2^-7 relative: half an ulp,
    2^-8, before the activation and again after LeakyReLU's product) and the f32
    statistics' (1e-5) of GroupNorm (eps 1e-6) and the activation in
    float64 by torch's F.group_norm, in x's layout; the layer's GroupNorm
    followed by the activation is the same function."""
    x = _x(shape, seed=shape[1] + shape[2])
    norm = layers.GroupNorm(8, shape[1], torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.2 * torch.randn(shape[1], generator=g))
        norm.bias.copy_(0.1 * torch.randn(shape[1], generator=g))
        got = tgn.group_norm_act_plain(x, norm.weight, norm.bias, 8, act)
        ref = F.group_norm(x.double(), 8, norm.weight.double(), norm.bias.double(), eps=1e-6)
        ref = F.leaky_relu(ref, 0.2) if act == "leaky_relu" else F.relu(ref)
        layer = tgn.activate(norm(x), act)
    assert got.dtype == torch.bfloat16 and got.stride() == x.stride()
    torch.testing.assert_close(got.double(), ref, rtol=2**-7, atol=1e-5)
    assert torch.equal(layer, got)


def test_levels_take_the_plain_path_on_the_cpu(monkeypatch):
    """_Down and _Up on CPU tensors, with and without autograd, never reach
    the kernel's wrapper, and equal conv → GroupNorm → activation."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(layers, "group_norm_act_kernel", refuse)
    g = AdvocGenerator(AdvocConfig(n_frames=64, width=8, depth=4))
    g.reset_parameters(torch.Generator().manual_seed(0))
    x = _x((2, 8, 16, 64), seed=2)
    down, up = g.downs[1], g.ups[1]
    dt = torch.bfloat16
    for ctx in (torch.inference_mode, torch.enable_grad):
        with ctx():
            got = down(x)
            want = F.leaky_relu(down.norm(layers.conv_same(x, down.conv, dt)), 0.2)
            assert torch.equal(got, want)
            xu = _x((2, 96, 4, 16), seed=3)
            got = up(xu)
            want = F.relu(up.norm(layers.conv_transpose_same(xu, up.conv, dt)))
            assert torch.equal(got, want)
    assert _build.launches["group_norm_act"] == 0


@pytest.mark.parametrize("nchw", [False, True])
def test_wrapper_on_the_cpu_is_the_plain_version(nchw):
    """In each compute dtype the kernel takes, in x's dtype and layout."""
    x = _x((2, 64, 8, 12), seed=4)
    x = x.contiguous() if nchw else x
    w, b = torch.linspace(0.5, 1.5, 64), torch.linspace(-0.1, 0.1, 64)
    for dtype in tgn.DTYPES:
        xd = x.to(dtype)
        for act in tgn.ACTS:
            got = tgn.group_norm_act_kernel(xd, w, b, 8, act)
            assert torch.equal(got, tgn.group_norm_act_plain(xd, w, b, 8, act))
            assert got.dtype == dtype and got.stride() == x.stride()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x = _x((2, 64, 8, 8), seed=5)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="C % 8"):
        tgn.group_norm_act_kernel(x[:, :60], w[:60], b[:60], 4, "relu")
    with pytest.raises(ValueError, match="C % 8"):
        tgn.group_norm_act_kernel(x, w, b, 7, "relu")
    with pytest.raises(ValueError, match="float16 or float32"):
        tgn.group_norm_act_kernel(x.double(), w, b, 8, "relu")
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        tgn.group_norm_act_kernel(x.transpose(2, 3), w, b, 8, "relu")
    with pytest.raises(ValueError, match=r"\(C / groups\)"):
        tgn.group_norm_act_kernel(_x((1, 24, 1, 2), seed=6).contiguous(), w[:24], b[:24], 8,
                                  "relu")


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", tgn.DTYPES, ids=["bf16", "f16", "f32"])
def test_plain_folds_the_conv_bias(dtype, nchw):
    """The plain version given a convolution's bias is the plain version of
    x plus that bias cast to x's dtype (the convolution's bias add) bit for
    bit, in x's dtype and layout; the wrapper on the CPU is the same."""
    x = _x((2, 16, 4, 6), seed=10).to(dtype)
    x = x.contiguous() if nchw else x
    w, b = torch.linspace(0.5, 1.5, 16), torch.linspace(-0.1, 0.1, 16)
    cb = torch.randn(16, generator=torch.Generator().manual_seed(11))
    for act in tgn.ACTS:
        got = tgn.group_norm_act_plain(x, w, b, 8, act, conv_bias=cb)
        want = tgn.group_norm_act_plain(x + cb.to(dtype).reshape(16, 1, 1), w, b, 8, act)
        assert torch.equal(got, want) and got.dtype == dtype and got.stride() == x.stride()
        assert torch.equal(tgn.group_norm_act_kernel(x, w, b, 8, act, cb), got)


def test_wrapper_refuses_a_conv_bias_of_another_shape():
    x = _x((2, 16, 4, 6), seed=12)
    w, b = torch.ones(16), torch.zeros(16)
    for cb in (torch.zeros(8), torch.zeros(16, 1), torch.zeros(()), torch.zeros(1, 16)):
        with pytest.raises(ValueError, match="conv_bias must be"):
            tgn.group_norm_act_kernel(x, w, b, 8, "relu", cb)


def _fake_card(shape):
    """A tensor that says it lives on the card, without one: a fake tensor,
    enough for the levels' decision, which reads the device and autograd."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return torch.empty(shape, device="cuda", dtype=torch.bfloat16)


@pytest.mark.parametrize("upsample", ["convtranspose", "resize", "pixelshuffle", "subpixel"])
def test_levels_fold_the_conv_bias_only_where_the_kernel_takes_it(upsample):
    """A _Down with a norm and an _Up in convtranspose or resize mode hand
    their bias to the GroupNorm pair on a card tensor without autograd; not
    on the CPU, not where autograd records the level, and never in the two
    depth-to-space modes, whose bias precedes the shuffle; nor does the
    unnormalised first _Down."""
    from advoc_tpu_torch.models.advoc.model import folds_bias

    g = AdvocGenerator(AdvocConfig(n_frames=64, width=8, depth=4, upsample=upsample))
    down0, down, up = g.downs[0], g.downs[1], g.ups[1]
    card, cpu = _fake_card((2, 8, 16, 64)), torch.zeros((2, 8, 16, 64))
    per_channel = upsample in ("convtranspose", "resize")
    with torch.no_grad():
        assert (folds_bias(down, card), folds_bias(up, card)) == (True, per_channel)
        assert not (folds_bias(down0, card) or folds_bias(down, cpu) or folds_bias(up, cpu))
    assert not (folds_bias(down, card) or folds_bias(up, card))  # autograd records the level
    g.requires_grad_(False)
    assert (folds_bias(down, card), folds_bias(up, card)) == (True, per_channel)


def _traced_cases():
    """Per kernel that stands for no Pallas kernel: its wrapper, its plain
    version, an input, and a function making the other arguments (made
    inside the traced call, as constants of the program)."""
    from advoc_tpu_torch.ops.kernels import conv_bias_act as tcba

    y = (torch.randn((2, 16, 65), generator=torch.Generator().manual_seed(9))).to(torch.bfloat16)
    return {
        "group_norm_act": (tgn.group_norm_act_kernel, tgn.group_norm_act_plain,
                           _x((2, 16, 4, 6), seed=8),
                           lambda: (torch.linspace(0.5, 1.5, 16), torch.zeros(16), 8, "relu")),
        "conv_bias_act": (tcba.conv_bias_act_kernel, tcba.conv_bias_act_plain, y,
                          lambda: (torch.linspace(-0.5, 0.5, 16).to(torch.bfloat16), 0, 1,
                                   "leaky_relu", torch.float32)),
    }


@pytest.mark.parametrize("name", ["group_norm_act", "conv_bias_act"])
def test_plain_when_traced_records_plain_aten(name):
    """Inside _build.plain_when_traced the traced wrapper of a kernel that
    stands for no Pallas kernel is the plain version's aten ops (no advoc
    operator recorded), bit-equal to the plain version; outside, the
    registered operator again."""
    from advoc_tpu_torch.ops.kernels import registered

    kernel, plain, x, rest = _traced_cases()[name]

    class Call(torch.nn.Module):
        def forward(self, x):
            return kernel(x, *rest())

    with _build.plain_when_traced():
        program = torch.export.export(Call(), (x,))
    assert registered.recorded(program.graph_module) == []
    assert torch.equal(program.module()(x), plain(x, *rest()))
    program = torch.export.export(Call(), (x,))
    assert registered.recorded(program.graph_module) == [f"advoc::{name}"]


def test_tiles_follow_the_shape():
    """At 128 windows every level but the smallest gives 132 SMs 16 CTAs
    each or its samples' whole tiles; a sample of 2048 vectors or fewer is
    one tile."""
    for _, _, (b, c, h, w) in group_norm_levels(AdvocConfig(), 128):
        vectors = h * w * c // 8
        nt = tgn.tiles(b, vectors, 132)
        assert b * nt >= 16 * 132 or nt == -(-vectors // 2048)
        assert nt == 1 or vectors / nt >= 2048 / 2
    assert tgn.tiles(30, 1024, 132) == 1
    assert tgn.tiles(128, 65536 * 8, 132) == 17
