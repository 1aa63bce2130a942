"""The U-Net's GroupNorm + activation (advoc_tpu_torch.ops.kernels.group_norm) on the CPU.

The plain version, which is also the port's ``GroupNorm``, is GroupNorm
followed by the level's activation, held to torch's own ``F.group_norm`` in
float64 at every normalised level; the U-Net's levels take the plain path
on the CPU (the kernel runs only on the card, where tests/test_torch_cuda.py
holds it to the plain version); the wrapper on a CPU tensor is the plain
version in the input's layout and refuses what the kernel does not take,
and inside ``plain_when_traced`` it traces as plain aten; the tiles follow
the shape.
"""

import pytest
import torch
import torch.nn.functional as F

from advoc_tpu_torch.models import layers
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
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
    assert tgn.group_norm_act_kernel.launches == 0


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


def test_plain_when_traced_records_plain_aten():
    """Inside plain_when_traced the traced wrapper is the plain version's
    aten ops (no advoc operator recorded), bit-equal to the plain version;
    outside, the registered operator again."""
    from advoc_tpu_torch.ops.kernels import registered

    class Norm(torch.nn.Module):
        def forward(self, x):
            return tgn.group_norm_act_kernel(x, torch.linspace(0.5, 1.5, 16), torch.zeros(16), 8,
                                             "relu")

    x = _x((2, 16, 4, 6), seed=8)
    with tgn.plain_when_traced():
        program = torch.export.export(Norm(), (x,))
    assert registered.recorded(program.graph_module) == []
    assert torch.equal(program.module()(x), tgn.group_norm_act_plain(
        x, torch.linspace(0.5, 1.5, 16), torch.zeros(16), 8, "relu"))
    program = torch.export.export(Norm(), (x,))
    assert registered.recorded(program.graph_module) == ["advoc::group_norm_act"]


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
