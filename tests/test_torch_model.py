"""The port's AdvocGenerator against the flax generator, same weights.

A random flax init is converted with flax_to_torch_state_dict and both
generators get the same numpy input. Also pins each layer divergence between
flax and torch that the converter and the port's layers account for.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import GroupNorm, PatchDiscriminator, small_config


def _pair(t_frames, small=False, **cfg):
    """(flax output, port output) of one random init on one random input;
    ``small`` builds both from their package's ``small_config``."""
    jcfg = (jmodel.small_config(n_frames=t_frames, **cfg) if small
            else jmodel.AdvocConfig(n_frames=t_frames, **cfg))
    g = jmodel.AdvocGenerator(jcfg)
    # jit: one compile of the whole graph is far quicker than op-by-op.
    params = jax.jit(g.init)(jax.random.PRNGKey(0), jnp.zeros((1, t_frames, jcfg.n_freq)))
    params = params["params"]
    x = np.random.default_rng(0).uniform(0, 1, (2, t_frames, jcfg.n_freq)).astype(np.float32)
    x[:, :, -1] = 0.25  # the Nyquist bin passes through
    want = np.asarray(jax.jit(g.apply)({"params": params}, jnp.asarray(x)))
    tcfg = (small_config(n_frames=t_frames, **cfg) if small
            else AdvocConfig(n_frames=t_frames, **cfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    with torch.no_grad():
        got = tg(torch.tensor(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got[..., -1], x[..., -1])
    return want, got


class TestGenerator:
    def test_f32_small(self):
        want, got = _pair(64, width=8, depth=4, dtype="float32")
        # float32 convolutions summed in another order: a few ulps of [0, 1].
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_bf16_small(self):
        want, got = _pair(64, width=8, depth=4, dtype="bfloat16")
        # bfloat16 keeps 8 bits (one ulp at 1.0 is 2^-8 ≈ 0.004), and the two
        # frameworks round in different places (flax adds the conv bias after
        # rounding the product): a few ulps at most, far less on average.
        np.testing.assert_allclose(got, want, atol=0.05)
        assert np.abs(got - want).mean() < 5e-3

    def test_f32_full_width_and_depth(self):
        """AdvocConfig()'s widths and depth, B=2 × 256 frames, in float32."""
        want, got = _pair(256, dtype="float32")
        np.testing.assert_allclose(got, want, atol=5e-5)


class TestPackedTail:
    """packed_tail=True against the JAX packed-tail generator (its XLA
    branch on the CPU) on the same converted weights, at
    tests/test_models.py's tolerances."""

    def test_f32_small(self):
        want, got = _pair(64, width=8, depth=4, dtype="float32", packed_tail=True)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_bf16_small(self):
        want, got = _pair(64, width=8, depth=4, dtype="bfloat16", packed_tail=True)
        np.testing.assert_allclose(got, want, atol=4e-2)
        assert np.abs(got - want).mean() < 5e-3

    def test_default_state_dict_loads_and_gives_the_default_function(self):
        """The same parameter tree as the default config: a default state
        dict loads strictly, and in float32 both compute one function."""
        cfg = AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32")
        g = AdvocGenerator(cfg)
        g.reset_parameters(torch.Generator().manual_seed(0))
        gp = AdvocGenerator(dataclasses.replace(cfg, packed_tail=True))
        gp.load_state_dict(g.state_dict(), strict=True)
        assert type(gp.ups[-1]).__name__ == "_PackedTailUp"
        x = torch.tensor(np.random.default_rng(3).uniform(0, 1, (2, 64, 513)).astype(np.float32))
        with torch.no_grad():
            torch.testing.assert_close(gp(x), g(x), rtol=0, atol=2e-5)

    @pytest.mark.parametrize("cfg", [dict(head_kernel=4), dict(upsample="subpixel")])
    def test_invalid_config_raises_like_jax(self, cfg):
        """The JAX generator's ValueError (tests/test_models.py pins it there)."""
        with pytest.raises(ValueError, match="packed_tail requires"):
            AdvocGenerator(AdvocConfig(packed_tail=True, **cfg))


class TestFastHead:
    """fast_head (the half-resolution head of small_config) against flax on
    the same converted weights, at TestGenerator's tolerances."""

    def test_f32_small(self):
        want, got = _pair(64, small=True, width=8, depth=4, dtype="float32")
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_bf16_small(self):
        want, got = _pair(32, small=True, width=8, depth=3, dtype="bfloat16")
        np.testing.assert_allclose(got, want, atol=0.05)
        assert np.abs(got - want).mean() < 5e-3

    def test_small_config_at_its_published_width(self):
        """width 24, depth 6, 64 frames, in float32 (B=2)."""
        want, got = _pair(64, small=True, dtype="float32")
        np.testing.assert_allclose(got, want, atol=5e-5)

    def test_packed_tail_is_ignored(self):
        """JAX ignores packed_tail under fast_head (model.py:449), also with
        options packed_tail would refuse."""
        want, got = _pair(32, small=True, width=8, depth=3, dtype="float32",
                          packed_tail=True, head_kernel=4)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_depth_to_space_order(self):
        """Channel dy·2p + dx·p + k of half-res pixel (h, w) lands on frame
        2h + dy, bin (2w + dx)·p + k: a head that writes its channel index
        everywhere shows the order, against the flax reshape."""
        cfg = small_config(n_frames=8, width=8, depth=2, dtype="float32")
        g = AdvocGenerator(cfg)
        with torch.no_grad():
            for m in g.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    m.weight.zero_()
                    m.bias.zero_()
            g.head.bias.copy_(torch.arange(8, dtype=torch.float32) / 100.0)  # 4·p, p = 2
            out = g(torch.zeros(1, 8, 513))
        d = jnp.broadcast_to(jnp.arange(8, dtype=jnp.float32) / 100.0, (1, 4, 128, 8))
        want = np.asarray(d.reshape(1, 4, 128, 2, 2, 2).transpose(0, 1, 3, 2, 4, 5)
                          .reshape(1, 8, 512))
        np.testing.assert_array_equal(out[0, :, :512].numpy(), want[0])

    def test_converter_name_map(self):
        """No up{depth-1}; head is a 3×3 conv to 4·p: the tree loads
        strictly, and a full-head tree does not fit."""
        cfg = jmodel.small_config(n_frames=32, width=8, depth=3, dtype="float32")
        tree = jax.tree.map(np.asarray, jax.jit(jmodel.AdvocGenerator(cfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, cfg.n_freq)))["params"])
        assert "up2" not in tree and tree["head"]["kernel"].shape == (3, 3, 16 + 8, 8)
        tcfg = small_config(n_frames=32, width=8, depth=3, dtype="float32")
        g = AdvocGenerator(tcfg)
        g.load_state_dict(flax_to_torch_state_dict(tree, tcfg), strict=True)
        assert len(g.ups) == 2 and tuple(g.head.weight.shape) == (8, 24, 3, 3)
        with pytest.raises(ValueError, match="missing.*up2"):
            flax_to_torch_state_dict(tree, dataclasses.replace(tcfg, fast_head=False))


class TestLayerDivergences:
    """The flax → torch correspondences the port is built on."""

    @pytest.fixture
    def x_nhwc(self):
        return np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)

    def _flax(self, layer, x):
        params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
        kernel = np.asarray(params["params"]["kernel"])
        bias = np.asarray(params["params"]["bias"])
        return np.asarray(layer.apply(params, jnp.asarray(x))), kernel, bias

    def test_conv_transpose_needs_flipped_kernel(self, x_nhwc):
        want, k, b = self._flax(fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME"), x_nhwc)
        x = torch.tensor(x_nhwc).permute(0, 3, 1, 2)

        def run(kernel):
            w = torch.tensor(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
            y = F.conv_transpose2d(x, w, torch.tensor(b), stride=2, padding=1)
            return y.permute(0, 2, 3, 1).numpy()

        np.testing.assert_allclose(run(k[::-1, ::-1]), want, atol=1e-5)
        assert np.abs(run(k) - want).max() > 1e-2  # unflipped is another map

    def test_conv_k4_s2_same_pads_one(self, x_nhwc):
        want, k, b = self._flax(fnn.Conv(4, (4, 4), strides=(2, 2), padding="SAME"), x_nhwc)
        x = torch.tensor(x_nhwc).permute(0, 3, 1, 2)
        w = torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        y = F.conv2d(x, w, torch.tensor(b), stride=2, padding=1).permute(0, 2, 3, 1)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5)

    def test_conv_k4_s1_same_pads_one_then_two(self, x_nhwc):
        """The discriminator's stride-1 k4 convs (not ported yet) pad (1, 2)."""
        want, k, b = self._flax(fnn.Conv(4, (4, 4), padding="SAME"), x_nhwc)
        x = F.pad(torch.tensor(x_nhwc).permute(0, 3, 1, 2), (1, 2, 1, 2))
        w = torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        y = F.conv2d(x, w, torch.tensor(b)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5)

    def test_group_norm_eps_and_dtype(self):
        # Small-variance groups make eps 1e-6 vs torch's 1e-5 visible.
        x = (1e-3 * np.random.default_rng(2).standard_normal((2, 4, 4, 16))).astype(np.float32)
        layer = fnn.GroupNorm(num_groups=8, dtype=jnp.bfloat16, param_dtype=jnp.float32)
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
        want = np.asarray(layer.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        xt = torch.tensor(x).permute(0, 3, 1, 2).to(torch.bfloat16)
        got = GroupNorm(8, 16, torch.bfloat16)(xt)
        assert got.dtype == torch.bfloat16
        got = got.float().permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, want, atol=2e-2)  # a bf16 ulp is 2^-6 for |y| in [2, 4)
        torch_default = F.group_norm(xt.float(), 8).permute(0, 2, 3, 1).numpy()
        assert np.abs(torch_default - want).max() > 0.1

    def test_freq_pack_layout(self):
        """Bin w·p + c of the body is channel c, column w of the NCHW input."""
        body = torch.arange(2 * 3 * 512, dtype=torch.float32).reshape(2, 3, 512)
        packed = body.reshape(2, 3, 256, 2).permute(0, 3, 1, 2)
        assert packed[1, 1, 2, 7] == body[1, 2, 7 * 2 + 1]
        torch.testing.assert_close(packed.permute(0, 2, 3, 1).reshape(2, 3, 512), body)


class TestConverter:
    @pytest.fixture(scope="class")
    def tree(self):
        cfg = jmodel.AdvocConfig(n_frames=32, width=8, depth=3, dtype="float32")
        params = jax.jit(jmodel.AdvocGenerator(cfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, cfg.n_freq)))["params"]
        return jax.tree.map(np.asarray, params)

    def _cfg(self):
        return AdvocConfig(n_frames=32, width=8, depth=3, dtype="float32")

    def test_round_trip_loads_strictly(self, tree):
        sd = flax_to_torch_state_dict(tree, self._cfg())
        AdvocGenerator(self._cfg()).load_state_dict(sd, strict=True)

    def test_missing_leaf_raises(self, tree):
        bad = {k: v for k, v in tree.items() if k != "head"}
        with pytest.raises(ValueError, match="missing.*head"):
            flax_to_torch_state_dict(bad, self._cfg())

    def test_unexpected_leaf_raises(self, tree):
        bad = dict(tree, extra={"kernel": np.zeros(3)})
        with pytest.raises(ValueError, match="unexpected.*extra"):
            flax_to_torch_state_dict(bad, self._cfg())

    def test_shape_mismatch_raises(self, tree):
        bad = dict(tree, head={"kernel": np.zeros((3, 3, 8, 2)), "bias": tree["head"]["bias"]})
        with pytest.raises(ValueError, match="does not fit"):
            flax_to_torch_state_dict(bad, self._cfg())


class TestInitAndModes:
    def test_reset_parameters_mirrors_flax_init(self):
        cfg = AdvocConfig(width=16)
        g = AdvocGenerator(cfg)
        g.reset_parameters(torch.Generator().manual_seed(0))
        w = g.downs[2].conv.weight.detach()  # (64, 32, 4, 4): fan_in 512
        std = 1.0 / np.sqrt(512)
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert float(g.ups[0].conv.bias.detach().abs().max()) == 0.0
        assert float(g.ups[0].norm.weight.detach().min()) == 1.0
        h = AdvocGenerator(cfg)
        h.reset_parameters(torch.Generator().manual_seed(0))
        torch.testing.assert_close(h.state_dict(), g.state_dict(), rtol=0, atol=0)

    @pytest.mark.parametrize("cfg", [
        dict(upsample="pixelshuffle"), dict(fast_head=True, upsample="resize"),
        dict(upsample="subpixel"), dict(head_kernel=4),
    ])
    def test_unported_modes_raise(self, cfg):
        """The modes that raised before are ported: each builds, converts
        from flax and computes the flax generator's function (float32, as
        test_f32_small; tests/test_torch_model_modes.py has the rest)."""
        want, got = _pair(32, width=8, depth=3, dtype="float32", **cfg)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_discriminator_and_hook_raise(self):
        """PatchDiscriminator, which raised before, is ported
        (tests/test_torch_train.py holds it to flax); it rejects a freq_pack
        that does not divide the bins, as the generator does. The profiling
        hook, which raised before, returns the stage's mean (held to flax's
        in tests/test_torch_model_modes.py)."""
        d = PatchDiscriminator(AdvocConfig(n_frames=32, disc_width=8))
        assert d(torch.zeros(1, 32, 513), torch.zeros(1, 32, 513)).shape == (1, 4, 32, 1)
        with pytest.raises(ValueError, match="freq_pack"):
            PatchDiscriminator(AdvocConfig(freq_pack=3))
        g = AdvocGenerator(AdvocConfig(n_frames=32, width=8, depth=3))
        assert g(torch.zeros(1, 32, 513), truncate_after="down0").shape == ()
