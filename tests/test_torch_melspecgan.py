"""The port's MelSpecGAN, its step and the moment panel against the JAX
package's, on the CPU.

At the JAX tests' size (``MelSpecGANConfig(latent_dim=16, width=16,
n_critic=2, dtype="float32")``, batch 2 of ``synthetic_speech``): flax
parameter trees drawn with numpy from a seed (as tests/test_torch_wavegan.py
draws them) converted with ``flax_to_state_dict``, and the JAX step's own z
and ε passed to the port's step.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader as jloader
from advoc_tpu.models.melspecgan import model as jmodel
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.train import eval_metrics as jeval
from advoc_tpu.train import gan as jgan
from advoc_tpu_torch.models.convert import flax_to_state_dict
from advoc_tpu_torch.models.melspecgan import (
    MelSpecGANConfig,
    MelSpecGANDiscriminator,
    MelSpecGANGenerator,
)
from advoc_tpu_torch.train import eval_metrics
from advoc_tpu_torch.train import gan as tgan
from test_torch_wavegan import _flax_params

SIZE = dict(latent_dim=16, width=16, n_critic=2, dtype="float32")
ADAM = (1e-4, 0.5, 0.9)  # the CLI's


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, where torch's default (one thread a core in every worker)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wav(n_critic=2, b=2) -> np.ndarray:
    return np.stack([[jloader.synthetic_speech(b * k + i, 64 * 256) for i in range(b)]
                     for k in range(n_critic)])


@pytest.fixture(scope="module")
def jside():
    jc = jmodel.MelSpecGANConfig(**SIZE)
    g, d = jmodel.MelSpecGANGenerator(jc), jmodel.MelSpecGANDiscriminator(jc)
    z0, m0 = jnp.zeros((1, jc.latent_dim)), jnp.zeros((1, jc.n_frames, jc.n_mels))
    gs, ds = (jgan.TrainState.create(apply_fn=m.apply, params=_flax_params(m, (x,), seed),
                                     tx=jgan.adam(*ADAM))
              for seed, (m, x) in enumerate(((g, z0), (d, m0))))
    step = jax.jit(jgan.make_melspecgan_train_step(g, d, jc, P))
    return types.SimpleNamespace(cfg=jc, g=g, d=d, gs=gs, ds=ds, step=step)


def _port_side(j):
    tc = MelSpecGANConfig(**dataclasses.asdict(j.cfg))
    tg, td = MelSpecGANGenerator(tc), MelSpecGANDiscriminator(tc)
    gs, ds = tgan.make_states(tg, td, seed=0, g_tx=tgan.adam(*ADAM), d_tx=tgan.adam(*ADAM))
    tg.load_state_dict(flax_to_state_dict(_np(j.gs.params), tg))
    td.load_state_dict(flax_to_state_dict(_np(j.ds.params), td))
    return types.SimpleNamespace(cfg=tc, g=tg, d=td, gs=gs, ds=ds,
                                 step=tgan.make_melspecgan_train_step(tg, td, tc))


def _jax_draws(j, key, b=2) -> dict:
    """The z and ε JAX's step takes from ``key``, in the port's layout."""
    rngs = jax.random.split(key, j.cfg.n_critic + 1)
    z, eps = [], []
    for r in rngs[:-1]:
        z_rng, gp_rng = jax.random.split(r)
        z.append(np.asarray(jax.random.normal(z_rng, (b, j.cfg.latent_dim))))
        eps.append(np.asarray(jax.random.uniform(gp_rng, (b, 1, 1))))
    z.append(np.asarray(jax.random.normal(rngs[-1], (b, j.cfg.latent_dim))))
    return {"z": torch.tensor(np.stack(z)), "eps": torch.tensor(np.stack(eps))}


class TestModels:
    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
    def test_forward_matches_flax(self, dtype, tol):
        """Generator (nearest ×2 as repeat_interleave, f32 GroupNorm, the f32
        head) and discriminator ((1, 2)-padded stride-2 convs, the NHWC
        flatten) on the same weights and inputs: float32 within 1e-5
        (measured ≤ 5.4e-7), bf16 within 2e-2 (measured 2.7e-4)."""
        c = {**SIZE, "dtype": dtype}
        jc, tc = jmodel.MelSpecGANConfig(**c), MelSpecGANConfig(**c)
        rng = np.random.default_rng(0)
        for jm, tm, x in ((jmodel.MelSpecGANGenerator(jc), MelSpecGANGenerator(tc),
                           rng.normal(size=(2, 16)).astype(np.float32)),
                          (jmodel.MelSpecGANDiscriminator(jc), MelSpecGANDiscriminator(tc),
                           rng.uniform(0, 1, (2, 64, 80)).astype(np.float32))):
            params = _flax_params(jm, (x,), seed=3)
            tm.load_state_dict(flax_to_state_dict(_np(params), tm))
            want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
            with torch.no_grad():
                got = tm(torch.tensor(x)).float().numpy()
            assert got.shape == want.shape == ((2, 64, 80) if x.ndim == 2 else (2,))
            np.testing.assert_allclose(got, want, atol=tol)

    def test_converter_rejects_a_mismatched_tree(self, jside):
        tree = _np(jside.gs.params)
        tree["norm9"] = tree["norm0"]
        with pytest.raises(ValueError, match="unexpected"):
            flax_to_state_dict(tree, MelSpecGANGenerator(MelSpecGANConfig(**SIZE)))
        tree = _np(jside.ds.params)
        tree["logit"]["kernel"] = tree["logit"]["kernel"][:-1]
        with pytest.raises(ValueError, match="does not fit"):
            flax_to_state_dict(tree, MelSpecGANDiscriminator(MelSpecGANConfig(**SIZE)))

    def test_make_states_is_seeded_and_flax_initialized(self):
        cfg = MelSpecGANConfig(**SIZE)
        a = tgan.make_states(MelSpecGANGenerator(cfg), MelSpecGANDiscriminator(cfg), seed=1)
        b = tgan.make_states(MelSpecGANGenerator(cfg), MelSpecGANDiscriminator(cfg), seed=1)
        for x, y in zip(a, b):
            torch.testing.assert_close(x.model.state_dict(), y.model.state_dict(), rtol=0, atol=0)
        g, d = a[0].model, a[1].model
        for w, fan_in in ((g.conv0.weight, 25 * 128), (d.logit.weight, 4 * 5 * 128)):
            std = 1.0 / np.sqrt(fan_in)
            assert abs(float(w.detach().std()) / std - 1.0) < 0.1
            assert float(w.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert float(g.norm0.weight.detach().min()) == 1.0


class TestStep:
    def test_one_step_matches_jax(self, jside):
        """JAX's z and ε injected, each package featurizing the (n_critic, B,
        L) batch: d_loss (two critics with the penalty) and g_loss at rtol
        1e-4, with atol 1e-5 for g_loss, a mean logit near 0 scored by the
        updated D (Adam's first update, ≈ lr · sign(g), turns the rounding of
        tiny gradients into ±lr; measured 1.8e-6 on a g_loss of 7e-3); D
        advanced n_critic times, G once."""
        t = _port_side(jside)
        key = jax.random.PRNGKey(0)
        _, ds1, jm = jside.step(jside.gs, jside.ds, jnp.asarray(_wav()), key)
        gs, ds, tm = t.step(t.gs, t.ds, torch.tensor(_wav()), draws=_jax_draws(jside, key))
        assert sorted(tm) == ["d_loss", "g_loss"]
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5 if k == "g_loss" else 0.0, err_msg=k)
        assert gs.step == 1 and ds.step == 2 == int(ds1.step)
        with pytest.raises(ValueError, match="n_critic"):
            t.step(t.gs, t.ds, torch.tensor(_wav()[0]))

    def test_gradients_match_jax(self, jside):
        """On JAX's mels: the first critic's D gradient (the penalty's double
        backward) and the G gradient (scored by JAX's updated D), each within
        1e-4 of the tensor's largest of jax.grad's."""
        t = _port_side(jside)
        j = jside
        key = jax.random.PRNGKey(1)
        draws = _jax_draws(j, key)
        mel = jgan.spectral.waveform_to_r9y9_melspec(jnp.asarray(_wav()), P)[..., :64, :]
        _, ds1, _ = j.step(j.gs, j.ds, jnp.asarray(_wav()), key)
        losses = jgan.gan_losses("wgan-gp")
        z0, eps0 = jnp.asarray(draws["z"][0].numpy()), draws["eps"][0]
        fake = j.g.apply({"params": j.gs.params}, z0)
        gp_rng = jax.random.split(jax.random.split(key, j.cfg.n_critic + 1)[0])[1]

        def d_loss(dp):
            app = lambda p, x: j.d.apply({"params": p}, x)  # noqa: E731
            return (losses.d_loss(app(dp, mel[0]), app(dp, fake))
                    + 10.0 * jgan.gradient_penalty(app, dp, mel[0], fake, gp_rng))

        def g_loss(gp):
            return losses.g_loss(j.d.apply({"params": ds1.params},
                                           j.g.apply({"params": gp}, jnp.asarray(
                                               draws["z"][-1].numpy()))))

        real_t, fake_t = torch.tensor(np.asarray(mel[0])), torch.tensor(np.asarray(fake))
        tl = tgan.gan_losses("wgan-gp")
        d_t = (tl.d_loss(t.d(real_t), t.d(fake_t))
               + 10.0 * tgan.gradient_penalty(t.d, real_t, fake_t, eps=eps0))
        d1 = MelSpecGANDiscriminator(t.cfg)
        d1.load_state_dict(flax_to_state_dict(_np(ds1.params), d1))
        g_t = tl.g_loss(d1(t.g(draws["z"][-1])))
        for fn, params, model, loss in ((d_loss, j.ds.params, t.d, d_t),
                                        (g_loss, j.gs.params, t.g, g_t)):
            want = flax_to_state_dict(_np(jax.jit(jax.grad(fn))(params)), model)
            got = torch.autograd.grad(loss, list(model.parameters()))
            for (name, _), g in zip(model.named_parameters(), got):
                scale = float(want[name].abs().max())
                np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4 * scale,
                                           err_msg=name)

    def test_draws_from_the_generator_are_seeded(self):
        cfg = MelSpecGANConfig(**SIZE)
        runs = []
        for _ in range(2):
            g, d = MelSpecGANGenerator(cfg), MelSpecGANDiscriminator(cfg)
            gs, ds = tgan.make_states(g, d, seed=0)
            runs.append(tgan.make_melspecgan_train_step(g, d, cfg)(
                gs, ds, torch.tensor(_wav()), torch.Generator().manual_seed(2))[2])
        assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        assert all(bool(torch.isfinite(v)) for v in runs[0].values())


def test_moment_panel_matches_jax():
    """Population standard deviations, as JAX's: every metric within 1e-6."""
    rng = np.random.default_rng(4)
    real = rng.uniform(0, 1, (3, 64, 80)).astype(np.float32)
    fake = (rng.uniform(0, 1, (3, 64, 80)) ** 2).astype(np.float32)
    want = jeval.melspec_moment_panel(jnp.asarray(real), jnp.asarray(fake))
    got = eval_metrics.melspec_moment_panel(torch.tensor(real), torch.tensor(fake))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, err_msg=k)
