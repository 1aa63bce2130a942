"""The port's WaveGAN and conditional WaveGAN against the JAX package's, on
the CPU.

At the JAX tests' sizes (WaveGAN: slice 1024, latent 32, width 16;
conditional: 16 frames, width 8; float32, n_critic 2, batch 2): a flax
parameter tree drawn with numpy from a seed (:func:`_flax_params`: no flax
init to compile) converted with ``flax_to_state_dict``, the same
numpy-seeded inputs, and the JAX step's own draws (z, the wgan-gp ε, the
phase-shuffle shifts, each from the key the JAX step takes it from) passed
to the port's step.
"""

import dataclasses
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader as jloader
from advoc_tpu.models.wavegan import conditional as jcond
from advoc_tpu.models.wavegan import model as jwave
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.train import gan as jgan
from advoc_tpu_torch.models.convert import flax_to_state_dict
from advoc_tpu_torch.models.layers import phase_shuffle, transpose_crop
from advoc_tpu_torch.models.wavegan import (
    CondWaveGANConfig,
    CondWaveGANDiscriminator,
    CondWaveGANGenerator,
    WaveGANConfig,
    WaveGANDiscriminator,
    WaveGANGenerator,
)
from advoc_tpu_torch.train import gan as tgan
from advoc_tpu_torch.utils import profiling

WAVE = dict(slice_len=1024, latent_dim=32, width=16, n_critic=2, dtype="float32")
COND = dict(n_frames=16, width=8, dtype="float32")
ADAM = dict(wave=(1e-4, 0.5, 0.9), cond=(2e-4, 0.5, 0.999))


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


def _wav(b: int, length: int, seed: int = 0) -> np.ndarray:
    return np.stack([jloader.synthetic_speech(seed + i, length) for i in range(b)])


def _flax_params(module, inputs, seed: int):
    """A parameter tree of the flax ``module`` (its shapes by
    ``jax.eval_shape``), drawn with numpy: kernels normal at flax's fan-in
    scale, biases and norm offsets 0.1·normal, norm scales 1 + 0.1·normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, inputs))

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.1 * x + (1.0 if name == "scale" else 0.0)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _jax_side(cond: bool, **over):
    """JAX's models, their training states on :func:`_flax_params` trees at
    the CLI's Adam, and the jitted step."""
    if cond:
        jc = jcond.CondWaveGANConfig(**{**COND, **over})
        g, d = jcond.CondWaveGANGenerator(jc), jcond.CondWaveGANDiscriminator(jc)
        m0, w0 = jnp.zeros((1, jc.n_frames, jc.n_mels)), jnp.zeros((1, jc.slice_len))
        init = ((m0,), (w0, m0))
        step = jgan.make_cond_wavegan_train_step(g, d, jc, P)
    else:
        jc = jwave.WaveGANConfig(**{**WAVE, **over})
        g, d = jwave.WaveGANGenerator(jc), jwave.WaveGANDiscriminator(jc)
        init = ((jnp.zeros((1, jc.latent_dim)),), (jnp.zeros((1, jc.slice_len)),))
        step = jgan.make_wavegan_train_step(g, d, jc)
    lr, b1, b2 = ADAM["cond" if cond else "wave"]
    gs, ds = (jgan.TrainState.create(apply_fn=m.apply, params=_flax_params(m, x, seed),
                                     tx=jgan.adam(lr, b1, b2))
              for seed, (m, x) in enumerate(((g, init[0]), (d, init[1]))))
    return types.SimpleNamespace(cfg=jc, g=g, d=d, gs=gs, ds=ds, step=jax.jit(step), cond=cond,
                                 adam=(lr, b1, b2))


def _port_side(j):
    """The port's models and states on ``j``'s converted weights."""
    cls = ((CondWaveGANConfig, CondWaveGANGenerator, CondWaveGANDiscriminator) if j.cond
           else (WaveGANConfig, WaveGANGenerator, WaveGANDiscriminator))
    tc = cls[0](**dataclasses.asdict(j.cfg))
    tg, td = cls[1](tc), cls[2](tc)
    lr, b1, b2 = j.adam
    gs, ds = tgan.make_states(tg, td, seed=0, g_tx=tgan.adam(lr, b1, b2),
                              d_tx=tgan.adam(lr, b1, b2))
    tg.load_state_dict(flax_to_state_dict(_np(j.gs.params), tg))
    td.load_state_dict(flax_to_state_dict(_np(j.ds.params), td))
    step = (tgan.make_cond_wavegan_train_step(tg, td, tc) if j.cond
            else tgan.make_wavegan_train_step(tg, td, tc))
    return types.SimpleNamespace(cfg=tc, g=tg, d=td, gs=gs, ds=ds, step=step)


def _shifts(key, cfg, n_layers: int, b: int) -> np.ndarray:
    """The JAX discriminator's shifts: layer i from fold_in(key, i)."""
    r = cfg.phase_shuffle
    return np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, i), (b,), -r, r + 1))
                     for i in range(n_layers)])


def _jax_draws(j, key, b: int) -> dict:
    """The draws JAX's step takes from ``key``, in the port step's layout."""
    n_layers = (j.cfg.n_up + 1 if j.cond else j.cfg.n_up) - 1
    if j.cond:
        rng_d, rng_ps, rng_ps2 = jax.random.split(key, 3)
        return {"eps": np.asarray(jax.random.uniform(rng_d, (1, b, 1))),
                "shifts": np.stack([_shifts(k, j.cfg, n_layers, b) for k in (rng_ps, rng_ps2)])}
    rngs = jax.random.split(key, j.cfg.n_critic + 1)
    z, eps, shifts = [], [], []
    for r in rngs[:-1]:
        z_rng, gp_rng, ps_rng = jax.random.split(r, 3)
        z.append(jax.random.normal(z_rng, (b, j.cfg.latent_dim)))
        eps.append(jax.random.uniform(gp_rng, (b, 1)))
        shifts.append(_shifts(ps_rng, j.cfg, n_layers, b))
    z_rng, ps_rng = jax.random.split(rngs[-1])
    z.append(jax.random.normal(z_rng, (b, j.cfg.latent_dim)))
    shifts.append(_shifts(ps_rng, j.cfg, n_layers, b))
    return {"z": np.stack(z), "eps": np.stack(eps), "shifts": np.stack(shifts)}


def _t(draws: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def wave():
    return _jax_side(cond=False)


@pytest.fixture(scope="module")
def cond():
    return _jax_side(cond=True, gan_type="wgan-gp")


def _forward_pair(jmod, tmod, args, **kw):
    params = _flax_params(jmod, args, seed=3)
    tmod.load_state_dict(flax_to_state_dict(_np(params), tmod))
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(
        params, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = tmod(*map(torch.tensor, args)).float().numpy()
    assert got.shape == want.shape
    return got, want


class TestModels:
    @pytest.mark.parametrize("kw,tol", [
        (dict(), 1e-5), (dict(kernel=25), 1e-5), (dict(dtype="bfloat16"), 2e-2),
        (dict(slice_len=65536, width=2, kernel=25), 1e-5),
    ], ids=["f32", "f32_k25", "bf16", "f32_65536_k25"])
    def test_wavegan_forward_matches_flax(self, kw, tol):
        """float32 convolutions summed in other orders, within 1e-5
        (measured ≤ 2.6e-7); k25/s4 crops the transposed convolutions' full
        output asymmetrically (10, 11); bf16 within 2e-2 (measured 6.8e-4,
        the two rounding the bias add in different places). The published
        65,536 slice (six levels, c0 = 64 · width) at width 2."""
        c = {**WAVE, **kw}
        n = c["slice_len"]
        rng = np.random.default_rng(0)
        z = rng.normal(size=(2, 32)).astype(np.float32)
        got, want = _forward_pair(jwave.WaveGANGenerator(jwave.WaveGANConfig(**c)),
                                  WaveGANGenerator(WaveGANConfig(**c)), (z,))
        assert got.shape == (2, n)
        np.testing.assert_allclose(got, want, atol=tol)
        w = rng.uniform(-1, 1, (2, n)).astype(np.float32)
        got, want = _forward_pair(jwave.WaveGANDiscriminator(jwave.WaveGANConfig(**c)),
                                  WaveGANDiscriminator(WaveGANConfig(**c)), (w,))
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, atol=tol)

    @pytest.mark.parametrize("kw,tol", [(dict(), 1e-5), (dict(dtype="bfloat16"), 2e-2)],
                             ids=["f32", "bf16"])
    def test_conditional_forward_matches_flax(self, kw, tol):
        """Generator and patch-logit discriminator; tolerances as above
        (bf16 measured 3.5e-4)."""
        c = {**COND, **kw}
        rng = np.random.default_rng(1)
        m = rng.uniform(0, 1, (2, 16, 80)).astype(np.float32)
        got, want = _forward_pair(jcond.CondWaveGANGenerator(jcond.CondWaveGANConfig(**c)),
                                  CondWaveGANGenerator(CondWaveGANConfig(**c)), (m,))
        assert got.shape == (2, 16 * 256)
        np.testing.assert_allclose(got, want, atol=tol)
        w = rng.uniform(-1, 1, (2, 16 * 256)).astype(np.float32)
        got, want = _forward_pair(jcond.CondWaveGANDiscriminator(jcond.CondWaveGANConfig(**c)),
                                  CondWaveGANDiscriminator(CondWaveGANConfig(**c)), (w, m))
        assert got.shape == (2, 4)
        np.testing.assert_allclose(got, want, atol=tol)

    def test_discriminator_shuffles_as_jax(self, wave):
        """With JAX's shifts (fold_in(rng, i) per layer) both discriminators
        give the logits flax gives under that rng, within 1e-5."""
        t = _port_side(wave)
        w = np.random.default_rng(2).uniform(-1, 1, (2, 1024)).astype(np.float32)
        key = jax.random.PRNGKey(5)
        want = np.asarray(wave.d.apply({"params": wave.ds.params}, jnp.asarray(w), rng=key))
        shifts = _shifts(key, wave.cfg, t.d.n_shuffled, 2)
        with torch.no_grad():
            got = t.d(torch.tensor(w), torch.tensor(shifts)).numpy()
            plain = t.d(torch.tensor(w)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert not np.allclose(got, plain)

    @pytest.mark.parametrize("rad", [1, 2])
    def test_phase_shuffle_is_bit_exact(self, rad):
        """One gather against JAX's pad-and-slice: the same values, exactly,
        every shift in [−rad, rad]."""
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2 * rad + 1, 3, 9)).astype(np.float32)
        s = np.arange(-rad, rad + 1)
        want = np.asarray(jwave.phase_shuffle(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(s),
                                              rad)).transpose(0, 2, 1)
        np.testing.assert_array_equal(phase_shuffle(torch.tensor(x), torch.tensor(s), rad).numpy(),
                                      want)
        x_t = torch.tensor(x)
        assert phase_shuffle(x_t, torch.tensor(s), 0) is x_t

    def test_phase_shuffle_is_differentiable_twice(self):
        """The wgan-gp penalty differentiates through the shuffle's gradient:
        gradcheck and gradgradcheck in float64."""
        x = torch.randn(2, 3, 7, dtype=torch.float64, requires_grad=True)
        s = torch.tensor([-2, 1])
        assert torch.autograd.gradcheck(lambda a: phase_shuffle(a, s, 2) ** 2, (x,))
        assert torch.autograd.gradgradcheck(lambda a: phase_shuffle(a, s, 2) ** 2, (x,))

    def test_transpose_crop_generally(self):
        """lax's SAME transpose padding (pad_a, pad_b) turned into crops of
        conv_transpose's full output, including s > k (zeros appended)."""
        assert transpose_crop(24, 4) == (10, 10)
        assert transpose_crop(25, 4) == (10, 11)
        assert transpose_crop(5, 2) == (1, 2)
        assert transpose_crop(4, 2) == (1, 1)
        assert transpose_crop(2, 4) == (0, -2)

    def test_converters_reject_a_mismatched_tree(self, wave, cond):
        g = WaveGANGenerator(WaveGANConfig(**WAVE))
        tree = _np(wave.gs.params)
        del tree["upconv1"]
        with pytest.raises(ValueError, match="missing"):
            flax_to_state_dict(tree, g)
        tree = _np(cond.ds.params)
        tree["logit"]["kernel"] = tree["logit"]["kernel"][:2]
        with pytest.raises(ValueError, match="does not fit"):
            flax_to_state_dict(tree, CondWaveGANDiscriminator(CondWaveGANConfig(**COND)))

    def test_make_states_is_seeded_and_flax_initialized(self):
        """lecun_normal truncated at 2σ: fan_in k·cin for the transposed
        convs too, in_features for the Dense."""
        cfg = WaveGANConfig(**WAVE)
        a = tgan.make_states(WaveGANGenerator(cfg), WaveGANDiscriminator(cfg), seed=3)
        b = tgan.make_states(WaveGANGenerator(cfg), WaveGANDiscriminator(cfg), seed=3)
        for x, y in zip(a, b):
            torch.testing.assert_close(x.model.state_dict(), y.model.state_dict(), rtol=0, atol=0)
        g = a[0].model
        for w, fan_in in ((g.upconv0.weight, 24 * 64), (g.project.weight, 32)):
            std = 1.0 / np.sqrt(fan_in)
            assert abs(float(w.detach().std()) / std - 1.0) < 0.1
            assert float(w.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert float(g.upconv0.bias.detach().abs().max()) == 0.0


@pytest.fixture(scope="module")
def reference():
    """The benchmark's plain reference (``benchmark/reference/wavegan.py``),
    loaded by its path: it is no package of the repository."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "reference" / "wavegan.py"
    spec = importlib.util.spec_from_file_location("bench_reference_wavegan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carrying(g: WaveGANGenerator, seed: int) -> dict:
    """Weights under which every level carries signal: kernels normal at
    √(2·stride / (C_in·k)) (√(2 / latent_dim) for the projection; 0.4 of
    that at the last level, so tanh stays near its linear range), biases
    0.1·normal; loaded into ``g`` and returned."""
    gen = torch.Generator().manual_seed(seed)
    last = f"upconv{g.cfg.n_up - 1}.weight"
    sd = {}
    for name, v in g.state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        if name == "project.weight":
            x *= (2.0 / v.shape[1]) ** 0.5
        elif name.endswith("weight"):
            x *= (2.0 * g.cfg.stride / (v.shape[0] * v.shape[2])) ** 0.5 * (0.4 if name == last
                                                                          else 1.0)
        else:
            x *= 0.1
        sd[name] = x
    g.load_state_dict(sd)
    return sd


class TestReference:
    """The port's generator against the benchmark's plain reference, which
    decides the WaveGAN cell's ``correct`` on the card."""

    @pytest.mark.parametrize("kernel", [24, 25])
    @pytest.mark.parametrize("slice_len", [1024, 65536])
    def test_float32_equals_reference(self, reference, slice_len, kernel):
        """float32 at width 4 (four and six levels; SAME crops (10, 10) and
        (10, 11)): float32 products, the port's crop taken inside the
        convolution where the reference slices it off, within 1e-5 (measured
        ≤ 1.6e-6, 0 at k 25)."""
        cfg = WaveGANConfig(slice_len=slice_len, width=4, kernel=kernel, dtype="float32")
        g = WaveGANGenerator(cfg).eval()
        sd = _carrying(g, seed=kernel)
        z = torch.randn(2, cfg.latent_dim, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            got = g(z)
        want = reference.generate(z, sd, dataclasses.asdict(cfg))
        assert got.shape == want.shape == (2, slice_len) and got.dtype == torch.float32
        assert float((got - want).abs().max()) < 1e-5

    def test_bf16_near_reference(self, reference):
        """The configuration's bf16 at the published slice and kernel, width
        4: each row within 2e-2 relative L2 of the float32 reference. bf16
        keeps 8 bits, so each level's rounded input, kernel and output is off
        by ≈ 2^-9 relative, seven products compounding (measured ≤ 6.8e-3);
        the reference in float8 e4m3 reads 0.114–0.118 here."""
        cfg = WaveGANConfig(slice_len=65536, width=4, kernel=25)
        g = WaveGANGenerator(cfg).eval()
        sd = _carrying(g, seed=3)
        z = torch.randn(4, cfg.latent_dim, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            got = g(z)
        want = reference.generate(z, sd, dataclasses.asdict(cfg))
        gap = (got - want).norm(dim=1) / want.norm(dim=1)
        assert got.dtype == torch.float32 and float(gap.max()) < 2e-2
        assert float(gap.min()) > 0  # bf16 did round

    def test_generator_ranges(self):
        """Under a profiler a call is ``advoc.wavegan`` ⊃ ``advoc.project``
        and one ``advoc.up<i>`` a level, each holding its ``advoc.conv``."""
        cfg = WaveGANConfig(slice_len=1024, width=2, dtype="float32")
        g = WaveGANGenerator(cfg).eval()
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            g(torch.zeros(1, cfg.latent_dim))
        got = [(e.name, e.cpu_parent.name if e.cpu_parent else None)
               for e in prof.events() if e.name.startswith(profiling.PREFIX)]
        want = [("advoc.wavegan", None), ("advoc.project", "advoc.wavegan"),
                ("advoc.conv", "advoc.project")]
        for i in range(cfg.n_up):
            want += [(f"advoc.up{i}", "advoc.wavegan"), ("advoc.conv", f"advoc.up{i}")]
        assert got == want


def _recording(state):
    """Record every gradient ``state`` applies."""
    seen, apply = [], state.apply_gradients

    def record(grads):
        seen.append([g.clone() for g in grads])
        apply(grads)

    state.apply_gradients = record
    return seen


def _close_to(got: dict, want: dict, rel: float, what: str):
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=rel * scale + 1e-12,
                                   err_msg=f"{what} {name}")


class TestWaveGANStep:
    def test_one_step_matches_jax(self, wave):
        """JAX's draws injected: d_loss (two critics, each with the penalty's
        double backward) and g_loss (scored by the D both updated) at rtol
        1e-4, with atol 1e-5 for g_loss, a mean logit near 0 that Adam's
        sign rounding of tiny D gradients moves (as in
        tests/test_torch_melspecgan.py); both states advanced as JAX's
        (n_critic D updates, one G)."""
        t = _port_side(wave)
        wav = np.stack([_wav(2, 1024, seed=2 * i) for i in range(2)])
        key = jax.random.PRNGKey(0)
        gs1, ds1, jm = wave.step(wave.gs, wave.ds, jnp.asarray(wav), key)
        gs, ds, tm = t.step(t.gs, t.ds, torch.tensor(wav), draws=_t(_jax_draws(wave, key, 2)))
        assert sorted(tm) == ["d_loss", "g_loss"]
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5 if k == "g_loss" else 0.0, err_msg=k)
        assert gs.step == 1 and ds.step == 2 == int(ds1.step)

    def test_gradients_match_jax(self, wave):
        """The first critic's D gradient (wgan-gp: the penalty through the
        phase shuffle) and the G gradient, each within 1e-4 of the tensor's
        largest against jax.grad of the same loss at the same weights, G's
        scored by a D holding JAX's updated weights. The logit bias's D
        gradient is 0 in both (a critic's constant shift does not move the
        Wasserstein loss)."""
        t = _port_side(wave)
        wav = np.stack([_wav(2, 1024, seed=2 * i) for i in range(2)])
        key = jax.random.PRNGKey(1)
        draws = _jax_draws(wave, key, 2)
        d_seen = _recording(t.ds)
        t.step(t.gs, t.ds, torch.tensor(wav), draws=_t(draws))
        _, ds1, _ = wave.step(wave.gs, wave.ds, jnp.asarray(wav), key)
        losses = jgan.gan_losses("wgan-gp")
        j, real = wave, jnp.asarray(wav[0])
        fake = j.g.apply({"params": j.gs.params}, jnp.asarray(draws["z"][0]))
        rngs = jax.random.split(key, j.cfg.n_critic + 1)
        r0 = jax.random.split(rngs[0], 3)

        def d_loss(dp):
            app = lambda p, x: j.d.apply({"params": p}, x, rng=r0[2])  # noqa: E731
            return (losses.d_loss(app(dp, real), app(dp, fake))
                    + 10.0 * jgan.gradient_penalty(app, dp, real, fake, r0[1]))

        want = flax_to_state_dict(_np(jax.jit(jax.grad(d_loss))(j.ds.params)), t.d)
        names = [n for n, _ in t.d.named_parameters()]
        _close_to(dict(zip(names, d_seen[0])), want, 1e-4, "D grad")
        assert float(d_seen[0][names.index("logit.bias")].abs().max()) == 0.0

        zg, sg = jnp.asarray(draws["z"][-1]), draws["shifts"][-1]
        g_rng = jax.random.split(rngs[-1])[1]

        def g_loss(gp):
            return losses.g_loss(j.d.apply({"params": ds1.params}, j.g.apply({"params": gp}, zg),
                                           rng=g_rng))

        want = flax_to_state_dict(_np(jax.jit(jax.grad(g_loss))(j.gs.params)), t.g)
        d1 = WaveGANDiscriminator(t.cfg)
        d1.load_state_dict(flax_to_state_dict(_np(ds1.params), d1))
        tg = _port_side(wave).g
        loss = tgan.gan_losses("wgan-gp").g_loss(d1(tg(torch.tensor(np.asarray(zg))),
                                                    torch.tensor(sg)))
        got = dict(zip([n for n, _ in tg.named_parameters()],
                       torch.autograd.grad(loss, list(tg.parameters()))))
        _close_to(got, want, 1e-4, "G grad")

    def test_draws_from_the_generator_are_seeded(self):
        """Without ``draws`` the step draws z, ε and the shifts from its
        generator: the same seed, the same metrics; a (B, T) batch raises."""
        cfg = WaveGANConfig(**WAVE)
        wav = torch.tensor(np.stack([_wav(2, 1024, seed=2 * i) for i in range(2)]))
        runs = []
        for _ in range(2):
            g, d = WaveGANGenerator(cfg), WaveGANDiscriminator(cfg)
            gs, ds = tgan.make_states(g, d, seed=0)
            runs.append(tgan.make_wavegan_train_step(g, d, cfg)(
                gs, ds, wav, torch.Generator().manual_seed(4))[2])
        assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        assert all(bool(torch.isfinite(v)) for v in runs[0].values())
        with pytest.raises(ValueError, match="n_critic"):
            tgan.make_wavegan_train_step(g, d, cfg)(gs, ds, wav[0])


class TestCondWaveGANStep:
    @pytest.mark.parametrize("gan_type", ["lsgan", "wgan-gp"])
    def test_one_step_matches_jax(self, cond, gan_type):
        """JAX's draws injected, each package featurizing (two FFT
        libraries): d_loss, g_loss, g_adv and g_mel_l1 at rtol 1e-4, with
        atol 1e-5 for g_adv, a mean logit near 0 scored by the updated D:
        Adam's first update (≈ lr · sign(g)) turns the rounding of a tiny
        gradient into ±lr on one bias (measured under wgan-gp: 6.4e-6 on a
        g_adv of 3.5e-3)."""
        j = cond if gan_type == "wgan-gp" else _jax_side(cond=True)
        t = _port_side(j)
        wav = _wav(2, 16 * 256, seed=5)
        key = jax.random.PRNGKey(2)
        _, _, jm = j.step(j.gs, j.ds, jnp.asarray(wav), key)
        gs, ds, tm = t.step(t.gs, t.ds, torch.tensor(wav), draws=_t(_jax_draws(j, key, 2)))
        assert sorted(tm) == ["d_loss", "g_adv", "g_loss", "g_mel_l1"]
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5 if k == "g_adv" else 0.0, err_msg=k)
        assert gs.step == ds.step == 1

    def test_g_gradient_through_the_featurizer(self, cond):
        """The two terms of the G loss on JAX's mel and D weights, the
        gradient of each in G's parameters. The mel L1 (45 · |mel of G's
        waveform − mel|, through the port's STFT path) against jax.grad of
        JAX's in float64, within 1e-4 of each tensor's largest, or 1.5 × as
        far as JAX's own float32 gradient is where that is further (measured:
        the port ≤ 8.7e-5, JAX 5.9e-4 at the last transposed conv's bias).
        The adversarial term against JAX's float32 gradient, within 1e-5
        (measured ≤ 1.1e-6): under x64 JAX draws other phase-shuffle shifts
        from the same key."""
        j, t = cond, _port_side(cond)
        wav = _wav(2, 16 * 256, seed=6)
        mel = np.asarray(jgan.spectral.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[:, :16]
        key = jax.random.PRNGKey(8)
        shifts = torch.tensor(_shifts(key, j.cfg, t.d.n_shuffled, 2))
        losses = jgan.gan_losses("wgan-gp")

        def g_loss_of(g, d, dparams, m, adv_weight, l1_weight):
            def g_loss(gp):
                fake = g.apply({"params": gp}, m)
                adv = losses.g_loss(d.apply({"params": dparams}, fake, m, rng=key))
                re = jgan.spectral.waveform_to_r9y9_melspec(fake, P)[:, :16]
                return adv_weight * adv + l1_weight * jnp.mean(jnp.abs(re - m))
            return g_loss

        mel_t = torch.tensor(mel)
        names = [n for n, _ in t.g.named_parameters()]
        for adv_weight, l1_weight in ((0.0, 45.0), (1.0, 0.0)):
            g32 = jax.jit(jax.grad(g_loss_of(j.g, j.d, j.ds.params, jnp.asarray(mel), adv_weight,
                                             l1_weight)))(j.gs.params)
            jax32 = flax_to_state_dict(_np(g32), t.g)
            fake = t.g(mel_t)
            re = tgan.spectral.waveform_to_r9y9_melspec(fake)[:, :16]
            loss = (adv_weight * tgan.gan_losses("wgan-gp").g_loss(t.d(fake, mel_t, shifts))
                    + l1_weight * (re - mel_t).abs().mean())
            got = dict(zip(names, torch.autograd.grad(loss, list(t.g.parameters()))))
            if adv_weight:
                _close_to(got, jax32, 1e-5, "adversarial G grad")
                continue
            with jax.enable_x64(True):
                c64 = jcond.CondWaveGANConfig(**{**COND, "gan_type": "wgan-gp",
                                                 "dtype": "float64"})
                f64 = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)  # noqa: E731
                g64 = jax.jit(jax.grad(g_loss_of(
                    jcond.CondWaveGANGenerator(c64), jcond.CondWaveGANDiscriminator(c64),
                    f64(j.ds.params), jnp.asarray(mel, jnp.float64), adv_weight, l1_weight)))(
                    f64(j.gs.params))
                want = flax_to_state_dict(jax.tree.map(lambda x: np.asarray(x, np.float32), g64),
                                          t.g)
            for k, w in want.items():
                scale = float(w.abs().max())
                err = float((got[k] - w).abs().max()) / scale
                jax_err = float((jax32[k] - w).abs().max()) / scale
                assert err <= max(1e-4, 1.5 * jax_err), (k, err, jax_err)
