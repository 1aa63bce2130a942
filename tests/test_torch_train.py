"""The port's advoc training against the JAX package's, on the CPU.

PatchDiscriminator, featurize_advoc, the GAN losses, the gradient penalty,
Adam and the fused D-then-G step, at the JAX tests' size
(``AdvocConfig(n_frames=64, width=8, depth=4, disc_width=8,
dtype="float32")``, batch 2 of ``synthetic_speech``): flax weights from
``gan.make_states(seed=0)`` are converted, so both packages start from the
same parameters.

Featurization is the STFT path in float32 in both, through two FFT
libraries. Where a bin's magnitude is near the dB floor the two differ by
a few 1e-3 of normalized dB, as each does from the float64 oracle, so
features are held to the oracle (the port no further off than JAX) and the
step's arithmetic is held at 1e-5 on JAX's own features (the port's
``featurize_advoc`` replaced by them), besides one end-to-end step.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from advoc_tpu.data import loader as jloader
from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu.ops import reference as jref
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.train import gan as jgan
from advoc_tpu_torch.data.loader import mulaw8_encode
from advoc_tpu_torch.models.advoc import (
    AdvocConfig,
    AdvocGenerator,
    PatchDiscriminator,
    flax_disc_to_torch_state_dict,
    flax_to_torch_state_dict,
)
from advoc_tpu_torch.train import gan as tgan

SIZE = dict(n_frames=64, width=8, depth=4, disc_width=8, dtype="float32")
LR = 2e-4
METRICS = ("d_loss", "g_loss", "g_adv", "g_l1", "d_real_logit", "d_fake_logit")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wav(b=2, seed=0) -> np.ndarray:
    return np.stack([jloader.synthetic_speech(seed + i, 64 * P.hop_length) for i in range(b)])


def _jax_side(lr=LR, disc_only=False, **cfg):
    """JAX's models, ``gan.make_states(seed=0)`` and jitted step (make_states
    jitted: one compile of both inits, not op by op). ``disc_only``: the
    discriminator's init alone, make_states' second key."""
    jc = jmodel.AdvocConfig(**{**SIZE, **cfg})
    g, d = jmodel.AdvocGenerator(jc), jmodel.PatchDiscriminator(jc)
    est0 = jnp.zeros((1, jc.n_frames, jc.n_freq))
    cond0 = jnp.zeros((1, jc.n_frames, 80)) if jc.condition_on == "mel" else est0
    if disc_only:
        d_rng = jax.random.split(jax.random.PRNGKey(0))[1]
        ds = types.SimpleNamespace(params=jax.jit(d.init)(d_rng, cond0, est0)["params"])
        return types.SimpleNamespace(cfg=jc, d=d, ds=ds, lr=lr)
    gs, ds = jax.jit(lambda: jgan.make_states(g, d, (est0,), (cond0, est0), seed=0,
                                              g_tx=jgan.adam(lr), d_tx=jgan.adam(lr)))()
    step = jax.jit(jgan.make_advoc_train_step(g, d, jc, P))
    return types.SimpleNamespace(cfg=jc, g=g, d=d, gs=gs, ds=ds, step=step, lr=lr)


def _port_side(j):
    """The port's models, states and step on ``j``'s converted weights."""
    tc = AdvocConfig(**{f: getattr(j.cfg, f) for f in AdvocConfig.__dataclass_fields__})
    td = PatchDiscriminator(tc)
    td.load_state_dict(flax_disc_to_torch_state_dict(_np(j.ds.params), tc))
    if not hasattr(j, "gs"):
        return types.SimpleNamespace(cfg=tc, d=td)
    tg = AdvocGenerator(tc)
    gs, ds = tgan.make_states(tg, td, seed=0, g_tx=tgan.adam(j.lr), d_tx=tgan.adam(j.lr))
    tg.load_state_dict(flax_to_torch_state_dict(_np(j.gs.params), tc))
    td.load_state_dict(flax_disc_to_torch_state_dict(_np(j.ds.params), tc))
    return types.SimpleNamespace(cfg=tc, g=tg, d=td, gs=gs, ds=ds,
                                 step=tgan.make_advoc_train_step(tg, td, tc))


@pytest.fixture(scope="module")
def lsgan():
    return _jax_side()


@pytest.fixture(scope="module")
def wav():
    return _wav()


def _share_features(monkeypatch, wav):
    """The port's steps featurize into JAX's features of ``wav``."""
    feats = [np.asarray(x) for x in jgan.featurize_advoc(jnp.asarray(wav), 64, P)]
    monkeypatch.setattr(tgan, "featurize_advoc",
                        lambda *a, **k: tuple(torch.tensor(x) for x in feats))
    return feats


def _metrics_close(jm, tm, rtol, atol=0.0):
    assert sorted(tm) == sorted(METRICS) and all(v.ndim == 0 for v in tm.values())
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=atol, err_msg=k)


class TestDiscriminator:
    @pytest.mark.parametrize("condition_on", ["estimate", "mel"])
    @pytest.mark.parametrize("freq_pack", [1, 2])
    def test_logits_match_flax(self, condition_on, freq_pack):
        """float32 convs summed in other orders: logits of size ≈ 3 within
        1e-5 (measured ≤ 4.3e-6)."""
        j = _jax_side(disc_only=True, condition_on=condition_on, freq_pack=freq_pack)
        t = _port_side(j)
        rng = np.random.default_rng(1)
        cond = rng.uniform(0, 1, (2, 64, 80 if condition_on == "mel" else 513)).astype(np.float32)
        mag = rng.uniform(0, 1, (2, 64, 513)).astype(np.float32)
        want = np.asarray(jax.jit(j.d.apply)({"params": j.ds.params}, jnp.asarray(cond),
                                             jnp.asarray(mag)))
        with torch.no_grad():
            got = t.d(torch.tensor(cond), torch.tensor(mag)).numpy()
        assert got.shape == want.shape == (2, 8, 512 // freq_pack // 8, 1)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_bf16_logits_match_flax(self):
        """bf16 convs and norms: the two round in different places (flax adds
        the bias after rounding the product); within 2e-2 (measured 1.1e-2)."""
        j = _jax_side(disc_only=True, dtype="bfloat16")
        t = _port_side(j)
        rng = np.random.default_rng(2)
        cond, mag = (rng.uniform(0, 1, (2, 64, 513)).astype(np.float32) for _ in range(2))
        want = np.asarray(jax.jit(j.d.apply)({"params": j.ds.params}, jnp.asarray(cond),
                                             jnp.asarray(mag)))
        with torch.no_grad():
            got = t.d(torch.tensor(cond), torch.tensor(mag)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_mel_condition_resize_matches_jax_at_both_ends(self):
        """jax.image.resize(method="linear") 80 → 513 against the port's
        F.interpolate: every bin within float32 rounding, and the first and
        last output bins equal to the edge bins (JAX renormalizes the
        weights there, F.interpolate clamps the source index)."""
        x = np.random.default_rng(3).uniform(0, 1, (2, 64, 80)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 64, 513), method="linear"))
        got = F.interpolate(torch.tensor(x), size=513, mode="linear", align_corners=False).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(got[..., 0], x[..., 0])
        np.testing.assert_array_equal(got[..., -1], x[..., -1])
        np.testing.assert_allclose(want[..., [0, -1]], x[..., [0, -1]], atol=1e-6)

    def test_converter_rejects_a_mismatched_tree(self, lsgan):
        tree = _np(lsgan.ds.params)
        del tree["norm1"]
        with pytest.raises(ValueError, match="missing"):
            flax_disc_to_torch_state_dict(tree, AdvocConfig(**SIZE))

    def test_make_states_is_seeded_and_flax_initialized(self):
        cfg = AdvocConfig(**SIZE)
        a = tgan.make_states(AdvocGenerator(cfg), PatchDiscriminator(cfg), seed=3)
        b = tgan.make_states(AdvocGenerator(cfg), PatchDiscriminator(cfg), seed=3)
        for x, y in zip(a, b):
            torch.testing.assert_close(x.model.state_dict(), y.model.state_dict(), rtol=0, atol=0)
        w = a[1].model.convs[2].weight.detach()  # (32, 16, 4, 4): fan_in 256
        assert abs(float(w.std()) * 16.0 - 1.0) < 0.1
        assert float(a[1].model.norms["1"].weight.detach().min()) == 1.0


class TestFeaturize:
    @pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
    def test_matches_jax_within_its_own_float32_error(self, wire):
        """(mel, est, mag) of JAX and of the port against the float64 STFT
        of the same decoded waveform: the port is no further off than 1.5×
        JAX (max) and 1.2× (mean); port against JAX, mean |Δ| ≤ 1e-6 on mel
        and est, ≤ 1e-4 on the magnitude (measured ≤ 4.6e-5)."""
        x = _wav()
        batch = {"float32": x, "int16": np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16),
                 "mulaw8": mulaw8_encode(x)}[wire]
        w = np.asarray(jgan.as_waveform(jnp.asarray(batch)))
        np.testing.assert_allclose(tgan.as_waveform(torch.tensor(batch)).numpy(), w, atol=1e-7)
        jf = [np.asarray(a) for a in jgan.featurize_advoc(jnp.asarray(batch), 64, P)]
        tf = [a.numpy() for a in tgan.featurize_advoc(torch.tensor(batch), 64)]

        def norm_db(a):
            return np.clip((20 * np.log10(np.maximum(a, P.amp_floor)) - P.ref_level_db
                            - P.min_level_db) / -P.min_level_db, 0.0, 1.0)

        mag = np.stack([np.abs(jref.stft(r.astype(np.float64), P))[:64] for r in w])
        oracle = {0: norm_db(mag @ jref.create_mel_filterbank(P).T), 2: norm_db(mag)}
        for i, ref in oracle.items():
            je, te = np.abs(jf[i] - ref), np.abs(tf[i] - ref)
            assert te.max() <= 1.5 * je.max() + 1e-6 and te.mean() <= 1.2 * je.mean(), \
                (i, te.max(), je.max(), te.mean(), je.mean())
        for i, bound in ((0, 1e-6), (1, 1e-6), (2, 1e-4)):
            assert tf[i].shape == jf[i].shape
            assert np.abs(tf[i] - jf[i]).mean() <= bound, (i, np.abs(tf[i] - jf[i]).mean())


class TestLosses:
    @pytest.mark.parametrize("gan_type", ["dcgan", "lsgan", "wgan-gp"])
    def test_gan_losses_match_jax(self, gan_type):
        rng = np.random.default_rng(4)
        real, fake = (rng.normal(0, 2, (2, 8, 32, 1)).astype(np.float32) for _ in range(2))
        jl, tl = jgan.gan_losses(gan_type), tgan.gan_losses(gan_type)
        assert jl.needs_gp == tl.needs_gp == (gan_type == "wgan-gp")
        np.testing.assert_allclose(float(tl.d_loss(torch.tensor(real), torch.tensor(fake))),
                                   float(jl.d_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tl.g_loss(torch.tensor(fake))),
                                   float(jl.g_loss(jnp.asarray(fake))), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError):
            tgan.gan_losses("hinge")

    def test_gradient_penalty_matches_jax(self, lsgan):
        """At JAX's ε (drawn from the same key as JAX draws it): the penalty
        within 1e-5 and its gradient in D's parameters (a double backward)
        within 1e-4 of each tensor's largest."""
        t = _port_side(lsgan)
        rng = np.random.default_rng(5)
        cond, real, fake = (rng.uniform(0, 1, (2, 64, 513)).astype(np.float32) for _ in range(3))
        key = jax.random.PRNGKey(7)
        eps = np.asarray(jax.random.uniform(key, (2, 1, 1), dtype=jnp.float32))

        def jgp(params):
            return jgan.gradient_penalty(
                lambda p, x: lsgan.d.apply({"params": p}, jnp.asarray(cond), x),
                params, jnp.asarray(real), jnp.asarray(fake), key)

        want, jgrad = jax.jit(jax.value_and_grad(jgp))(lsgan.ds.params)
        got = tgan.gradient_penalty(lambda x: t.d(torch.tensor(cond), x), torch.tensor(real),
                                    torch.tensor(fake), eps=torch.tensor(eps))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        # The logit bias does not reach ∇ₓ: its gradient is zero (JAX) or
        # unused (torch).
        tgrad = torch.autograd.grad(got, t.ds.params, allow_unused=True)
        want_g = flax_disc_to_torch_state_dict(_np(jgrad), t.cfg)
        for (name, p), g in zip(t.d.named_parameters(), tgrad):
            g = torch.zeros_like(p) if g is None else g
            np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                       atol=1e-4 * float(want_g[name].abs().max()), err_msg=name)
        with pytest.raises(ValueError, match="eps or a generator"):
            tgan.gradient_penalty(lambda x: x, torch.tensor(real), torch.tensor(fake))

    def test_adam_matches_optax(self):
        """Two updates of torch's Adam and optax's from the same parameters
        and gradients: ε outside the square root and both moments
        bias-corrected (the first update is ≈ lr · sign(g))."""
        rng = np.random.default_rng(6)
        p0 = rng.normal(size=(5, 7)).astype(np.float32)
        grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1e-3, 1.0)]
        tx = jgan.adam(LR)
        jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        tp = torch.nn.Parameter(torch.tensor(p0))
        opt = tgan.adam(LR)([tp])
        for g in grads:
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
            tp.grad = torch.tensor(g)
            opt.step()
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


class TestTrainStep:
    def test_one_step_matches_jax(self, lsgan, wav, monkeypatch):
        _share_features(monkeypatch, wav)
        t = _port_side(lsgan)
        _, _, jm = lsgan.step(lsgan.gs, lsgan.ds, jnp.asarray(wav), jax.random.PRNGKey(0))
        gs, ds, tm = t.step(t.gs, t.ds, torch.tensor(wav))
        _metrics_close(jm, tm, rtol=1e-5)
        assert gs.step == ds.step == 1

    def test_one_step_on_its_own_features(self, lsgan, wav):
        """End to end, each package featurizing: the features' float32
        differences move the metrics by ≤ 2e-5 relative (measured)."""
        t = _port_side(lsgan)
        _, _, jm = lsgan.step(lsgan.gs, lsgan.ds, jnp.asarray(wav), jax.random.PRNGKey(0))
        _, _, tm = t.step(t.gs, t.ds, torch.tensor(wav))
        _metrics_close(jm, tm, rtol=1e-4)

    def test_gradients_and_parameters_match_jax(self, lsgan, wav, monkeypatch):
        """Gradients of the step's two loss functions within 1e-4 of each
        tensor's largest; a gradient that is zero but for rounding (the
        finest transpose-conv's bias, ahead of a one-channel-a-group norm)
        within 1e-6 of the model's largest. D's, as the step takes it at the initial
        D, against jax.grad. G's (scored by JAX's updated D in both) against
        jax.grad of the same loss in float64: JAX's float32 gradient of it
        is up to 2e-2 of a tensor's largest off that (measured in the
        decoder's convolutions), the port's ≤ 1e-6. Then the parameters
        after Adam's first update (≈ lr · sign(g)) within 1e-5 of JAX's where
        |g| is above 1e-3 of the tensor's largest and twice JAX's own
        gradient error (the sign of both updates is the true one), within
        2·lr elsewhere."""
        est, real = (jnp.asarray(x) for x in _share_features(monkeypatch, wav)[1:])
        j, t = lsgan, _port_side(lsgan)
        losses = jgan.gan_losses("lsgan")
        fake = j.g.apply({"params": j.gs.params}, est)

        def d_loss(dp):
            return losses.d_loss(j.d.apply({"params": dp}, est, real),
                                 j.d.apply({"params": dp}, est, fake))

        gs1, ds1, _ = j.step(j.gs, j.ds, jnp.asarray(wav), jax.random.PRNGKey(0))

        def g_loss_of(g, d, est, real, dparams):
            def g_loss(gp):
                f2 = g.apply({"params": gp}, est)
                return (losses.g_loss(d.apply({"params": dparams}, est, f2))
                        + 100.0 * jnp.mean(jnp.abs(f2 - real)))
            return g_loss

        g32 = jax.jit(jax.grad(g_loss_of(j.g, j.d, est, real, ds1.params)))(j.gs.params)
        with jax.enable_x64(True):
            c64 = jmodel.AdvocConfig(**{**SIZE, "dtype": "float64"})
            f64 = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)  # noqa: E731
            g64 = jax.jit(jax.grad(g_loss_of(jmodel.AdvocGenerator(c64),
                                             jmodel.PatchDiscriminator(c64), f64(est), f64(real),
                                             f64(ds1.params))))(f64(j.gs.params))
            g64 = jax.tree.map(lambda x: np.asarray(x, np.float32), g64)

        # The port's G loss on a D holding JAX's updated weights.
        d1 = PatchDiscriminator(t.cfg)
        d1.load_state_dict(flax_disc_to_torch_state_dict(_np(ds1.params), t.cfg))
        est_t, real_t = torch.tensor(np.asarray(est)), torch.tensor(np.asarray(real))
        f2 = t.g(est_t)
        g_loss_t = tgan.gan_losses("lsgan").g_loss(d1(est_t, f2)) + 100.0 * (f2 - real_t).abs().mean()
        grads = {"g": dict(zip([n for n, _ in t.g.named_parameters()],
                               torch.autograd.grad(g_loss_t, t.gs.params)))}
        names = [n for n, _ in t.d.named_parameters()]
        apply_d = t.ds.apply_gradients

        def record(gr):
            grads["d"] = dict(zip(names, (g.clone() for g in gr)))
            apply_d(gr)

        t.ds.apply_gradients = record
        t.step(t.gs, t.ds, torch.tensor(wav))
        jd = flax_disc_to_torch_state_dict(_np(jax.jit(jax.grad(d_loss))(j.ds.params)), t.cfg)
        want = {"d": (jd, jd),
                "g": (flax_to_torch_state_dict(g64, t.cfg), flax_to_torch_state_dict(_np(g32), t.cfg))}
        after = {"d": flax_disc_to_torch_state_dict(_np(ds1.params), t.cfg),
                 "g": flax_to_torch_state_dict(_np(gs1.params), t.cfg)}
        for key, model in (("d", t.d), ("g", t.g)):
            top = max(float(v.abs().max()) for v in want[key][0].values())
            for name, p in model.named_parameters():
                ref, jax32 = want[key][0][name], want[key][1][name]
                scale = float(ref.abs().max())
                if scale <= 1e-9 * top:  # zero but for rounding
                    assert float(grads[key][name].abs().max()) <= 1e-6 * top, (key, name)
                else:
                    np.testing.assert_allclose(grads[key][name].numpy(), ref.numpy(),
                                               atol=1e-4 * scale, err_msg=f"{key} grad {name}")
                big = (ref.abs() > 1e-3 * scale) & (ref.abs() > 2 * (jax32 - ref).abs())
                d = (p.detach() - after[key][name]).abs()
                assert not bool(big.any()) or float(d[big].max()) <= 1e-5, (key, name)
                assert float(d.max()) <= 2 * LR, (key, name)

    def test_three_steps_match_jax(self, lsgan, wav, monkeypatch):
        """Adam's first updates are ≈ lr · sign(g), so where a gradient is
        tiny the two round to different signs and the difference grows:
        rtol 1e-4 with atol 1e-5 for the mean logits near 0 (measured ≤
        8.7e-5 relative at the third step)."""
        _share_features(monkeypatch, wav)
        gs, ds = lsgan.gs, lsgan.ds
        t = _port_side(lsgan)
        for i in range(3):
            gs, ds, jm = lsgan.step(gs, ds, jnp.asarray(wav), jax.random.PRNGKey(i))
            _, _, tm = t.step(t.gs, t.ds, torch.tensor(wav))
            _metrics_close(jm, tm, rtol=1e-4, atol=1e-5)

    def test_wgan_gp_step_matches_jax(self, wav, monkeypatch):
        """At the ε JAX's step draws (its key's first split). The D gradient
        passes a double backward, and Adam's first update turns the rounding
        of its tiny components into ±lr: the metrics scored by the updated D
        (g_adv) move by 6.3e-5 relative (measured), rtol 1e-4."""
        _share_features(monkeypatch, wav)
        j = _jax_side(gan_type="wgan-gp")
        t = _port_side(j)
        key = jax.random.PRNGKey(0)
        eps = torch.tensor(np.asarray(jax.random.uniform(jax.random.split(key)[0], (2, 1, 1))))
        real_gp = tgan.gradient_penalty
        monkeypatch.setattr(tgan, "gradient_penalty",
                            lambda *a, **k: real_gp(*a, **{**k, "eps": eps}))
        _, _, jm = j.step(j.gs, j.ds, jnp.asarray(wav), key)
        _, _, tm = t.step(t.gs, t.ds, torch.tensor(wav), torch.Generator().manual_seed(0))
        _metrics_close(jm, tm, rtol=1e-4)

    @pytest.mark.parametrize("cfg", [dict(gan_type="dcgan"), dict(gan_type="wgan-gp"),
                                     dict(condition_on="mel")], ids=["dcgan", "wgan-gp", "mel"])
    def test_other_losses_and_condition_train(self, cfg, wav):
        """As JAX's smoke tests (its dcgan and wgan-gp paths, condition_on
        "mel"): finite metrics; wgan-gp draws its ε from the generator, the
        same ε for the same seed. Their pieces are held to JAX above (the
        losses, the penalty, the mel-conditioned discriminator)."""
        c = AdvocConfig(**SIZE, **cfg)
        runs = []
        for _ in range(2 if c.gan_type == "wgan-gp" else 1):
            g, d = AdvocGenerator(c), PatchDiscriminator(c)
            gs, ds = tgan.make_states(g, d, seed=0)
            runs.append(tgan.make_advoc_train_step(g, d, c)(gs, ds, torch.tensor(wav),
                                                            torch.Generator().manual_seed(3))[2])
        assert all(bool(torch.isfinite(v)) for v in runs[0].values())
        assert all(torch.equal(runs[0][k], runs[-1][k]) for k in runs[0])

    def test_every_tensor_updates_and_no_gradient_is_left(self, wav):
        cfg = AdvocConfig(**SIZE)
        g, d = AdvocGenerator(cfg), PatchDiscriminator(cfg)
        gs, ds = tgan.make_states(g, d, seed=0)
        before = {k: {n: p.detach().clone() for n, p in s.model.named_parameters()}
                  for k, s in (("g", gs), ("d", ds))}
        gs, ds, m = tgan.make_advoc_train_step(g, d, cfg)(gs, ds, torch.tensor(wav))
        assert all(bool(torch.isfinite(v)) for v in m.values())
        for k, s in (("g", gs), ("d", ds)):
            for n, p in s.model.named_parameters():
                assert not torch.equal(p.detach(), before[k][n]), f"{k} {n} did not update"
                assert p.grad is None
        assert gs.step == ds.step == 1

    def test_l1_decreases_over_steps(self, wav):
        """JAX's test at lr 2e-3 (its 4 rows and 8 steps cut to 2 and 5)."""
        cfg = AdvocConfig(**SIZE)
        g, d = AdvocGenerator(cfg), PatchDiscriminator(cfg)
        gs, ds = tgan.make_states(g, d, seed=0, g_tx=tgan.adam(2e-3), d_tx=tgan.adam(2e-3))
        step = tgan.make_advoc_train_step(g, d, cfg)
        l1s = [float(step(gs, ds, torch.tensor(wav))[2]["g_l1"]) for _ in range(5)]
        assert l1s[-1] < l1s[0], l1s

    def test_eval_step_matches_jax(self, lsgan, wav, monkeypatch):
        _share_features(monkeypatch, wav)
        t = _port_side(lsgan)
        want = jax.jit(jgan.make_advoc_eval_step(lsgan.g, lsgan.cfg, P))(lsgan.gs.params,
                                                                          jnp.asarray(wav))
        got = tgan.make_advoc_eval_step(t.cfg)(t.g, torch.tensor(wav))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


class TestTrainLoop:
    def test_hooks_see_each_step_as_jax(self, lsgan, wav, monkeypatch, tmp_path):
        """``train_loop(hooks=)``: each hook is called as ``h(step, gstate,
        dstate)`` after every step in both packages, on states that agree
        (the float64 sums of |G| and |D| within 1e-6 relative)."""
        from advoc_tpu.train import harness as jharness
        from advoc_tpu_torch.train import harness

        _share_features(monkeypatch, wav)
        t = _port_side(lsgan)
        seen = {"jax": [], "port": []}

        def jax_hook(step, gs, ds):
            seen["jax"].append((step, int(gs.step), int(ds.step), *(
                sum(np.abs(np.asarray(x, np.float64)).sum() for x in jax.tree.leaves(s.params))
                for s in (gs, ds))))

        def port_hook(step, gs, ds):
            seen["port"].append((step, gs.step, ds.step, *(
                sum(float(p.detach().double().abs().sum()) for p in s.params) for s in (gs, ds))))

        kw = dict(max_steps=2, ckpt_every=100, log_every=100, summary_every=100,
                  nan_check_every=0)
        jharness.train_loop(lsgan.step, lsgan.gs, lsgan.ds, (jnp.asarray(wav) for _ in range(3)),
                            str(tmp_path / "jax"), hooks=[jax_hook], **kw)
        harness.train_loop(t.step, t.gs, t.ds, (torch.tensor(wav) for _ in range(3)),
                           str(tmp_path / "port"), hooks=[port_hook], **kw)
        assert [r[:3] for r in seen["port"]] == [r[:3] for r in seen["jax"]] == [(1, 1, 1),
                                                                                (2, 2, 2)]
        np.testing.assert_allclose([r[3:] for r in seen["port"]], [r[3:] for r in seen["jax"]],
                                   rtol=1e-6)


class TestPackedTail:
    def test_gradients_equal_the_default_layouts(self, wav):
        """On the CPU the packed tail is the plain version (JAX's XLA
        branch) and differentiable: its generator's gradients equal the
        default layout's on the same weights (float32, within 1e-5 of each
        tensor's largest, plus 1e-7 for the finest transpose-conv's bias,
        whose gradient ahead of a one-channel-a-group norm is zero but for
        rounding)."""
        cfg = AdvocConfig(**SIZE)
        g = AdvocGenerator(cfg)
        g.reset_parameters(torch.Generator().manual_seed(0))
        gp = AdvocGenerator(AdvocConfig(**SIZE, packed_tail=True))
        gp.load_state_dict(g.state_dict(), strict=True)
        _, est, real = tgan.featurize_advoc(torch.tensor(wav), 64)
        grads = [torch.autograd.grad((m(est) - real).abs().mean(), list(m.parameters()))
                 for m in (g, gp)]
        for (name, _), a, b in zip(g.named_parameters(), *grads):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-5 * float(a.abs().max()) + 1e-7,
                                       msg=name)

    def test_trains_on_the_cpu(self, wav):
        cfg = AdvocConfig(**SIZE, packed_tail=True)
        g, d = AdvocGenerator(cfg), PatchDiscriminator(cfg)
        gs, ds = tgan.make_states(g, d, seed=0)
        _, _, m = tgan.make_advoc_train_step(g, d, cfg)(gs, ds, torch.tensor(wav))
        assert all(bool(torch.isfinite(v)) for v in m.values())
