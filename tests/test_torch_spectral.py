"""The port's spectral core (advoc_tpu_torch.ops) against the JAX package.

The same numpy inputs go through both packages on the CPU. Host constants
must be equal exactly (both build them in float64 numpy the same way);
float32 paths are held to tests/test_spectral.py's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.ops import reference as jref
from advoc_tpu.ops import spectral as jsp
from advoc_tpu_torch.ops import reference as tref
from advoc_tpu_torch.ops import spectral as tsp

P = jref.DEFAULT_PARAMS
TP = tref.DEFAULT_PARAMS


@pytest.fixture(scope="module")
def wav():
    return loader.synthetic_speech(1, 32768)


@pytest.fixture(scope="module")
def mel_mag():
    """(1, 64, 80) mel and its (1, 64, 513) heuristic magnitude."""
    x = loader.synthetic_speech(0, 64 * P.hop_length)
    mel = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(x), P))[:64][None]
    return mel, np.asarray(jsp.r9y9_melspec_to_magspec(jnp.asarray(mel), P))


class TestConstants:
    def test_audio_params_equal(self):
        assert dataclasses.asdict(TP) == dataclasses.asdict(P)
        assert TP.n_freq == P.n_freq

    @pytest.mark.parametrize("name", ["window", "window_sq", "mel_fb_t", "mel_pinv_t"])
    def test_consts_exact(self, name):
        np.testing.assert_array_equal(tsp._consts(TP)[name], jsp._consts(P)[name])

    def test_mel_colsum_exact(self):
        np.testing.assert_array_equal(
            tsp._consts(TP)["mel_colsum"], jsp._consts(P)["mel_fb_t"].sum(axis=1)
        )

    @pytest.mark.parametrize("name", ["fwd_re", "fwd_im", "inv_re", "inv_im"])
    def test_dft_maps_exact(self, name):
        np.testing.assert_array_equal(tsp._dft_consts(TP)[name], jsp._dft_consts(P)[name])

    @pytest.mark.parametrize("n_frames,length", [(64, 64 * 256), (129, 32768), (1, 100)])
    def test_nola_norm_exact(self, n_frames, length):
        np.testing.assert_array_equal(
            tsp._nola_norm(TP, n_frames, length), jsp._nola_norm(P, n_frames, length)
        )

    def test_reference_helpers_exact(self):
        np.testing.assert_array_equal(tref.create_mel_filterbank(TP), jref.create_mel_filterbank(P))
        np.testing.assert_array_equal(tref.hann_window(1024), jref.hann_window(1024))
        hz = np.linspace(10.0, 11000.0, 257)
        np.testing.assert_array_equal(tref.hz_to_mel_slaney(hz), jref.hz_to_mel_slaney(hz))


class TestSTFT:
    def test_stft_matches_jax(self, wav):
        want = np.asarray(jsp.stft(jnp.asarray(wav), P))
        got = tsp.stft(torch.tensor(wav), TP).numpy()
        assert got.shape == want.shape == (1 + len(wav) // P.hop_length, P.n_freq)
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())

    def test_stft_matches_oracle_batched(self, wav):
        gold = jref.stft(wav.astype(np.float64), P)
        got = tsp.stft(torch.tensor(np.stack([wav, wav])).reshape(2, 1, -1), TP).numpy()
        assert got.shape == (2, 1) + gold.shape
        np.testing.assert_allclose(got[1, 0], gold, atol=2e-4 * np.abs(gold).max())

    def test_istft_roundtrip_and_matches_jax(self, wav):
        spec = np.asarray(jsp.stft(jnp.asarray(wav), P))
        want = np.asarray(jsp.istft(jnp.asarray(spec), len(wav), P))
        got = tsp.istft(torch.tensor(spec), len(wav), TP).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_allclose(got, wav, atol=1e-4)


class TestMel:
    def test_melspec_matches_jax(self, wav):
        want = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))
        got = tsp.waveform_to_r9y9_melspec(torch.tensor(wav), TP).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_pallas_featurizer_not_ported(self, wav):
        with pytest.raises(NotImplementedError, match="B3"):
            tsp.waveform_to_r9y9_melspec(torch.tensor(wav), TP, impl="pallas")

    def test_db_helpers_match_jax(self):
        x = np.random.default_rng(0).uniform(-1e-6, 3.0, (7, 80)).astype(np.float32)
        for jf, tf in ((jsp.amp_to_db, tsp.amp_to_db), (jsp.normalize_db, tsp.normalize_db),
                       (jsp.denormalize_db, tsp.denormalize_db)):
            np.testing.assert_allclose(tf(torch.tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tsp.db_to_amp(torch.tensor(x)).numpy(),
                                   np.asarray(jsp.db_to_amp(jnp.asarray(x))), rtol=1e-6)

    def test_heuristic_inversion_matches_jax(self, wav):
        mel = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))
        want = np.asarray(jsp.r9y9_melspec_to_magspec(jnp.asarray(mel), P))
        got = tsp.r9y9_melspec_to_magspec(torch.tensor(mel), TP).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4 * want.max())

    @pytest.mark.parametrize("strength,n_iters", [(1.0, 1), (0.5, 2)])
    def test_mel_consistency_project_matches_jax(self, wav, strength, n_iters):
        mel = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))
        mag = np.asarray(jsp.r9y9_melspec_to_magspec(jnp.asarray(mel), P))
        rng = np.random.default_rng(1)
        pert = np.maximum(mag * (1.0 + 0.35 * rng.standard_normal(mag.shape)), 0.0)
        pert = pert.astype(np.float32)
        want = np.asarray(jsp.mel_consistency_project(
            jnp.asarray(pert), jnp.asarray(mel), P, strength=strength, n_iters=n_iters))
        got = tsp.mel_consistency_project(
            torch.tensor(pert), torch.tensor(mel), TP, strength=strength, n_iters=n_iters
        ).numpy()
        # tests/test_spectral.py's batched-vs-single tolerance: f32 rounding
        # of the weighted-average gain matmuls.
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


class TestGriffinLimMatmul:
    """The XLA scan's twin: reflect-pad and crop each iteration, no momentum
    on iteration 0. A zero-phase start leaves bins where the rebuilt |u| ≈ 0,
    where the projected phase is ill-conditioned: one float32 iteration
    differs from float64 there by up to 2e-4 × peak, so two float32
    implementations are held to 5e-4 × peak. A random-phase start has no
    such bins and is held to 1e-5 × peak."""

    @pytest.mark.parametrize("n_iters", [1, 2, 4])
    @pytest.mark.parametrize("with_init", [False, True])
    def test_matches_jax_highest(self, mel_mag, n_iters, with_init):
        _, mag = mel_mag
        phi = np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        jinit = (jnp.cos(phi), jnp.sin(phi)) if with_init else None
        tinit = (torch.cos(torch.tensor(phi)), torch.sin(torch.tensor(phi))) if with_init else None
        want = np.asarray(jsp.griffin_lim(
            jnp.asarray(mag), n_iters=n_iters, momentum=0.99, params=P,
            precision=jax.lax.Precision.HIGHEST, init_phase=jinit))
        got = tsp.griffin_lim(torch.tensor(mag), n_iters=n_iters, momentum=0.99,
                              params=TP, init_phase=tinit).numpy()
        assert got.shape == want.shape == (1, 64 * P.hop_length)
        rtol = 1e-5 if with_init else 5e-4
        np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())

    def test_zero_iters_is_istft_of_zero_phase(self, mel_mag):
        _, mag = mel_mag
        want = np.asarray(jsp.griffin_lim(jnp.asarray(mag), n_iters=0, params=P))
        got = tsp.griffin_lim(torch.tensor(mag), n_iters=0, params=TP).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())

    def test_guards(self, mel_mag):
        _, mag = mel_mag
        with pytest.raises(ValueError, match="drop_nyquist"):
            tsp.griffin_lim(torch.tensor(mag), n_iters=1, drop_nyquist=True)
        with pytest.raises(ValueError, match="fft_impl"):
            tsp.griffin_lim(torch.tensor(mag), n_iters=1, fft_impl="fft")
        with pytest.raises(ValueError, match="kernel"):
            tsp.griffin_lim(torch.tensor(mag[0]), n_iters=1, fft_impl="kernel")

    def test_kernel_form_dispatch_drops_nyquist(self, mel_mag):
        """fft_impl="kernel" on a CPU tensor runs the kernel's plain version
        on 512 bins when asked to drop Nyquist."""
        from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_plain

        _, mag = mel_mag
        m = torch.tensor(mag)
        got = tsp.griffin_lim(m, n_iters=2, momentum=0.99, fft_impl="kernel", drop_nyquist=True)
        want = griffin_lim_plain(m[..., :512].contiguous(), 2, 0.99)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
