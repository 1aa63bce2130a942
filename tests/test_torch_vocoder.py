"""The port's offline Vocoder against the JAX Vocoder, both on the CPU.

A tiny float32 generator (as tests/test_infer.py's) is initialized in flax
and converted, so both vocoders run the same weights on the same mel. On the
CPU both take the matmul G-L scan, so waveforms agree closely for a few
iterations; at 30 iterations of momentum 0.99 G-L is chaotic and only the
re-extracted mel L1 is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.infer import Vocoder as JVocoder
from advoc_tpu.infer.vocoder import chunked_generator_apply as j_chunked
from advoc_tpu.models.advoc import AdvocConfig as JConfig, AdvocGenerator as JGenerator
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.ops.reference import AudioParams
from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
from advoc_tpu_torch.infer.vocoder import chunked_generator_apply
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict

HOP = P.hop_length
# Two G-L iterations from a zero phase: bins where the rebuilt |u| ≈ 0 have an
# ill-conditioned projected phase, so two float32 programs (or one program
# batched differently) differ there by up to ~5e-4 × peak.
RTOL_2_ITERS = 1e-3


@pytest.fixture(scope="module")
def mel():
    wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
    return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)


@pytest.fixture(scope="module")
def gens():
    """(flax apply, flax params, port generator) with the same weights."""
    cfg = JConfig(n_frames=64, width=8, depth=4, dtype="float32")
    g = JGenerator(cfg)
    params = jax.jit(g.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, cfg.n_freq)))["params"]
    tcfg = AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32")
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    return (lambda p, e: g.apply({"params": p}, e)), params, tg


def _mel_l1(wav, mel):
    t = mel.shape[-2]
    return float(np.abs(
        np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[..., :t, :] - mel).mean())


def _pair(gens, mel, **kw):
    apply, params, tg = gens
    jv = JVocoder(g_apply=apply, g_params=params, params=P, chunk_frames=64, **kw)
    tv = Vocoder(tg, chunk_frames=64, device="cpu", **kw)
    return np.asarray(jv(mel)), tv(mel).numpy()


class TestAgainstJax:
    def test_waveform_matches_at_two_iters(self, gens, mel):
        want, got = _pair(gens, mel, gl_iters=2)
        assert got.shape == want.shape == (mel.shape[0] * HOP,)
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())

    def test_mel_l1_matches_at_thirty_iters(self, gens, mel):
        want, got = _pair(gens, mel, gl_iters=30)
        assert abs(_mel_l1(got, mel) - _mel_l1(want, mel)) < 1e-3

    def test_heuristic_mode(self, mel):
        jv = JVocoder(params=P, chunk_frames=64, gl_iters=2)
        tv = Vocoder(chunk_frames=64, gl_iters=2, device="cpu")
        assert tv.mel_projection == 0.0
        want, got = np.asarray(jv(mel)), tv(mel).numpy()
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())

    def test_batched_input(self, gens, mel):
        mels = np.stack([mel[:64], mel[64:128]])
        want, got = _pair(gens, mels, gl_iters=2)
        assert got.shape == want.shape == (2, 64 * HOP)
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())
        single = Vocoder(gens[2], chunk_frames=64, gl_iters=2, device="cpu")(mels[1])
        np.testing.assert_allclose(single.numpy(), got[1], atol=RTOL_2_ITERS * np.abs(got).max())

    def test_chunked_generator_apply_matches_jax(self):
        """Window starts, crossfade weights and the normalized join."""
        x = np.random.default_rng(0).uniform(0, 1, (2, 200, 5)).astype(np.float32)
        want = np.asarray(j_chunked(lambda p, e: e ** 2 + p, 64, 16, 200)(0.5, jnp.asarray(x)))
        got = chunked_generator_apply(lambda e: e ** 2 + 0.5, 64, 16, 200)(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class TestVocoder:
    def test_bucketing_and_cropping(self, gens, mel):
        tv = Vocoder(gens[2], chunk_frames=64, overlap_frames=8, gl_iters=2, device="cpu")
        assert [tv.bucket(t) for t in (1, 64, 100, 128, 130)] == [64, 64, 128, 128, 192]
        out = tv(torch.tensor(mel[:100]))
        assert out.shape == (100 * HOP,)
        # Cropping keeps the bucketed run's first samples.
        padded = np.pad(mel[:100], ((0, 28), (0, 0)))
        np.testing.assert_array_equal(out.numpy(), tv(padded).numpy()[: 100 * HOP])

    def test_kernel_impl_on_cpu_within_band(self, gens, mel):
        """phase_impl="kernel" on the CPU is the kernel's plain version: the
        uncropped iteration, within test_pallas_gl.py's 10% mel-L1 band."""
        tg = gens[2]
        xla = Vocoder(tg, chunk_frames=64, gl_iters=16, device="cpu", phase_impl="xla")
        kern = Vocoder(tg, chunk_frames=64, gl_iters=16, device="cpu", phase_impl="kernel")
        assert not xla._use_kernel() and kern._use_kernel()
        l1x, l1k = _mel_l1(xla(mel).numpy(), mel), _mel_l1(kern(mel).numpy(), mel)
        assert l1k < 1.1 * l1x + 1e-4, (l1k, l1x)

    @pytest.mark.parametrize("n_fft,hop,on_card", [
        (1024, 256, True), (2048, 512, True), (1000, 250, True), (1024, 200, False),
    ])
    def test_auto_rule_mirrors_jax(self, n_fft, hop, on_card):
        """The kernel on a card whenever n_fft == 4 · hop, at every length;
        the matmul scan on the CPU."""
        v = Vocoder(params=AudioParams(n_fft=n_fft, hop_length=hop, win_length=n_fft),
                    device="cpu")
        assert not v._use_kernel()
        v.device = torch.device("cuda")  # the rule alone, no launch
        assert v._use_kernel() == on_card

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Vocoder()

    @pytest.mark.parametrize("kw", [
        dict(mesh=object()), dict(phase_method="lws_exact"), dict(phase_init="pghi"),
    ])
    def test_unported_options_raise(self, kw):
        with pytest.raises(NotImplementedError):
            Vocoder(device="cpu", **kw)

    def test_unported_entry_points_raise(self, mel):
        with pytest.raises(NotImplementedError):
            Vocoder(device="cpu").vocode_longform(mel)
        with pytest.raises(NotImplementedError):
            StreamingVocoder()
