"""The fast-G-L kernel module (advoc_tpu_torch.ops.kernels.griffin_lim).

Its plain version is held to the two Pallas kernels it replaces, run as
tests/test_pallas_gl.py runs them on the CPU (interpret mode, float32 maps at
HIGHEST). A zero-phase start leaves bins where the rebuilt |u| ≈ 0, where the
projected phase is ill-conditioned: one float32 iteration differs from
float64 there by up to 2e-4 × peak, so one iteration is held to 5e-4 × peak,
and several iterations at momentum 0.99, which carry that difference
forward, to 1e-3 × peak. The CUDA kernel itself is tested on the card, in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.pallas.griffin_lim import griffin_lim_pallas, griffin_lim_pallas_tiled
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.ops.reference import AudioParams as JAudioParams
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl
from advoc_tpu_torch.ops.reference import AudioParams

HIGHEST = jax.lax.Precision.HIGHEST


def _mag(b, t, seed):
    wav = loader.synthetic_speech(seed, b * t * P.hop_length)
    mel = jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P)[: b * t].reshape(b, t, P.n_mels)
    return np.asarray(mel), np.asarray(jsp.r9y9_melspec_to_magspec(mel, P))


@pytest.fixture(scope="module")
def short():
    return _mag(2, 64, 0)


@pytest.fixture(scope="module")
def long():
    return _mag(1, 512, 8)


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("n_bins", [512, 513])
    @pytest.mark.parametrize("n_iters,rtol", [(1, 5e-4), (4, 1e-3)])
    def test_single_tile_kernel(self, short, n_bins, n_iters, rtol):
        _, mag = short
        m = np.ascontiguousarray(mag[..., :n_bins])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(m), n_iters=n_iters, momentum=0.99, params=P, interpret=True,
            loop_dtype="float32", precision=HIGHEST))
        got = tgl.griffin_lim_plain(torch.tensor(m), n_iters, 0.99).numpy()
        assert got.shape == want.shape == (2, 64 * P.hop_length)
        _assert_close(got, want, rtol)

    @pytest.mark.parametrize("with_init", [False, True])
    def test_tiled_kernel(self, long, with_init):
        """B2 with halos (tile 256, halo 16, 3 iterations a round) equals the
        whole-utterance iteration, with and without an init phase."""
        _, mag = long
        phi = np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        want = np.asarray(griffin_lim_pallas_tiled(
            jnp.asarray(mag), n_iters=6, momentum=0.99, params=P, interpret=True,
            loop_dtype="float32", precision=HIGHEST, tile=256, halo=16, iters_per_round=3,
            init_phase=(jnp.cos(phi), jnp.sin(phi)) if with_init else None))
        tphi = torch.tensor(phi)
        got = tgl.griffin_lim_plain(
            torch.tensor(mag), 6, 0.99,
            init_phase=(torch.cos(tphi), torch.sin(tphi)) if with_init else None,
        ).numpy()
        assert got.shape == want.shape == (1, 512 * P.hop_length)
        _assert_close(got, want, 1e-3)

    @pytest.mark.parametrize("hop,n_bins", [(128, 256), (128, 257), (50, 101)])
    def test_other_audio_params(self, hop, n_bins):
        """Any n_fft = 4 · hop, as the Pallas kernel takes: hop 128, and hop 50
        (not a multiple of 4, the CUDA kernel's masked scalar path)."""
        kw = dict(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        jq, q = JAudioParams(**kw), AudioParams(**kw)
        wav = loader.synthetic_speech(hop, 2 * 32 * hop).reshape(2, -1)
        mag = np.ascontiguousarray(
            np.asarray(jsp.waveform_to_magspec(jnp.asarray(wav), jq))[:, :32, :n_bins])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(mag), n_iters=2, momentum=0.99, params=jq, interpret=True,
            loop_dtype="float32", precision=HIGHEST))
        got = tgl.griffin_lim_kernel(torch.tensor(mag), 2, 0.99, params=q).numpy()
        assert got.shape == want.shape == (2, 32 * hop)
        _assert_close(got, want, 1e-3)

    def test_quality_matches_xla_scan(self):
        """The uncropped iteration differs from the XLA scan at the edges;
        at test_pallas_gl.py's 256-frame chunks its re-extracted mel L1 stays
        within that file's 10% band."""
        mel, mag = _mag(2, 256, 0)
        y = tgl.griffin_lim_plain(torch.tensor(mag), 8, 0.99).numpy()
        yx = np.asarray(jsp.griffin_lim(jnp.asarray(mag), n_iters=8, momentum=0.99, params=P))
        l1 = lambda w: float(np.abs(  # noqa: E731
            np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(w), P))[:, :256] - mel).mean())
        assert l1(y) < 1.1 * l1(yx) + 1e-4, (l1(y), l1(yx))


class TestWrapper:
    def test_cpu_tensor_runs_plain_and_counts_nothing(self, short):
        _, mag = short
        m = torch.tensor(mag[..., :512]).contiguous()
        before = tgl.griffin_lim_kernel.launches
        got = tgl.griffin_lim_kernel(m, 3, 0.99)
        assert tgl.griffin_lim_kernel.launches == before
        torch.testing.assert_close(got, tgl.griffin_lim_plain(m, 3, 0.99), rtol=0, atol=0)

    def test_rejects_bad_shapes(self, short):
        _, mag = short
        with pytest.raises(ValueError, match="B, T, F"):
            tgl.griffin_lim_kernel(torch.tensor(mag[0]), 1, 0.99)
        with pytest.raises(ValueError, match="F must be"):
            tgl.griffin_lim_kernel(torch.tensor(mag[..., :500]), 1, 0.99)

    def test_norm_is_the_uncropped_nola(self):
        """_gl_norm equals the Pallas kernel's _gl_norm without its row padding."""
        from advoc_tpu.ops.pallas.griffin_lim import _gl_norm

        want, _ = _gl_norm(P, 64)
        np.testing.assert_array_equal(tgl._gl_norm(P, 64), want[: 64 + 3])


class TestBuild:
    def test_library_path_is_keyed_by_sources(self):
        path = _build.library_path("griffin_lim")
        assert path.parent == _build.BUILD_DIR and path.name.startswith("libgriffin_lim_")
        assert path == _build.library_path("griffin_lim")

    def test_nvcc_command_targets_sm90a(self):
        cmd = _build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd

    def test_missing_nvcc_raises(self, monkeypatch):
        import shutil

        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()
