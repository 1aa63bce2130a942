"""The port's evaluation metrics (advoc_tpu_torch.train.eval_metrics) and
stress fixtures against the JAX package's, on the same seeded inputs.

The four panel metrics and vocoder_eval are float32 reductions on both
sides (the STFT magnitudes through two FFT libraries): 1e-4 relative (the
snr of a near-identical pair 1e-3, its denominator a small difference).
STOI is the same numpy code on the same samples: equal to 1e-9. The stress
fixtures are bit-equal. The stress panel runs one heuristic vocoder in each
package on each class, two fp32 G-L iterations (the port at "highest": JAX
computes DEFAULT in fp32 on the CPU), whose waveforms differ by up to
~1e-3 × peak where the rebuilt |u| is near zero: each metric within 2e-2
relative (+1e-4), STOI within 3e-2 absolute: a correlation in [-1, 1] that
on the tone class is taken mostly over bands holding rounding-level energy
(measured 2.3e-2 apart there, ≤ 3e-3 on the other classes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader as jloader
from advoc_tpu.infer import Vocoder as JVocoder
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.train import eval_metrics as jem
from advoc_tpu_torch.data import loader as tloader
from advoc_tpu_torch.data import synthetic
from advoc_tpu_torch.infer import Vocoder
from advoc_tpu_torch.ops import spectral as tsp
from advoc_tpu_torch.train import eval_metrics as tem


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite's workers
    share the cores), restored after it: set at import, the count would
    change every module's sums in each worker that collects this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """A reference waveform batch and a degraded copy of it."""
    rng = np.random.default_rng(0)
    ref = np.stack([jloader.synthetic_speech(s, 64 * P.hop_length) for s in (1, 2)])
    gen = (0.9 * ref + 0.02 * rng.standard_normal(ref.shape)).astype(np.float32)
    return ref, gen


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


class TestMetrics:
    def test_each_metric(self, pair):
        ref, gen = pair
        mr, mg = (np.asarray(jem.spectral.waveform_to_magspec(jnp.asarray(w), P))
                  for w in (ref, gen))
        tr, tg = torch.tensor(mr), torch.tensor(mg)
        _close(tem.spectrogram_l1(tg, tr), jem.spectrogram_l1(mg, mr), 1e-5)
        _close(tem.log_spectral_distance(tg, tr), jem.log_spectral_distance(mg, mr), 1e-5)
        _close(tem.snr_db(torch.tensor(ref), torch.tensor(gen)), jem.snr_db(ref, gen), 1e-5)
        _close(tem.mel_l1(torch.tensor(ref), torch.tensor(gen)),
               jem.mel_l1(jnp.asarray(ref), jnp.asarray(gen), P), 1e-4)

    def test_vocoder_eval(self, pair):
        ref, gen = pair
        want = jem.vocoder_eval(jnp.asarray(ref), jnp.asarray(gen), P)
        got = tem.vocoder_eval(torch.tensor(ref), torch.tensor(gen))
        assert set(got) == set(want) == {"spec_l1", "lsd_db", "snr_db", "mel_l1"}
        for k in want:
            assert got[k].ndim == 0
            _close(got[k], want[k], 1e-3 if k == "snr_db" else 1e-4)

    @pytest.mark.parametrize("case", ["identity", "noisy", "silent", "short"])
    def test_stoi(self, pair, case):
        ref, gen = pair[0][0], pair[1][0]
        if case == "identity":
            gen = ref
        elif case == "silent":
            ref = np.zeros_like(ref)
        elif case == "short":
            ref, gen = ref[:300], gen[:300]
        want = jem.stoi(ref, gen, P.sample_rate)
        got = tem.stoi(torch.tensor(ref), gen, P.sample_rate)
        if np.isnan(want):
            assert np.isnan(got) and case in ("silent", "short")
        else:
            _close(got, want, 1e-9)
            assert case != "identity" or abs(got - 1.0) < 1e-6


class TestStress:
    @pytest.mark.parametrize("kind", jloader.STRESS_KINDS)
    def test_fixture_bit_equal(self, kind):
        assert tloader.STRESS_KINDS == synthetic.STRESS_KINDS == jloader.STRESS_KINDS
        for seed in (0, 3):
            np.testing.assert_array_equal(
                tloader.stress_fixture(kind, 3000, seed=seed),
                jloader.stress_fixture(kind, 3000, seed=seed))

    def test_unknown_kind_raises(self):
        with pytest.raises(ValueError, match="unknown stress kind"):
            synthetic.stress_fixture("hum", 100)

    def test_panel_against_jax(self):
        kinds = jloader.STRESS_KINDS
        jv = JVocoder(params=P, chunk_frames=64, gl_iters=2)
        tv = Vocoder(chunk_frames=64, gl_iters=2, device="cpu", gl_precision="highest")
        want = jem.stress_panel(jv, kinds=kinds, n_frames=64)
        got = tem.stress_panel(tv, kinds=kinds, n_frames=64)
        assert set(got) == set(kinds)
        for kind in kinds:
            assert set(got[kind]) == set(want[kind])
            for k, v in want[kind].items():
                if not np.isfinite(v):
                    assert kind == "silence" and not np.isfinite(got[kind][k])
                elif k == "stoi":
                    _close(got[kind][k], v, 0.0, 3e-2)
                else:
                    _close(got[kind][k], v, 2e-2, 1e-4)

    def test_panel_through_the_featurizer_kernel(self):
        """impl="kernel" featurizes through B3's wrapper (its plain version on
        the CPU): the panel stays finite."""
        tv = Vocoder(chunk_frames=64, gl_iters=2, device="cpu")
        got = tem.stress_panel(tv, kinds=("chirp",), n_frames=64, impl="kernel")
        assert all(np.isfinite(v) for v in got["chirp"].values())

    def test_non_finite_metric_raises(self):
        def broken(mel):
            return torch.full((mel.shape[-2] * P.hop_length,), float("nan"))

        with pytest.raises(FloatingPointError, match="tone"):
            tem.stress_panel(broken, kinds=("tone",), n_frames=64, device="cpu")


def test_vocoder_eval_runs_on_the_callers_device(pair):
    ref, gen = (torch.tensor(x, dtype=torch.float64) for x in pair)
    got = tem.vocoder_eval(ref.float(), gen.float())
    assert all(v.device == ref.device for v in got.values())
    assert tsp.waveform_to_magspec(ref.float()).shape[-1] == P.n_freq
