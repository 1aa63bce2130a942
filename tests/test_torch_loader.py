"""The port's loader, audio reads and device corpus against the JAX
package's, on the CPU.

The same seed must give the same batches bit for bit: the port keeps the
JAX loader's numpy RNG call sequence, and its stdlib ``wave`` reads give
the same k/32768 samples as the JAX package's native parser.
"""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import audioio as jaudio
from advoc_tpu.data import loader as jloader
from advoc_tpu.train import gan as jgan
from advoc_tpu.utils import config as jconfig
from advoc_tpu_torch.data import audioio, loader
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
from advoc_tpu_torch.train import gan
from advoc_tpu_torch.utils import ensure_dataset, find_wavs


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Four files of different lengths, as tests/test_data.py's fixture."""
    d = tmp_path_factory.mktemp("wavs")
    for i in range(4):
        audioio.save_as_wav(loader.synthetic_speech(seed=i, n_samples=22050 + i * 1000),
                            d / f"{i}.wav", 22050)
    return d


@pytest.fixture(scope="module")
def fps(wav_dir):
    return sorted(str(p) for p in wav_dir.iterdir())


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


class TestAudio:
    def test_wav_num_frames_and_slices_match_jax(self, fps):
        for fp in fps:
            assert audioio.wav_num_frames(fp) == jaudio.wav_num_frames(fp)
        for start, count in ((1000, 2000), (21000, 4000), (30000, 100)):  # past EOF: zeros
            np.testing.assert_array_equal(audioio.decode_audio_slice(fps[0], start, count),
                                          jaudio.decode_audio_slice(fps[0], start, count))

    def test_slice_of_a_stereo_file(self, tmp_path):
        x = (np.arange(2 * 3000, dtype="<i2") % 2000 - 1000).astype("<i2")
        p = tmp_path / "st.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes(x.tobytes())
        np.testing.assert_array_equal(audioio.decode_audio_slice(p, 500, 1000),
                                      jaudio.decode_audio_slice(str(p), 500, 1000))

    def test_synthetic_speech_and_fixtures_match_jax(self, tmp_path):
        np.testing.assert_array_equal(loader.synthetic_speech(3, 5000),
                                      jloader.synthetic_speech(3, 5000))
        fps = ensure_dataset(None, str(tmp_path / "fx"), n_files=2, seconds=0.5)
        assert fps == find_wavs(str(tmp_path / "fx"))
        for i, fp in enumerate(fps):
            np.testing.assert_array_equal(
                audioio.decode_audio(fp), jaudio.decode_audio(fp))
            np.testing.assert_array_equal(
                audioio.decode_audio(fp),
                np.round(np.clip(jloader.synthetic_speech(i, 11025), -1, 1) * 32767) / 32768)
        (tmp_path / "list.txt").write_text("\n".join(fps) + "\n")
        assert find_wavs(str(tmp_path / "list.txt")) == fps
        assert find_wavs(None) == [] and find_wavs(str(tmp_path / "none")) == []


class TestJaxKeywords:
    """Keywords of the JAX calls, passed to both packages."""

    def test_decode_audio_normalize_as_jax(self, fps, tmp_path):
        silent = tmp_path / "silent.wav"
        audioio.save_as_wav(np.zeros(500, np.float32), silent, 22050)
        for fp in [*fps, str(silent)]:
            got = audioio.decode_audio(fp, normalize=True)
            np.testing.assert_array_equal(got, jaudio.decode_audio(fp, normalize=True))
            assert float(np.abs(got).max()) == pytest.approx(0.0 if fp == str(silent) else 0.95)

    def test_find_wavs_min_count_as_jax(self, wav_dir, fps):
        for n in (1, len(fps), 100):
            assert find_wavs(str(wav_dir), min_count=n) == jconfig.find_wavs(str(wav_dir),
                                                                             min_count=n) == fps

    @pytest.mark.parametrize("repeat", [True, False])
    def test_decode_extract_and_batch_shuffle_as_jax(self, fps, repeat):
        for shuffle in (True, False):
            kw = dict(batch_size=2, slice_len=3000, repeat=repeat, shuffle=shuffle, seed=5)
            want = _take(jloader.decode_extract_and_batch(fps, **kw), 3)
            got = _take(loader.decode_extract_and_batch(fps, **kw), 3)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


class TestWireLoader:
    @pytest.mark.parametrize("out_dtype", ["float32", "int16", "mulaw8"])
    def test_train_batches_bit_equal_to_jax(self, fps, out_dtype):
        kw = dict(batch_size=3, slice_len=4096, seed=11, out_dtype=out_dtype, sample_rate=22050)
        want = _take(jloader.decode_extract_and_batch(fps, **kw), 4)
        got = _take(loader.decode_extract_and_batch(fps, **kw), 4)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape == (3, 4096)
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("out_dtype", ["float32", "int16", "mulaw8"])
    def test_eval_pass_bit_equal_to_jax(self, fps, out_dtype):
        kw = dict(batch_size=3, slice_len=8000, repeat=False, drop_remainder=False,
                  out_dtype=out_dtype, normalize=True)
        want = list(jloader.decode_extract_and_batch(fps, shuffle=False, **kw))
        got = list(loader.decode_extract_and_batch(fps, **kw))
        assert [a.shape for a in got] == [b.shape for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_mulaw8_and_as_waveform_match_jax(self):
        x = np.linspace(-1.2, 1.2, 4001).astype(np.float32)
        np.testing.assert_array_equal(loader.mulaw8_encode(x), jloader.mulaw8_encode(x))
        assert loader._MULAW_LN256 == jloader._MULAW_LN256 == gan._MULAW_LN256
        codes = np.arange(-128, 128, dtype=np.int8)
        np.testing.assert_allclose(gan.as_waveform(torch.tensor(codes)).numpy(),
                                   np.asarray(jgan.as_waveform(jnp.asarray(codes))), atol=6e-8)

    def test_errors(self, fps, tmp_path):
        with pytest.raises(ValueError, match="empty"):
            loader.decode_extract_and_batch([], 2, 100)
        with pytest.raises(ValueError, match="out_dtype"):
            loader.decode_extract_and_batch(fps, 2, 100, out_dtype="int8")
        audioio.save_as_wav(np.zeros(3000, np.float32), tmp_path / "r.wav", 16000)
        with pytest.raises(ValueError, match="16000 Hz"):
            loader.decode_extract_and_batch([str(tmp_path / "r.wav")], 2, 100, sample_rate=22050)
        with pytest.raises(ValueError, match="16000 Hz"):
            loader.DeviceCorpus([str(tmp_path / "r.wav")], 100, sample_rate=22050, device="cpu")

    def test_producer_decode_error_reraises_in_consumer(self, fps, monkeypatch):
        def broken(*a):
            raise OSError("disk gone")

        monkeypatch.setattr(audioio, "decode_audio_slice", broken)
        it = loader.decode_extract_and_batch(fps, batch_size=2, slice_len=100, num_workers=1)
        with pytest.raises(OSError, match="disk gone"):
            next(it)

    def test_device_prefetch_keeps_order(self, fps):
        batches = _take(loader.decode_extract_and_batch(fps, 2, 1000, seed=3, out_dtype="int16"), 5)
        got = list(loader.device_prefetch(iter(batches), "cpu", depth=2))
        assert len(got) == 5
        for a, b in zip(got, batches):
            assert torch.is_tensor(a) and a.dtype == torch.int16
            np.testing.assert_array_equal(a.numpy(), b)


class TestDeviceCorpus:
    def test_starts_and_gather_bit_equal_to_jax_and_the_int16_wire(self, fps):
        kw = dict(batch_size=4, slice_len=4096, seed=11, out_dtype="int16")
        wire = loader.decode_extract_and_batch(fps, **kw)
        corpus = loader.DeviceCorpus(fps, 4096, sample_rate=22050, device="cpu")
        jcorpus = jloader.DeviceCorpus(fps, 4096, sample_rate=22050)
        assert corpus.nbytes == jcorpus.nbytes
        starts, jstarts = corpus.starts(4, seed=11), jcorpus.starts(4, seed=11)
        for _ in range(3):
            s, js = next(starts), next(jstarts)
            np.testing.assert_array_equal(s, js)
            b = corpus.gather(s)
            assert b.dtype == torch.int16 and b.shape == (4, 4096)
            np.testing.assert_array_equal(b.numpy(), np.asarray(jcorpus.gather(js)))
            np.testing.assert_array_equal(b.numpy(), next(wire))
        wire.close()

    def test_short_file_zero_padded_and_starts_clamped(self, tmp_path):
        audioio.save_as_wav(loader.synthetic_speech(3, 1000), tmp_path / "short.wav", 22050)
        corpus = loader.DeviceCorpus([str(tmp_path / "short.wav")], 4096, device="cpu")
        b = corpus.gather(next(corpus.starts(2, seed=0)))
        assert b.shape == (2, 4096) and bool((b[:, 1000:] == 0).all())
        # Beyond the buffer: clamped as lax.dynamic_slice clamps.
        torch.testing.assert_close(corpus.gather(np.array([10**6])), corpus.gather(np.array([0])))

    def test_hbm_step_equals_the_wire_step(self, fps):
        """hbm_data_step on starts gives the step on the gathered batch:
        the same metrics, bit for bit, from the same weights."""
        cfg = AdvocConfig(n_frames=16, width=8, depth=3, disc_width=8, disc_layers=3,
                          dtype="float32")
        corpus = loader.DeviceCorpus(fps, 16 * 256, device="cpu")
        starts = next(corpus.starts(2, seed=5))
        ms = []
        for wrap in (False, True):
            g, d = AdvocGenerator(cfg), PatchDiscriminator(cfg)
            gs, ds = gan.make_states(g, d, seed=0)
            step = gan.make_advoc_train_step(g, d, cfg)
            if wrap:
                ms.append(loader.hbm_data_step(step, corpus)(gs, ds, starts)[2])
            else:
                ms.append(step(gs, ds, corpus.gather(starts))[2])
        for k in ms[0]:
            assert torch.equal(ms[0][k], ms[1][k]), k
