"""The port's offline CLI, bundles, audio I/O and config plumbing, against
the JAX package's, on the CPU.

A tiny float32 generator is initialized in flax, exported as a JAX (orbax)
bundle and converted by scripts/bundle_to_torch.py, so both CLIs vocode
the same inputs with the same weights. At 2 G-L iterations their WAVs
agree within RTOL_2_ITERS × peak plus one 16-bit step (each side rounds its
own samples to PCM16). JAX computes the G-L loop's DEFAULT precision in
fp32 on the CPU, where the port's matmul scan rounds operands to bf16 at
"default" as the card does, so the port's CLI is compared at
``gl_precision="highest"``.
"""

import functools
import importlib.util
import json
import pathlib
import wave
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import audioio as jaudio
from advoc_tpu.data import loader
from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.utils import apply_overrides as j_apply_overrides
from advoc_tpu_torch.data import audioio
from advoc_tpu_torch.infer import Vocoder
from advoc_tpu_torch.infer import vocode_cli
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import small_config
from advoc_tpu_torch.train.checkpoint import (
    export_inference_bundle,
    generator_config,
    load_inference_bundle,
)
from advoc_tpu_torch.utils import apply_overrides

HOP = P.hop_length
ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = "width=8,depth=4,n_frames=64,dtype=float32"
# Two G-L iterations (test_torch_streaming.py's bound between the packages)
# and the PCM16 step each side rounds to.
RTOL_2_ITERS = 2e-3
PCM_STEP = 1.0 / 32767.0


def _script():
    spec = importlib.util.spec_from_file_location("bundle_to_torch",
                                                  ROOT / "scripts" / "bundle_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(JAX bundle dir, port bundle dir converted by the script, flax params)."""
    from advoc_tpu.train.checkpoint import export_inference_bundle as jax_export

    root = tmp_path_factory.mktemp("bundles")
    cfg = j_apply_overrides(jmodel.AdvocConfig(), TINY)
    params = jax.jit(jmodel.AdvocGenerator(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, cfg.n_freq)))["params"]
    jax_export(root / "jax", params, {"model_size": "full", "overrides": TINY})
    out = _script().main(["--bundle", str(root / "jax"), "--out", str(root / "torch")])
    return root / "jax", out, params


def _read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, P.sample_rate)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


def _both_clis(tmp_path, bundles, inputs, *extra):
    """Run the JAX and the port vocode_cli on ``inputs``; {name: (jax, port)}."""
    from advoc_tpu.infer import vocode_cli as jax_cli

    jb, tb, _ = bundles
    common = ["--input", str(inputs), "--model_overrides", TINY, "--gl_iters", "2", *extra]
    jax_cli.main(common + ["--out_dir", str(tmp_path / "jax"), "--bundle", str(jb)])
    with mock.patch("advoc_tpu_torch.infer.Vocoder",
                    functools.partial(Vocoder, gl_precision="highest")):
        vocode_cli.main(common + ["--out_dir", str(tmp_path / "port"), "--bundle", str(tb),
                                  "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.wav"))
    return {n: (_read_wav(tmp_path / "jax" / n), _read_wav(tmp_path / "port" / n))
            for n in names}


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max() + PCM_STEP)


class TestBundles:
    def test_conversion_script_against_the_flax_generator(self, bundles):
        """The converted bundle holds the converter's state dict, keeps the
        JAX config.json, and its generator computes the flax one's output."""
        jb, tb, params = bundles
        state, conf = load_inference_bundle(tb)
        assert conf == json.loads((jb / "config.json").read_text())
        cfg = apply_overrides(AdvocConfig(), TINY)
        want_state = flax_to_torch_state_dict(jax.tree.map(np.asarray, params), cfg)
        assert state.keys() == want_state.keys()
        for k in state:
            torch.testing.assert_close(state[k], want_state[k], rtol=0, atol=0)
        g = AdvocGenerator(cfg)
        g.load_state_dict(state, strict=True)
        x = np.random.default_rng(0).uniform(0, 1, (2, 64, 513)).astype(np.float32)
        want = np.asarray(jmodel.AdvocGenerator(j_apply_overrides(jmodel.AdvocConfig(), TINY))
                          .apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            np.testing.assert_allclose(g(torch.tensor(x)).numpy(), want, atol=2e-5)

    def test_round_trip(self, tmp_path):
        g = AdvocGenerator(AdvocConfig(n_frames=32, width=8, depth=3))
        g.reset_parameters(torch.Generator().manual_seed(1))
        export_inference_bundle(tmp_path / "b", g.state_dict(), {"model_size": "full", "w": 8})
        state, conf = load_inference_bundle(tmp_path / "b", device="cpu")
        assert conf == {"model_size": "full", "w": 8}
        assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["config.json", "g_state.pt"]
        for k, v in g.state_dict().items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=0)

    def test_generator_config_falls_back_to_the_bundle_config(self):
        conf = {"model_size": "small", "overrides": "width=8"}
        assert generator_config(conf) == apply_overrides(small_config(), "width=8")
        assert generator_config(conf, "full", "depth=3") == apply_overrides(AdvocConfig(),
                                                                            "depth=3")
        assert generator_config({}, default_size="small") == small_config()
        assert generator_config({}) == AdvocConfig()

    def test_cli_reads_the_config_from_the_bundle(self, tmp_path, bundles):
        """Without --model_overrides the CLI builds the bundle's own config."""
        _, tb, _ = bundles
        mel = np.random.default_rng(0).uniform(0, 1, (70, 80)).astype(np.float32)
        np.save(tmp_path / "m.npy", mel)
        common = ["--input", str(tmp_path / "m.npy"), "--bundle", str(tb), "--gl_iters", "2",
                  "--device", "cpu", "--batch", "1"]
        vocode_cli.main(common + ["--out_dir", str(tmp_path / "a")])
        vocode_cli.main(common + ["--out_dir", str(tmp_path / "b"), "--model_overrides", TINY])
        assert (tmp_path / "a" / "m_0.wav").read_bytes() == (tmp_path / "b" / "m_0.wav").read_bytes()


class TestVocodeCli:
    @pytest.fixture(scope="class")
    def mels(self):
        wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
        return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)

    def test_npy_batch_matches_jax(self, tmp_path, bundles, mels):
        """Two mels of 100 frames in one --batch 8 group (one bucket)."""
        np.save(tmp_path / "m.npy", np.stack([mels[:100], mels[60:160]]))
        out = _both_clis(tmp_path, bundles, tmp_path / "m.npy")
        assert list(out) == ["m_0.wav", "m_1.wav"]
        for want, got in out.values():
            assert got.shape == want.shape == (100 * HOP,)
            _close(got, want)

    def test_wav_directory_matches_jax(self, tmp_path, bundles):
        """Wavs of mixed lengths (two buckets), featurized on the device by
        the STFT path: 1 + L//hop frames each, grouped two at a time."""
        (tmp_path / "in").mkdir()
        lengths = {"a": 100 * HOP + 37, "b": 40 * HOP, "c": 70 * HOP + 200}
        for i, (name, n) in enumerate(lengths.items()):
            audioio.save_as_wav(loader.synthetic_speech(i, n), tmp_path / "in" / f"{name}.wav")
        out = _both_clis(tmp_path, bundles, tmp_path / "in", "--batch", "2")
        for name, n in lengths.items():
            want, got = out[f"{name}.wav"]
            assert got.shape == want.shape == ((1 + n // HOP) * HOP,)
            _close(got, want)

    def test_longform_equals_vocode_longform(self, tmp_path, bundles, mels):
        _, tb, _ = bundles
        np.save(tmp_path / "m.npy", mels)
        summary = vocode_cli.main(["--input", str(tmp_path / "m.npy"), "--out_dir",
                                   str(tmp_path / "o"), "--bundle", str(tb), "--model_overrides",
                                   TINY, "--gl_iters", "2", "--device", "cpu", "--longform",
                                   "--longform_tile", "128"])
        assert summary["files"] == 1
        g = AdvocGenerator(apply_overrides(AdvocConfig(), TINY))
        g.load_state_dict(load_inference_bundle(tb)[0])
        want = Vocoder(g, chunk_frames=64, gl_iters=2, device="cpu").vocode_longform(
            mels, tile_frames=128)
        np.testing.assert_array_equal(
            _read_wav(tmp_path / "o" / "m_0.wav") * 32767.0,
            np.round(np.clip(want, -1, 1) * 32767.0))

    def test_heuristic_per_file(self, tmp_path, mels):
        np.save(tmp_path / "m.npy", mels[:70])
        vocode_cli.main(["--input", str(tmp_path / "m.npy"), "--out_dir", str(tmp_path / "o"),
                         "--gl_iters", "2", "--device", "cpu", "--batch", "1"])
        want = Vocoder(chunk_frames=256, gl_iters=2, device="cpu")(mels[:70]).numpy()
        got = _read_wav(tmp_path / "o" / "m_0.wav")
        np.testing.assert_array_equal(got * 32767.0, np.round(np.clip(want, -1, 1) * 32767.0))

    @pytest.mark.parametrize("extra", [["--aot", "x"], ["--aot_export", "x"],
                                       ["--aot_allow_custom_calls"], ["--train_dir", "x"]])
    def test_unported_options_raise(self, tmp_path, extra):
        """Options that once raised as unported now run: --train_dir loads a
        training run's latest checkpoint (tests/test_torch_train_cli.py), so a
        directory without one raises FileNotFoundError; the AOT options
        (tests/test_torch_export.py) raise NotImplementedError no more and
        fail, as any run does, on what is missing: --aot on a directory
        without a manifest, the others on the missing input."""
        if "--train_dir" in extra:
            with pytest.raises(FileNotFoundError, match="no checkpoint"):
                vocode_cli.main(["--input", "x.npy", "--out_dir", str(tmp_path), "--device", "cpu",
                                 "--train_dir", str(tmp_path / "run")])
            return
        with pytest.raises(FileNotFoundError, match="manifest.json" if "--aot" in extra
                           else "x.npy"):
            vocode_cli.main(["--input", str(tmp_path / "x.npy"), "--out_dir", str(tmp_path),
                             "--device", "cpu", *extra])

    def test_default_device_needs_cuda(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vocode_cli.main(["--input", "x.npy", "--out_dir", str(tmp_path)])


class TestAudioIO:
    @pytest.fixture
    def samples(self):
        """Speech, out-of-range values, and exact ties of the ·32767 scale."""
        x = loader.synthetic_speech(3, 5000) * 1.6
        ties = (np.arange(-40, 40) + 0.5) / np.float32(32767.0)
        return np.concatenate([x, ties.astype(np.float32), [1.0, -1.0, 0.0]]).astype(np.float32)

    @pytest.mark.parametrize("writer", ["native", "fallback"])
    def test_save_as_wav_bytes_equal_jax(self, tmp_path, samples, writer, monkeypatch):
        """The JAX package writes with its native C++ writer where it
        builds, else with its numpy fallback: the port's bytes equal both."""
        from advoc_tpu.data import native

        if writer == "fallback":
            def unavailable():
                raise native.NativeUnavailable("test")
            monkeypatch.setattr(native, "load", unavailable)
        else:
            native.load()
        jaudio.save_as_wav(samples, tmp_path / "jax.wav", 22050)
        audioio.save_as_wav(samples, tmp_path / "port.wav", 22050)
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()

    @pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2)])
    def test_decode_audio_matches_jax(self, tmp_path, width, channels):
        rng = np.random.default_rng(width)
        raw = rng.integers(0, 256, size=width * channels * 3000, dtype=np.uint8).tobytes()
        path = tmp_path / "x.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(raw)
        for kw in (dict(), dict(target_sample_rate=22050)):
            want = jaudio.decode_audio(path, **kw)
            got = audioio.decode_audio(path, **kw)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_resample_matches_jax(self):
        x = loader.synthetic_speech(4, 8000)
        np.testing.assert_array_equal(audioio.resample(x, 16000, 22050),
                                      jaudio.resample(x, 16000, 22050))
        assert audioio.resample(x, 22050, 22050) is x


class TestApplyOverrides:
    def test_matches_jax(self):
        s = "width=24, fast_head=true,dtype=float32,n_frames=64"
        got = apply_overrides(AdvocConfig(), s)
        want = j_apply_overrides(jmodel.AdvocConfig(), s)
        import dataclasses

        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert apply_overrides(AdvocConfig(), None) == AdvocConfig()

    @pytest.mark.parametrize("bad", ["widht=3", "width"])
    def test_rejects_typos(self, bad):
        with pytest.raises(ValueError):
            apply_overrides(AdvocConfig(), bad)
