"""The port's tools against the JAX package's: profiling, roofline, the
``python -m advoc_tpu_torch`` overview, the package's lazy attributes and
the native WAV codec."""

import dataclasses
import struct
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advoc_tpu_torch
from advoc_tpu.data import audioio as jaudio
from advoc_tpu.utils import profiling as jprof
from advoc_tpu.utils import roofline as jroof
from advoc_tpu_torch.data import audioio, native
from advoc_tpu_torch.utils import profiling, roofline


class TestProfiling:
    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(tmp_path / "tr") as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = list((tmp_path / "tr").glob("*.pt.trace.json"))
        assert len(files) == 1 and files[0].stat().st_size > 0
        assert any("mm" in e.key for e in prof.key_averages())

    def test_timed_call(self):
        best, out = profiling.timed_call(lambda x: x * 2, torch.ones(4), trials=2)
        assert best > 0 and torch.equal(out, torch.full((4,), 2.0))

    def test_step_profiler_matches_jax(self, monkeypatch):
        clock = iter([0.0, 0.5, 1.5, 1.75, 0.0, 0.5, 1.5, 1.75])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        summaries = []
        for cls in (profiling.StepProfiler, jprof.StepProfiler):
            p = cls(window=2)
            assert p.steps_per_sec is None and p.summary() == {}
            for _ in range(4):
                p.tick()
            summaries.append(p.summary())
        assert summaries[0] == summaries[1]
        assert summaries[0]["step_time_max_s"] == 1.0


class TestRoofline:
    def test_peaks_on_the_cpu_are_assumed(self):
        p = roofline.device_peaks("cpu")
        assert p.assumed and (p.flops_per_s, p.hbm_bytes_per_s) == (989e12, 3.35e12)
        assert [f.name for f in dataclasses.fields(p)] == [
            f.name for f in dataclasses.fields(jroof.Peaks)]

    def test_h100_sxm_is_recognized(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "NVIDIA H100 80GB HBM3")
        p = roofline.device_peaks("cuda")
        assert not p.assumed and p.flops_per_s == 989e12 and p.hbm_bytes_per_s == 3.35e12
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A10")
        assert roofline.device_peaks("cuda").assumed

    def test_cost_of_a_matmul_matches_xla(self):
        a, b = np.ones((64, 96), np.float32), np.ones((96, 32), np.float32)
        got = roofline.cost_of(torch.matmul, torch.tensor(a), torch.tensor(b))
        want = jroof.cost_of(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
        assert got["flops"] == want["flops"] == 2 * 64 * 96 * 32
        assert got["bytes"] == 4 * (64 * 96 + 96 * 32 + 64 * 32)

    def test_elementwise_work_counts_zero(self):
        """The documented caveat: FlopCounterMode counts products only."""
        assert roofline.cost_of(torch.exp, torch.ones(1000))["flops"] == 0

    @pytest.mark.parametrize("seconds", [2e-3, 0.0])
    def test_row_and_table_match_jax(self, seconds):
        tp = roofline.device_peaks("cpu")
        jp = jroof.Peaks(tp.name, tp.flops_per_s, tp.hbm_bytes_per_s, tp.assumed)
        row = roofline.roofline_row("g", 4e12, 2e9, seconds, tp)
        assert row == jroof.roofline_row("g", 4e12, 2e9, seconds, jp)
        got, want = roofline.format_table([row], tp), jroof.format_table([row], jp)
        assert got.splitlines()[2] == want.splitlines()[2]

    def test_slope_time(self):
        assert roofline.slope_time(lambda x: x @ x, torch.ones(32, 32), trials=1) < 1.0

    def test_gl_hand_count_matches_xla(self):
        """The hand count of fast G-L's work (the bound column of PERF.md's
        kernel table, B1's roofline row) against XLA's count of the JAX
        matmul scan at a tiny shape, 30 iterations: within 5% (measured
        0.8%). The gap is XLA's: its length-0 scan graph, from which
        ``cost_of_scan`` extrapolates, folds away the final synthesis's
        product of the zero imaginary start, and it counts elementwise work
        the hand count leaves out."""
        import jax

        from advoc_tpu.ops import spectral as jsp
        from advoc_tpu.ops.reference import DEFAULT_PARAMS as JP

        b, t, n = 2, 16, 30
        mag = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (b, t, 513)), jnp.float32)
        xla = jroof.cost_of_scan(lambda k: (lambda m: jsp.griffin_lim(
            m, t * 256, n_iters=k, momentum=0.99, params=JP,
            precision=jax.lax.Precision.DEFAULT, fft_impl="matmul")), n, mag)["flops"]
        hand = roofline.gl_flops(b, t, 513, n)
        assert abs(hand / xla - 1) < 0.05, (hand, xla)
        # The split synthesis adds one synthesis product per iteration.
        extra = roofline.gl_flops(b, t, 513, n, split_synth=True) - hand
        assert extra == n * 2 * b * t * 513 * 1024 * 2
        assert roofline.gl_bytes(b, t, 512) == 4 * (b * t * 512 + 16 * 256 * 512
                                                     + (t + 3) * 256 + b * t * 256)

    def test_bound_takes_the_slower_of_operations_and_bytes(self):
        ms, by = roofline.bound(989e9, 0.0)
        assert (ms, by) == (pytest.approx(1.0), "operations")
        ms, by = roofline.bound(0.0, 3.35e9)
        assert (ms, by) == (pytest.approx(1.0), "bytes")
        assert roofline.bound(495e9, 0.0, roofline.TF32_FLOPS_PER_S)[0] == pytest.approx(1.0)


def test_overview(capsys):
    from advoc_tpu_torch.__main__ import main

    main()
    out = capsys.readouterr().out
    assert advoc_tpu_torch.__version__ in out and "vocode_cli" in out and "--aot" in out


def test_lazy_attributes():
    from advoc_tpu_torch.infer import StreamingVocoder, Vocoder

    assert advoc_tpu_torch.Vocoder is Vocoder
    assert advoc_tpu_torch.StreamingVocoder is StreamingVocoder
    with pytest.raises(AttributeError):
        advoc_tpu_torch.NoSuchThing  # noqa: B018


class TestNativeCodec:
    def test_source_is_the_jax_packages(self):
        """The port keeps its own copy of wavio.cc: the same code below its
        header comment."""
        from pathlib import Path

        mine = native._SRC.read_text()
        theirs = (Path(jaudio.__file__).parent / "native" / "wavio.cc").read_text()
        assert mine[mine.index("#include"):] == theirs[theirs.index("#include"):]

    def test_builds_into_the_build_dir(self):
        lib = native.load()
        assert native.library_path().exists() and native.library_path().parent == native.BUILD_DIR
        assert lib.advoc_wav_info.restype is not None

    @pytest.fixture
    def float_wav(self, tmp_path):
        """A 2-channel IEEE float32 WAV, which stdlib wave cannot read."""
        x = np.random.default_rng(0).uniform(-1, 1, (3000, 2)).astype("<f4")
        fmt = struct.pack("<HHIIHH", 3, 2, 16000, 16000 * 8, 8, 32)
        data = x.tobytes()
        riff = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack(
            "<I", len(data)) + data
        path = tmp_path / "f.wav"
        path.write_bytes(b"RIFF" + struct.pack("<I", len(riff)) + riff)
        return path

    def test_decodes_float_wavs_as_jax(self, float_wav):
        with pytest.raises(wave.Error):
            wave.open(str(float_wav))
        np.testing.assert_array_equal(audioio.decode_audio(float_wav),
                                      jaudio.decode_audio(float_wav))
        assert audioio.wav_num_frames(float_wav) == jaudio.wav_num_frames(str(float_wav))
        np.testing.assert_array_equal(audioio.decode_audio_slice(float_wav, 2900, 300),
                                      jaudio.decode_audio_slice(str(float_wav), 2900, 300))

    def test_fallback_reads_and_writes_the_same(self, tmp_path, monkeypatch):
        x = np.random.default_rng(1).uniform(-1.2, 1.2, 5000).astype(np.float32)
        audioio.save_as_wav(x, tmp_path / "n.wav")
        want = audioio.decode_audio(tmp_path / "n.wav")
        monkeypatch.setenv("ADVOC_TPU_NO_NATIVE", "1")
        with pytest.raises(native.NativeUnavailable):
            native.load()
        audioio.save_as_wav(x, tmp_path / "f.wav")
        assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "n.wav").read_bytes()
        np.testing.assert_array_equal(audioio.decode_audio(tmp_path / "f.wav"), want)
        np.testing.assert_array_equal(audioio.decode_audio_slice(tmp_path / "f.wav", 10, 20),
                                      want[10:30])
