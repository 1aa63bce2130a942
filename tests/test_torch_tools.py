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


class TestSpans:
    """The program's spans (``profiling.span``) and the card's time in them
    (``profiling.device_ms``)."""

    @staticmethod
    def _ranges(prof) -> list:
        """(name, parent's name) of every ``advoc.`` range the profiler
        recorded, in the order they opened."""
        return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
                for e in prof.events() if e.name.startswith(profiling.PREFIX)]

    @staticmethod
    def _counting(monkeypatch) -> list:
        calls = []
        rf = profiling._range  # the record_function range a span opens
        monkeypatch.setattr(profiling, "_range", lambda *a: calls.append(a) or rf(*a))
        return calls

    def test_off_without_a_profiler(self, monkeypatch):
        calls = self._counting(monkeypatch)
        with profiling.span("vocode"):
            with profiling.span("conv"):
                torch.ones(4) + 1
        assert calls == []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("conv"):
                pass
        assert calls == [("advoc.conv",)] and self._ranges(prof) == [("advoc.conv", None)]

    def test_off_while_traced(self, monkeypatch):
        """Traced (``torch.export``), a span is off even under a profiler,
        and the trace is not asked whether one records."""
        calls = self._counting(monkeypatch)
        monkeypatch.setattr(profiling._build, "traced", lambda: True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: 1 / 0)
            with profiling.span("conv"):
                pass
            monkeypatch.undo()
        assert calls == [] and self._ranges(prof) == []

    def test_names_and_parents(self):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with profiling.span("vocode"):
                    with profiling.span("windows"):
                        with profiling.span("unet"):
                            torch.ones(8) + 1
            with profiling.span("conv"):
                pass
        want = [("advoc.vocode", None), ("advoc.windows", "advoc.vocode"),
                ("advoc.unet", "advoc.windows")]
        assert self._ranges(prof) == want * 2 + [("advoc.conv", None)]

    def test_other_threads_are_off(self, monkeypatch):
        """``torch.profiler`` records the thread that started it: a span on
        another thread is off, and the ranges nest on their own thread."""
        import threading

        calls = self._counting(monkeypatch)

        def work():
            with profiling.span("gl"):
                torch.ones(4) + 1

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("vocode"):
                t = threading.Thread(target=work)
                t.start()
                t.join()
                with profiling.span("gl"):
                    pass
        assert calls == [("advoc.vocode",), ("advoc.gl",)]
        assert self._ranges(prof) == [("advoc.vocode", None), ("advoc.gl", "advoc.vocode")]


class _Event:
    """A profiler event as :func:`profiling.device_ms` reads it (ns)."""

    def __init__(self, name, start, dur=0, cuda=False, corr=0, linked=0, annotation=False):
        self._v = (name, start, dur, cuda, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _call(t0: int, ms: dict, corr: int) -> list:
    """One Vocoder call's events from ``t0`` µs: the ranges vocode ⊃
    {estimate, windows ⊃ unet ⊃ {conv, norm}, gl} on the host, a launch in
    each range's own time (ids from ``corr``), its kernel taking ``ms[name]``
    ms on the card, in reverse order (the card runs later than the host)."""
    us = 1000
    ranges = {"vocode": (0, 100), "estimate": (2, 8), "windows": (10, 60), "unet": (12, 55),
              "conv": (14, 20), "norm": (25, 40), "gl": (70, 90)}
    launch_at = {"vocode": 95, "estimate": 2, "windows": 58, "unet": 50, "conv": 15,
                 "norm": 39, "gl": 80}
    out = [_Event("advoc." + n, (t0 + s) * us, (e - s) * us) for n, (s, e) in ranges.items()]
    for i, (n, t) in enumerate(launch_at.items()):
        out.append(_Event("cudaLaunchKernel", (t0 + t) * us, 2 * us, corr=corr + i))
        kernel = _Event("k", (t0 + 1000 - t) * us, int(ms[n] * 1e6), cuda=True, corr=corr + i)
        out.append(kernel)
    out.append(_Event("advoc.conv", (t0 + 14) * us, 6 * us, cuda=True, annotation=True))
    return out


class TestDeviceMs:
    """``profiling.device_ms`` on made-up profiler events."""

    MS = [{"vocode": 1.0, "estimate": 0.5, "windows": 0.25, "unet": 2.0, "conv": 3.0,
           "norm": 6.0, "gl": 4.0},
          {"vocode": 3.0, "estimate": 1.5, "windows": 0.75, "unet": 4.0, "conv": 5.0,
           "norm": 2.0, "gl": 8.0}]

    def test_each_range_holds_the_kernels_launched_in_it(self):
        events = _call(0, self.MS[0], 1) + _call(5000, self.MS[1], 101)
        got = profiling.device_ms(events)
        mean = {n: (a + b) / 2 for (n, a), b in zip(self.MS[0].items(), self.MS[1].values())}
        want = {"advoc.conv": mean["conv"], "advoc.norm": mean["norm"],
                "advoc.unet": mean["unet"] + mean["conv"] + mean["norm"],
                "advoc.estimate": mean["estimate"], "advoc.gl": mean["gl"]}
        want["advoc.windows"] = want["advoc.unet"] + mean["windows"]
        want["advoc.vocode"] = (want["advoc.windows"] + mean["vocode"] + mean["estimate"]
                                + mean["gl"])
        assert got.keys() == want.keys()
        for n in want:
            assert got[n] == pytest.approx(want[n]), n

    @pytest.mark.parametrize("case", ["outside", "linked", "no_call", "unlinked"])
    def test_what_counts(self, case):
        """Kernels launched outside every call do not count; a kernel found
        by its linked id does; without a call there is nothing; a kernel
        with no launch in the trace counts nowhere."""
        ms = self.MS[0]
        events = _call(0, ms, 1)
        base = profiling.device_ms(events)
        if case == "outside":  # a warm-up's convolution before the window
            events += [_Event("advoc.conv", 200_000, 10_000),
                       _Event("cudaLaunchKernel", 205_000, corr=50),
                       _Event("k", 300_000, 7_000_000, cuda=True, corr=50)]
            assert profiling.device_ms(events) == base
        elif case == "linked":
            events += [_Event("cudaMemcpyAsync", 16_000, corr=60),
                       _Event("Memcpy", 400_000, 1_000_000, cuda=True, corr=0, linked=60)]
            got = profiling.device_ms(events)
            assert got["advoc.conv"] == pytest.approx(base["advoc.conv"] + 1.0)
            assert got["advoc.norm"] == base["advoc.norm"]
        elif case == "no_call":
            assert profiling.device_ms([e for e in events if e.name() != "advoc.vocode"]) == {}
            assert profiling.device_ms([]) == {}
        else:
            events.append(_Event("k", 500_000, 9_000_000, cuda=True, corr=999))
            assert profiling.device_ms(events) == base


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
