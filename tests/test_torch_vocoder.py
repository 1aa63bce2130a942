"""The port's offline Vocoder against the JAX Vocoder, both on the CPU.

A tiny float32 generator (as tests/test_infer.py's) is initialized in flax
and converted, so both vocoders run the same weights on the same mel. On the
CPU both take the matmul G-L scan, so waveforms agree closely for a few
iterations; at 30 iterations of momentum 0.99 G-L is chaotic and only the
re-extracted mel L1 is compared. The JAX Vocoder passes its precision
(DEFAULT) to that scan, which JAX computes in fp32 on the CPU, while the
port's scan rounds its operands to bf16 at "default" as the card does: the
comparisons with JAX run the port at ``gl_precision="highest"``.
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
from advoc_tpu.ops.pallas.featurizer import fused_melspec
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.ops.reference import AudioParams
from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
from advoc_tpu_torch.infer.vocoder import chunked_generator_apply
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.layers import GroupNorm
from advoc_tpu_torch.ops import spectral as tsp
from advoc_tpu_torch.utils import profiling

HOP = P.hop_length
# Two G-L iterations from a zero phase: bins where the rebuilt |u| ≈ 0 have an
# ill-conditioned projected phase, so two float32 programs (or one program
# batched differently) differ there by up to ~5e-4 × peak.
RTOL_2_ITERS = 1e-3


@pytest.fixture(scope="module")
def mel():
    wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
    return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)


def _gens(**cfg):
    """(flax apply, flax params, port generator) with the same weights."""
    jcfg = JConfig(n_frames=64, width=8, depth=4, dtype="float32", **cfg)
    g = JGenerator(jcfg)
    params = jax.jit(g.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, jcfg.n_freq)))["params"]
    tcfg = AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32", **cfg)
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    return (lambda p, e: g.apply({"params": p}, e)), params, tg


@pytest.fixture(scope="module")
def gens():
    return _gens()


def _mel_l1(wav, mel):
    t = mel.shape[-2]
    return float(np.abs(
        np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[..., :t, :] - mel).mean())


def _pair(gens, mel, **kw):
    apply, params, tg = gens
    jv = JVocoder(g_apply=apply, g_params=params, params=P, chunk_frames=64, **kw)
    tv = Vocoder(tg, chunk_frames=64, device="cpu", gl_precision="highest", **kw)
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
        tv = Vocoder(chunk_frames=64, gl_iters=2, device="cpu", gl_precision="highest")
        assert tv.mel_projection == 0.0
        want, got = np.asarray(jv(mel)), tv(mel).numpy()
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())

    def test_batched_input(self, gens, mel):
        mels = np.stack([mel[:64], mel[64:128]])
        want, got = _pair(gens, mels, gl_iters=2)
        assert got.shape == want.shape == (2, 64 * HOP)
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())
        single = Vocoder(gens[2], chunk_frames=64, gl_iters=2, device="cpu",
                         gl_precision="highest")(mels[1])
        np.testing.assert_allclose(single.numpy(), got[1], atol=RTOL_2_ITERS * np.abs(got).max())

    def test_copy_synthesis_slice(self):
        """wav → fused featurizer → packed-tail Vocoder → wav: JAX
        fused_melspec (interpret mode) into the JAX Vocoder, against the
        port's impl="kernel" featurizer into its Vocoder, both on the CPU."""
        apply, params, tg = _gens(packed_tail=True)
        wav = loader.synthetic_speech(7, 150 * HOP + 40)
        jmel = np.asarray(fused_melspec(jnp.asarray(wav), P, interpret=True))
        tmel = tsp.waveform_to_r9y9_melspec(torch.tensor(wav), impl="kernel")
        assert tmel.shape == jmel.shape == (150, 80)
        kw = dict(chunk_frames=64, gl_iters=2, phase_impl="xla")
        want = np.asarray(JVocoder(g_apply=apply, g_params=params, params=P, **kw)(jmel))
        got = Vocoder(tg, device="cpu", gl_precision="highest", **kw)(tmel).numpy()
        assert got.shape == want.shape == (150 * HOP,)
        np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())

    @pytest.mark.parametrize("use_gen", [False, True], ids=["heuristic", "generator"])
    def test_lws_exact_matches_jax(self, gens, mel, use_gen):
        """phase_method="lws_exact": true LWS (gl_iters sweeps) after the
        projection, the same weights. Batch LWS agrees to float32 rounding
        (test_torch_lws.py), ≤ 1e-4 × peak through the generator. The raw
        heuristic estimate has quiet stretches whose bins' consistency sums
        nearly cancel, where the phase is ill-conditioned: isolated samples
        reach 1.1e-4 × peak there, so it is held to 2e-4, and to 1e-5 × peak
        on average (measured 8.6e-6)."""
        kw = dict(gl_iters=2, phase_method="lws_exact")
        if use_gen:
            want, got = _pair(gens, mel[:128], **kw)
        else:
            want = np.asarray(JVocoder(params=P, chunk_frames=64, **kw)(mel[:128]))
            got = Vocoder(device="cpu", chunk_frames=64, **kw)(mel[:128]).numpy()
        assert got.shape == want.shape == (128 * HOP,)
        peak = np.abs(want).max()
        assert np.abs(got - want).max() < (1e-4 if use_gen else 2e-4) * peak
        assert np.abs(got - want).mean() < 1e-5 * peak

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

    @pytest.mark.parametrize("gl_precision", [None, "default", "highest"])
    def test_gl_precision_passes_through(self, gens, mel, monkeypatch, gl_precision):
        """None means "default", as in the JAX Vocoder, and both forms get
        it: the kernel form (JAX's split_synth) and, as the JAX Vocoder
        passes its precision to the XLA loop, the matmul scan (bf16
        operands at "default")."""
        from advoc_tpu_torch.ops.kernels import griffin_lim as tgl

        seen, scan = [], []
        real = tgl.griffin_lim_kernel
        monkeypatch.setattr(tgl, "griffin_lim_kernel",
                            lambda *a, **kw: seen.append(kw["precision"]) or real(*a, **kw))
        real_gl = tsp.griffin_lim
        monkeypatch.setattr(tsp, "griffin_lim",
                            lambda *a, **kw: scan.append(kw) or real_gl(*a, **kw))
        kw = dict(chunk_frames=64, gl_iters=2, device="cpu", gl_precision=gl_precision)
        kern = Vocoder(gens[2], phase_impl="kernel", **kw)
        want = gl_precision or "default"
        assert kern.gl_precision == want
        kern(mel[:64])
        assert seen == [want]
        got = Vocoder(gens[2], phase_impl="xla", **kw)(mel[:64])
        assert seen == [want]
        assert scan[-1].get("fft_impl", "matmul") == "matmul" and scan[-1]["precision"] == want
        scan.clear()
        torch.testing.assert_close(Vocoder(gens[2], phase_impl="xla", **kw)(mel[:64]), got,
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="gl_precision"):
            Vocoder(device="cpu", gl_precision="bf16")

    def test_matmul_scan_takes_the_precision(self, gens, mel, monkeypatch):
        """phase_impl="xla" at "default" and at "highest": each output is the
        matmul form at that precision on the Vocoder's magnitude, and the
        two differ (bf16 operands against fp32)."""
        calls = []
        real_gl = tsp.griffin_lim
        monkeypatch.setattr(tsp, "griffin_lim",
                            lambda mag, *a, **kw: calls.append((mag, a, kw)) or real_gl(mag, *a, **kw))
        outs = {}
        for prec in ("default", "highest"):
            outs[prec] = Vocoder(gens[2], chunk_frames=64, gl_iters=2, device="cpu",
                                 phase_impl="xla", gl_precision=prec)(mel[:64])
            mag, a, kw = calls[-1]
            assert kw["precision"] == prec
            want = real_gl(mag, *a, **{**kw, "precision": prec})[0]
            torch.testing.assert_close(outs[prec], want, rtol=0, atol=0)
        assert not torch.equal(outs["default"], outs["highest"])

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
        dict(mesh=object()), dict(phase_method="lws_exact"),
        dict(phase_method="lws_exact", phase_init="pghi"),
    ])
    def test_unported_options_raise(self, mel, kw):
        """A mesh that is not a parallel.mesh.Mesh raises TypeError (the
        mesh'd Vocoder is tests/test_torch_parallel.py's). phase_method=
        "lws_exact", which raised too before, now runs true LWS on the
        projected magnitude and never the G-L kernel, even at
        phase_impl="kernel"; phase_init does not reach it (the JAX Vocoder's
        order)."""
        if "mesh" in kw:
            with pytest.raises(TypeError, match="Mesh"):
                Vocoder(device="cpu", **kw)
            return
        v = Vocoder(device="cpu", chunk_frames=64, gl_iters=2, phase_impl="kernel", **kw)
        assert not v._use_kernel()
        m = torch.tensor(mel[:64])
        est = tsp.normalize_db(tsp.amp_to_db(tsp.r9y9_melspec_to_magspec(m)) - P.ref_level_db)
        mag = tsp.db_to_amp(tsp.denormalize_db(est) + P.ref_level_db)  # the heuristic Vocoder's
        torch.testing.assert_close(v(m), tsp.lws(mag, n_sweeps=2), rtol=0, atol=0)

    def test_unported_entry_points_raise(self, mel):
        """vocode_longform and every StreamingVocoder engine are ported
        (test_torch_streaming.py, test_torch_lws_streaming.py): the lws
        engines, which raised before, take their stream contract, and
        mel_context on the gl engine raises the JAX package's ValueError."""
        sv = StreamingVocoder(phase_engine="lws_online", device="cpu")
        assert (sv.preroll_samples, sv.latency_frames, sv.lws_sweeps) == (P.n_fft // 2, 2, 2)
        assert StreamingVocoder(phase_engine="lws_block", mel_context=4,
                                device="cpu").latency_frames == 2 + 4
        with pytest.raises(ValueError, match="mel_context"):
            StreamingVocoder(mel_context=4, device="cpu")


class TestSpans:
    """The Vocoder's spans (``utils.profiling``) on a small CPU Vocoder:
    ranges under a profiler, at the stage seams and in the U-Net, and
    nothing without one."""

    @staticmethod
    def _voc(**cfg):
        g = AdvocGenerator(AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32", **cfg))
        g.reset_parameters(torch.Generator().manual_seed(0))
        return g, Vocoder(g, chunk_frames=256, overlap_frames=32, gl_iters=2, device="cpu")

    @staticmethod
    def _under(e, name: str) -> bool:
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name == name:
                return True
        return False

    @pytest.mark.parametrize("cfg", [{}, {"packed_tail": True}], ids=["default", "packed_tail"])
    def test_stages_and_unet_layers(self, cfg):
        g, voc = self._voc(**cfg)
        calls = 2
        mel = torch.rand(2, 500, P.n_mels)  # bucketed to 512: three windows
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                voc(mel)
        events = prof.events()
        vocodes = [e for e in events if e.name == "advoc.vocode"]
        assert len(vocodes) == calls and all(v.cpu_parent is None for v in vocodes)
        n_conv = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                     for m in g.modules())
        n_norm = sum(isinstance(m, GroupNorm) for m in g.modules())
        for v in vocodes:
            kids = [c for c in v.cpu_children if c.name.startswith(profiling.PREFIX)]
            assert [c.name for c in kids] == ["advoc.estimate", "advoc.windows",
                                              "advoc.project", "advoc.gl"]
            unet = [c for c in kids[1].cpu_children if c.name.startswith(profiling.PREFIX)]
            assert [c.name for c in unet] == ["advoc.unet"]
        for name, n in (("advoc.conv", n_conv), ("advoc.norm", n_norm)):
            mine = [e for e in events if e.name == name]
            assert len(mine) == n * calls
            assert all(e.cpu_parent.name == "advoc.unet" for e in mine)
        assert all(self._under(e, "advoc.vocode") for e in events
                   if e.name.startswith(profiling.PREFIX) and e.name != "advoc.vocode")
        times = profiling.device_ms(prof.profiler.kineto_results.events())
        assert times == dict.fromkeys(sorted(
            "advoc." + n for n in ("vocode", "estimate", "windows", "unet", "conv", "norm",
                                   "project", "gl")), 0.0)  # no card: no kernel

    def test_nothing_without_a_profiler(self, monkeypatch):
        calls = []
        rf = profiling._range  # the record_function range a span opens
        monkeypatch.setattr(profiling, "_range", lambda *a: calls.append(a) or rf(*a))
        _, voc = self._voc()
        voc(torch.rand(1, 256, P.n_mels))
        assert calls == []
