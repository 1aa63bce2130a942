"""The port's StreamingVocoder (gl engine), vocode_longform and the spectral
pieces they add, against the JAX package's, both on the CPU.

Same numpy mels into both; the generator is a tiny ``fast_head`` config
(small_config at width 8, depth 4, 16-frame chunks, float32) initialized in
flax and converted. G-L at momentum 0.99 is chaotic, and the engine's phase
carry feeds each push's last phase into the next push's start, so a tiny
perturbation of the input grows push by push
(``TestContracts.test_phase_carry_is_chaotic``). So waveforms are compared for one push
from an identical carry (the first push, or a push after the JAX carry is
copied into the port), at 2 iterations, within RTOL_2_ITERS × peak; whole
streams are compared by re-extracted mel L1 at 16 iterations. Contracts the
port keeps on its own (masked rows, reset, flush, int16) are checked bit
for bit, as the JAX package's tests check them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.infer import StreamingVocoder as JStreaming, Vocoder as JVocoder
from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
from advoc_tpu_torch.models.advoc import AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import small_config
from advoc_tpu_torch.ops import spectral as tsp

HOP = P.hop_length
CH, OV = 16, 8
# One push of two G-L iterations from the same start: the projection divides
# by the rebuilt |u|, ill-conditioned where it is tiny, so two float32
# programs differ there at isolated samples: measured up to 1.3e-3 × peak
# (three streams, first push), and JAX's own first push batched and alone
# differs by as much.
RTOL_2_ITERS = 2e-3
# Whole streams at 16 iterations: mel L1 of the port within 10% of JAX's
# (the spread of the chaos above is ~2%; the port's own mel L1 moves by as
# much under a 1e-6 input perturbation).
MEL_L1_RTOL = 0.1


@pytest.fixture(scope="module")
def mel():
    wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
    return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)


def _chunks(mel, n, offset=0):
    return mel[offset : offset + n * CH].reshape(n, CH, P.n_mels)


@pytest.fixture(scope="module")
def gen():
    """(flax apply, flax params, port generator): the tiny fast_head config."""
    kw = dict(width=8, depth=4, n_frames=CH, dtype="float32")
    g = jmodel.AdvocGenerator(jmodel.small_config(**kw))
    params = jax.jit(g.init)(jax.random.PRNGKey(0), jnp.zeros((1, CH, 513)))["params"]
    tcfg = small_config(**kw)
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    return (lambda p, e: g.apply({"params": p}, e)), params, tg


def _pair(gen, use_gen, **kw):
    """(JAX StreamingVocoder, port StreamingVocoder) with the same weights."""
    apply, params, tg = gen
    kw = dict(chunk_frames=CH, overlap_frames=OV, **kw)
    js = (JStreaming(g_apply=apply, g_params=params, params=P, **kw) if use_gen
          else JStreaming(params=P, **kw))
    return js, StreamingVocoder(tg if use_gen else None, device="cpu", **kw)


def _copy_carry(js, ts):
    """The JAX engine's carry into the port's."""
    ts._state_magtail = torch.tensor(np.asarray(js._state_magtail))
    ts._state_wav = torch.tensor(np.asarray(js._state_wav))
    ts._state_phase = tuple(torch.tensor(np.asarray(x)) for x in js._state_phase)


def _close(got, want, rtol=RTOL_2_ITERS):
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


def _mel_l1(wav, mel):
    m = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))
    n = min(m.shape[0], mel.shape[0]) - 1
    return float(np.abs(m[:n] - mel[:n]).mean())


@pytest.mark.parametrize("use_gen", [False, True], ids=["heuristic", "fast_head"])
class TestAgainstJax:
    def test_first_push(self, gen, mel, use_gen):
        js, ts = _pair(gen, use_gen, gl_iters=2)
        assert ts.preroll_samples == js.preroll_samples == OV * HOP
        assert ts.flush_samples == js.flush_samples and ts.latency_frames == 0
        c = _chunks(mel, 1)[0]
        want, got = js.push(c), ts.push(c)
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (CH * HOP,)
        _close(got, want)

    def test_push_from_the_same_carry(self, gen, mel, use_gen):
        """Two JAX pushes, the carry copied into the port, a third push in
        both: the emit, the waveform tail and the carried magnitudes."""
        js, ts = _pair(gen, use_gen, gl_iters=2)
        c = _chunks(mel, 3, offset=40)
        js.push(c[0])
        js.push(c[1])
        _copy_carry(js, ts)
        _close(ts.push(c[2]), js.push(c[2]))
        _close(ts._state_wav.numpy(), np.asarray(js._state_wav))
        # The magnitudes come from the pinv product (80 terms that partly
        # cancel, summed in another order) through the dB round trip: 1e-4
        # relative.
        np.testing.assert_allclose(ts._state_magtail.numpy(), np.asarray(js._state_magtail),
                                   rtol=1e-4, atol=1e-6)

    def test_three_streams(self, gen, mel, use_gen):
        """n_streams=3: the first batched push per row, then one push from
        the JAX carry, then a masked flush."""
        js, ts = _pair(gen, use_gen, gl_iters=2, n_streams=3)
        b = np.stack([_chunks(mel, 2, offset=o) for o in (0, 50, 100)], axis=1)  # (2, 3, CH, M)
        want, got = js.push(b[0]), ts.push(b[0])
        assert got.shape == want.shape == (3, CH * HOP)
        _close(got, want)
        _copy_carry(js, ts)
        _close(ts.push(b[1]), js.push(b[1]))
        active = [True, False, True]
        want, got = js.flush(active=active), ts.flush(active=active)
        assert got.shape == (3, OV * HOP)
        np.testing.assert_array_equal(got[1], 0.0)
        _close(got, want)

    def test_stream_and_flush_mel_l1_at_16_iters(self, gen, mel, use_gen):
        """8 chunks and a flush: exactly T·hop samples after dropping
        flush_samples, re-extracting to the input as closely as JAX's."""
        js, ts = _pair(gen, use_gen, gl_iters=16)
        c = _chunks(mel, 8)
        out = {}
        for name, sv in (("jax", js), ("port", ts)):
            sig = np.concatenate([sv.push(x) for x in c] + [sv.flush()])[sv.flush_samples :]
            assert sig.shape == (8 * CH * HOP,)
            out[name] = _mel_l1(sig, c.reshape(-1, P.n_mels))
        assert abs(out["port"] - out["jax"]) < MEL_L1_RTOL * out["jax"], out

    def test_int16_emit(self, gen, mel, use_gen):
        """On-device PCM16: the float emit through save_as_wav's rounding,
        bit for bit; within a few LSB of JAX's int16 emit."""
        c = _chunks(mel, 2)
        js, q = _pair(gen, use_gen, gl_iters=2, emit_dtype="int16")
        f = _pair(gen, use_gen, gl_iters=2)[1]
        for x in c:
            got, ref = q.push(x), f.push(x)
            assert got.dtype == np.int16
            np.testing.assert_array_equal(
                got, np.round(np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16))
        want = js.push(c[0])
        assert want.dtype == np.int16
        np.testing.assert_allclose(_pair(gen, use_gen, gl_iters=2, emit_dtype="int16")[1]
                                   .push(c[0]).astype(np.float32), want.astype(np.float32),
                                   atol=RTOL_2_ITERS * 32767 * np.abs(ref).max() + 1)
        tail_q, tail_f = q.flush(), f.flush()
        assert tail_q.dtype == np.int16
        np.testing.assert_array_equal(
            tail_q, np.round(np.clip(tail_f, -1.0, 1.0) * 32767.0).astype(np.int16))

    def test_float16_uplink(self, gen, mel, use_gen):
        """The mel is cast to float16 on the host: the same emit as a float32
        push of the rounded mel, and JAX's fp16 push within the bound."""
        c = _chunks(mel, 1)[0]
        js, h = _pair(gen, use_gen, gl_iters=2, mel_dtype="float16")
        f = _pair(gen, use_gen, gl_iters=2)[1]
        got = h.push(c)
        np.testing.assert_array_equal(got, f.push(c.astype(np.float16).astype(np.float32)))
        _close(got, js.push(c))


class TestContracts:
    """The serving contracts, in the port alone, as the JAX package's
    tests/test_infer.py checks them in JAX."""

    def _sv(self, **kw):
        kw = dict(chunk_frames=CH, overlap_frames=OV, gl_iters=4, device="cpu") | kw
        return StreamingVocoder(**kw)

    def test_phase_carry_is_chaotic(self, mel):
        """Why whole streams are compared by mel L1: a 1e-6 relative
        perturbation of the mel stays near float32 rounding in the first
        push and grows past 1% of the peak within four."""
        c = _chunks(mel, 4)
        noisy = (c * (1 + 1e-6 * np.random.default_rng(1).standard_normal(c.shape))).astype(
            np.float32)
        a, b = self._sv(gl_iters=2), self._sv(gl_iters=2)
        rel = []
        for x, y in zip(c, noisy):
            ex, ey = a.push(x), b.push(y)
            rel.append(np.abs(ex - ey).max() / np.abs(ex).max())
        assert rel[0] < RTOL_2_ITERS and rel[-1] > 1e-2, rel

    def test_skipped_tick_resumes_bit_exact(self, mel):
        a, b = _chunks(mel, 3, offset=0), _chunks(mel, 2, offset=60)
        zeros = np.zeros_like(a[0])
        sv = self._sv(n_streams=2)
        o1 = sv.push(np.stack([a[0], b[0]]))
        o2 = sv.push(np.stack([a[1], zeros]), active=[True, False])
        o3 = sv.push(np.stack([a[2], b[1]]))
        np.testing.assert_array_equal(o2[1], 0.0)
        ref0 = self._sv(n_streams=2)
        r = [ref0.push(np.stack([a[0], b[0]])), ref0.push(np.stack([a[1], b[1]])),
             ref0.push(np.stack([a[2], b[1]]))]
        for o, ro in zip((o1, o2, o3), r):
            np.testing.assert_array_equal(o[0], ro[0])
        ref1 = self._sv(n_streams=2)
        s1, s2 = ref1.push(np.stack([a[0], b[0]])), ref1.push(np.stack([a[1], b[1]]))
        np.testing.assert_array_equal(o1[1], s1[1])
        np.testing.assert_array_equal(o3[1], s2[1])

    def test_one_hot_pushes_equal_batched_rows(self, mel):
        """The server's correctness: a slot's stream through one-hot masked
        pushes equals its row of all-active pushes, bit for bit."""
        chunks = np.stack([_chunks(mel, 3, offset=o) for o in (0, 40, 80)], axis=1)
        batched = self._sv(n_streams=3)
        rows = [batched.push(c) for c in chunks]
        for slot in range(3):
            sv = self._sv(n_streams=3)
            onehot = np.arange(3) == slot
            for k, c in enumerate(chunks):
                x = np.zeros_like(c)
                x[slot] = c[slot]
                np.testing.assert_array_equal(sv.push(x, active=onehot)[slot], rows[k][slot])

    def test_reset_one_stream(self, mel):
        c = np.stack([_chunks(mel, 2, offset=o) for o in (0, 50)], axis=1)
        sv = self._sv(n_streams=2)
        first = sv.push(c[0])
        sv.push(c[1])
        sv.reset(1)
        assert float(sv._state_wav[1].abs().max()) == 0.0
        assert float(sv._state_magtail[1].abs().max()) == 0.0
        assert [float(x[1, 0]) for x in sv._state_phase] == [1.0, 0.0, 1.0, 0.0]
        again = sv.push(c[0])
        np.testing.assert_array_equal(again[1], first[1])  # fresh slot
        ref = self._sv(n_streams=2)
        ref.push(c[0])
        ref.push(c[1])
        np.testing.assert_array_equal(again[0], ref.push(c[0])[0])  # untouched slot
        sv.reset()
        assert sv._state_wav is None and sv._state_phase is None

    def test_reset_after_inference_mode_push(self, mel):
        """A carry made under torch.inference_mode is reset out of place."""
        sv = self._sv(n_streams=2)
        with torch.inference_mode():
            sv.push(np.stack([_chunks(mel, 1)[0]] * 2))
        sv.reset(0)
        assert float(sv._state_wav[0].abs().max()) == 0.0
        assert float(sv._state_wav[1].abs().max()) > 0.0

    def test_flush_contract(self, mel):
        c = _chunks(mel, 2)
        sv = self._sv()
        np.testing.assert_array_equal(sv.flush(), 0.0)  # never pushed
        first = sv.push(c[0])
        tail = sv.flush()
        assert tail.shape == (sv.flush_samples,)
        np.testing.assert_array_equal(sv.push(c[0]), first)  # flushed = fresh
        sv2 = self._sv(n_streams=2)
        sv2.push(np.stack([c[0], c[1]]))
        out = sv2.flush(active=[False, True])
        assert out.shape == (2, sv2.flush_samples)
        np.testing.assert_array_equal(out[0], 0.0)
        o2 = sv2.push(np.stack([c[1], c[0]]))
        ref = self._sv(n_streams=2)
        ref.push(np.stack([c[0], c[1]]))
        np.testing.assert_array_equal(o2[0], ref.push(np.stack([c[1], c[0]]))[0])
        np.testing.assert_array_equal(o2[1], self._sv(n_streams=2).push(np.stack([c[1], c[0]]))[1])

    def test_readback_false_returns_the_device_tensor(self, mel):
        c = _chunks(mel, 2)
        a, b = self._sv(), self._sv()
        for x in c:
            t = a.push(x, readback=False)
            assert torch.is_tensor(t) and t.shape == (CH * HOP,)
            np.testing.assert_array_equal(t.numpy(), b.push(x))
        assert torch.is_tensor(a.flush(readback=False))

    def test_validation(self):
        with pytest.raises(ValueError, match="emit_dtype"):
            self._sv(emit_dtype="int8")
        with pytest.raises(ValueError, match="mel_dtype"):
            self._sv(mel_dtype="bfloat16")
        with pytest.raises(ValueError, match="overlap_frames"):
            StreamingVocoder(chunk_frames=8, overlap_frames=9, device="cpu")
        with pytest.raises(ValueError, match="phase_engine"):
            self._sv(phase_engine="lws")
        sv = self._sv(n_streams=2)
        with pytest.raises(ValueError, match="active"):
            sv.push(np.zeros((2, CH, 80), np.float32), active=[True])
        with pytest.raises(ValueError, match="streams need"):
            sv.push(np.zeros((CH, 80), np.float32))
        with pytest.raises(ValueError, match="does not fit"):
            sv.push(np.zeros((2, CH + 1, 80), np.float32))

    @pytest.mark.parametrize("kw", [dict(phase_engine="lws_exact"),
                                    dict(phase_engine="lws_block", mel_context=CH + 1),
                                    dict(mel_context=2), dict(mesh=object())])
    def test_unported_options_raise(self, kw):
        """mesh is not ported and raises so. The lws engines and mel_context,
        which raised the same way before, run now (test_torch_lws_streaming.py):
        their cases hold the JAX package's ValueErrors instead, for an
        unknown engine, a mel_context past the chunk, and mel_context on the
        gl engine."""
        if "mesh" in kw:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                self._sv(**kw)
            return
        with pytest.raises(ValueError, match="phase_engine|mel_context"):
            self._sv(**kw)

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingVocoder()


class TestLongform:
    def _long(self, mel):
        return np.concatenate([mel] * 3)  # (519, 80): 5 tiles of 128 frames

    @pytest.mark.parametrize("use_gen", [False, True], ids=["heuristic", "generator"])
    def test_against_jax_and_the_bucketed_call(self, gen, mel, use_gen):
        """Mel L1 within 10% of JAX's longform, and the parity bound of the
        JAX package against the bucketed call (tests/test_infer.py)."""
        apply, params, tg = gen
        m = self._long(mel)
        kw = dict(chunk_frames=CH, overlap_frames=4, gl_iters=8)
        jv = (JVocoder(g_apply=apply, g_params=params, params=P, **kw) if use_gen
              else JVocoder(params=P, **kw))
        tv = Vocoder(tg if use_gen else None, device="cpu", **kw)
        want = jv.vocode_longform(m, tile_frames=128, overlap_frames=8)
        got = tv.vocode_longform(m, tile_frames=128, overlap_frames=8)
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (m.shape[0] * HOP,)
        assert np.isfinite(got).all()
        l_port, l_jax = _mel_l1(got, m), _mel_l1(want, m)
        assert abs(l_port - l_jax) < MEL_L1_RTOL * l_jax, (l_port, l_jax)
        l_bucketed = _mel_l1(tv(m).numpy(), m)
        assert l_port < 1.3 * l_bucketed + 5e-3, (l_port, l_bucketed)

    def test_first_tile_matches_jax(self, gen, mel):
        """One tile (the first push from a fresh carry) at 2 iterations, the
        generator through the chunked stage: the waveform within the bound.
        The engine runs at the Vocoder's precision; JAX on the CPU computes
        its DEFAULT in fp32, so the port is held at "highest" here (its
        "default" is TestGlPrecision's)."""
        apply, params, tg = gen
        kw = dict(chunk_frames=CH, overlap_frames=4, gl_iters=2)
        m = mel[:64]
        want = JVocoder(g_apply=apply, g_params=params, params=P, **kw).vocode_longform(
            m, tile_frames=64, overlap_frames=8)
        got = Vocoder(tg, device="cpu", gl_precision="highest", **kw).vocode_longform(
            m, tile_frames=64, overlap_frames=8)
        # The first 56 frames come from the first push alone.
        n = 56 * HOP
        _close(got[:n], want[:n])

    def test_one_engine_and_row_independence(self, mel):
        tv = Vocoder(chunk_frames=64, overlap_frames=8, gl_iters=2, device="cpu")
        rows = tv.vocode_longform(np.stack([mel[:130], mel[43:173]]), tile_frames=128)
        assert rows.shape == (2, 130 * HOP)
        solo = tv.vocode_longform(mel[:130], tile_frames=128)
        np.testing.assert_array_equal(rows[0], solo)
        tv.vocode_longform(mel[:128], tile_frames=128)
        assert list(tv._longform) == [(128, 32)]

    def test_tile_must_be_chunk_multiple(self):
        with pytest.raises(ValueError, match="multiple"):
            Vocoder(chunk_frames=64, device="cpu").vocode_longform(
                np.zeros((100, P.n_mels)), tile_frames=96)


class TestGlPrecision:
    """The gl engine's ``gl_precision``, the JAX class's keyword: None is
    "highest" (fp32, what the tests above hold to JAX); "default" runs the
    matmul G-L's loop with bf16 operands, JAX's single-pass DEFAULT, which
    JAX on the CPU computes in fp32, so it is held to "highest" by mel L1
    within 2e-3."""

    def test_keyword_reaches_griffin_lim(self, mel, monkeypatch):
        seen = []
        real = tsp.griffin_lim
        monkeypatch.setattr(tsp, "griffin_lim",
                            lambda *a, **kw: seen.append(kw["precision"]) or real(*a, **kw))
        kw = dict(chunk_frames=CH, overlap_frames=OV, gl_iters=2, device="cpu")
        for value, want in ((None, "highest"), ("highest", "highest"), ("default", "default")):
            sv = StreamingVocoder(gl_precision=value, **kw)
            assert sv.gl_precision == want
            sv.push(_chunks(mel, 1)[0])
            assert seen[-1] == want
        with pytest.raises(ValueError, match="gl_precision"):
            StreamingVocoder(gl_precision="bf16", **kw)

    @pytest.mark.parametrize("value,want", [(None, "default"), ("highest", "highest")])
    def test_longform_engine_carries_the_vocoders(self, mel, value, want):
        """vocode_longform builds its engine at the Vocoder's own precision
        (None is "default" for the Vocoder), as the JAX package's does."""
        tv = Vocoder(chunk_frames=64, gl_iters=2, gl_precision=value, device="cpu")
        tv.vocode_longform(mel[:128], tile_frames=128)
        assert tv.gl_precision == want and tv._longform[(128, 32)].gl_precision == want

    def test_default_within_2e_3_mel_l1_of_highest(self, mel):
        """Four chunks and a flush at 16 iterations, at each precision."""
        c = _chunks(mel, 4)
        l1 = {}
        for prec in ("highest", "default"):
            sv = StreamingVocoder(chunk_frames=CH, overlap_frames=OV, gl_iters=16,
                                  gl_precision=prec, device="cpu")
            sig = np.concatenate([sv.push(x) for x in c] + [sv.flush()])[sv.flush_samples :]
            l1[prec] = _mel_l1(sig, c.reshape(-1, P.n_mels))
        assert abs(l1["default"] - l1["highest"]) < 2e-3, l1


class TestSpectralPieces:
    def test_return_final_phase_matches_jax(self):
        """Two G-L iterations from a random phase: the waveform and the unit
        phase of the last update, against the JAX matmul form."""
        rng = np.random.default_rng(0)
        mag = rng.uniform(0, 1, (2, 24, 513)).astype(np.float32)
        phi = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        kw = dict(n_iters=2, momentum=0.99, return_final_phase=True)
        jy, jph = jsp.griffin_lim(jnp.asarray(mag), 24 * HOP,
                                  init_phase=(jnp.cos(phi), jnp.sin(phi)), **kw)
        ty, tph = tsp.griffin_lim(torch.tensor(mag), 24 * HOP,
                                  init_phase=(torch.cos(torch.tensor(phi)),
                                              torch.sin(torch.tensor(phi))), **kw)
        _close(ty.numpy(), np.asarray(jy))
        # Unit phase: where the rebuilt |u| is small it is ill-conditioned,
        # so compare it weighted by the magnitude it multiplies.
        for t, j in zip(tph, jph):
            assert t.shape == (2, 24, 513)
            np.testing.assert_allclose(mag * t.numpy(), mag * np.asarray(j), atol=1e-3)
        np.testing.assert_allclose(tph[0].numpy() ** 2 + tph[1].numpy() ** 2, 1.0, atol=1e-5)
        with pytest.raises(ValueError, match="matmul"):
            tsp.griffin_lim(torch.tensor(mag), fft_impl="kernel", return_final_phase=True)

    @pytest.mark.parametrize("coef", [0.0, 0.7])
    def test_pghi_init_phase_matches_jax(self, coef):
        """φ is a float32 running sum over T frames of advances up to
        2π·hop·F/n_fft ≈ 804 rad; both frameworks round each partial sum,
        in other orders, so they differ by up to T ulps of the largest
        partial sum (T = 24: ≈ 24 · 2e-3 rad)."""
        mag = np.random.default_rng(1).uniform(0, 1, (2, 24, 513)).astype(np.float32)
        jc, js_ = jsp.pghi_init_phase(jnp.asarray(mag), P, coef)
        tc, ts_ = tsp.pghi_init_phase(torch.tensor(mag), P, coef)
        bound = 24 * np.spacing(np.float32(24 * 2 * np.pi * HOP * 512 / P.n_fft))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=bound)
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), atol=bound)

    def test_vocoder_pghi_reaches_both_forms(self, mel, monkeypatch):
        """phase_init="pghi": the matmul scan (at the Vocoder's precision,
        "default") starts from pghi_init_phase of the projected magnitude,
        and so does the kernel form (on 512 bins)."""
        from advoc_tpu_torch.ops.kernels import griffin_lim as tgl

        kw = dict(chunk_frames=64, gl_iters=2, device="cpu", phase_init="pghi", pghi_coef=0.5)
        m = torch.tensor(mel[:64])
        est = tsp.normalize_db(tsp.amp_to_db(tsp.r9y9_melspec_to_magspec(m)) - P.ref_level_db)
        mag = tsp.db_to_amp(tsp.denormalize_db(est) + P.ref_level_db)  # the heuristic Vocoder's
        want = tsp.griffin_lim(mag, n_iters=2, momentum=0.99, precision="default",
                               init_phase=tsp.pghi_init_phase(mag, P, 0.5))
        torch.testing.assert_close(Vocoder(phase_impl="xla", **kw)(m), want, rtol=0, atol=0)
        seen = []
        real = tgl.griffin_lim_kernel
        monkeypatch.setattr(tgl, "griffin_lim_kernel",
                            lambda *a, **k: seen.append(k["init_phase"]) or real(*a, **k))
        Vocoder(phase_impl="kernel", **kw)(m)
        cos0, _ = tsp.pghi_init_phase(mag, P, 0.5)
        torch.testing.assert_close(seen[0][0], cos0[..., :512][None], rtol=0, atol=0)
        with pytest.raises(ValueError, match="phase_init"):
            Vocoder(device="cpu", phase_init="random")

    def test_vocoder_pghi_mel_l1_matches_jax(self, mel):
        kw = dict(chunk_frames=64, gl_iters=16, phase_init="pghi", pghi_coef=0.5)
        want = np.asarray(JVocoder(params=P, **kw)(mel))
        got = Vocoder(device="cpu", phase_impl="xla", **kw)(mel).numpy()
        l_port, l_jax = _mel_l1(got, mel), _mel_l1(want, mel)
        assert abs(l_port - l_jax) < MEL_L1_RTOL * l_jax, (l_port, l_jax)
