"""The port's LWS phase recovery, streaming iSTFT and one-call heuristic
vocoders against the JAX package, both on the CPU.

The same numpy inputs go through both packages. Host constants are equal
in float64. One LWS frame update is a float32 sum either way (the port's is
one product with the folded kernel matrix, the JAX package's the banded
and corner products), so the two agree to float32 rounding; a batch LWS of
a few sweeps stays there (tests/test_spectral.py holds the JAX scan to the
float64 oracle at 1e-4). Online LWS carries each frame's phase into the
next arrival's update, so rounding grows along the stream: the asymmetric
head update, a dense (2Q−1)·F-deep sum, puts the JAX scan 1.6e-3 off the
float64 oracle at 24 frames (its own test allows 2e-3) and the port 4.5e-4;
those cases are held to the oracle and to JAX at that bound.
"""

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
HOP = P.hop_length
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mag():
    """(48, 513) float32 magnitudes of synthetic speech."""
    wav = loader.synthetic_speech(1, 48 * HOP)
    return np.abs(jref.stft(wav, P))[:48].astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cplx(re, im) -> np.ndarray:
    return np.asarray(re) + 1j * np.asarray(im)


class TestConstants:
    def test_lws_kernels_equal_jax(self):
        for got, want in zip(tref.lws_kernels(TP), jref.lws_kernels(P)):
            assert got.dtype == want.dtype == np.complex128
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    def test_lws_edge_kernels_equal_jax(self):
        for got, want in zip(tref.lws_edge_kernels(TP), jref.lws_edge_kernels(P)):
            assert got.shape == want.shape == (3, 7, P.n_freq, P.n_freq)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    def test_float64_stft_istft_equal_jax(self):
        x = loader.synthetic_speech(2, 20 * HOP + 17)
        np.testing.assert_allclose(tref.stft(x, TP), jref.stft(x, P), rtol=0, atol=1e-12)
        spec = jref.stft(x, P)
        np.testing.assert_allclose(tref.istft(spec, len(x), TP), jref.istft(spec, len(x), P),
                                   rtol=0, atol=1e-12)

    def test_kernels_are_cached_on_the_device(self):
        assert tsp._lws_consts(TP, 3, 8, False, CPU) is tsp._lws_consts(TP, 3, 8, False, CPU)
        ks = tsp._lws_online_consts(TP, 3, 8, 4, True, False, CPU)
        assert ks[3] is ks[4] is tsp._lws_consts(TP, 3, 8, False, CPU)  # interior, shared
        assert ks[0].shape == (7 * P.n_freq * 2, P.n_freq * 2) and ks[0].dtype == torch.float32


class TestIstftStream:
    @pytest.mark.parametrize("cs", [8, 2])  # 2: chunks shorter than the (r−1)-frame overlap
    def test_chunked_equals_jax_and_offline(self, cs):
        rng = np.random.default_rng(3)
        t = 32
        spec = (rng.standard_normal((2, t, P.n_freq))
                + 1j * rng.standard_normal((2, t, P.n_freq))).astype(np.complex64)
        jc, tc = jsp.istft_stream_init(2, P), tsp.istft_stream_init(2, TP)
        want, got = [], []
        for c0 in range(0, t, cs):
            e, jc = jsp.istft_stream_push(jnp.asarray(spec[:, c0 : c0 + cs]), jc, P)
            want.append(np.asarray(e))
            e, tc = tsp.istft_stream_push(torch.tensor(spec[:, c0 : c0 + cs]), tc, TP)
            assert e.shape == (2, cs * HOP)
            got.append(e.numpy())
        want.append(np.asarray(jsp.istft_stream_flush(jc, P)))
        got.append(tsp.istft_stream_flush(tc, TP).numpy())
        got, want = np.concatenate(got, 1), np.concatenate(want, 1)
        assert got.shape == (2, (t + 3) * HOP)
        sig = slice(P.n_fft // 2, P.n_fft // 2 + t * HOP)
        np.testing.assert_allclose(got[:, sig], want[:, sig], rtol=0, atol=1e-5)
        # The preroll and the flushed tail past the signal divide by the
        # small partial window-sums of the first and last frames: relative.
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        off = tsp.istft(torch.tensor(spec), t * HOP, TP).numpy()
        np.testing.assert_allclose(got[:, sig], off, rtol=0, atol=1e-5)


class TestLwsUpdate:
    """One frame update from windows of a real spectrogram at random phase,
    against the JAX ``_lws_update``: ≤ 1e-5 × the peak magnitude (measured
    5e-7)."""

    def _win(self, n=3):
        wav = loader.synthetic_speech(1, 128 * HOP)
        spec = jref.stft(wav, P)
        spec *= np.exp(1j * np.random.default_rng(0).uniform(0, 2 * np.pi, spec.shape))
        ms = 10 + 13 * np.arange(n)
        win = np.stack([spec[m - 3 : m + 4] for m in ms]).astype(np.complex64)
        return win, (1.3 * np.abs(spec[ms])).astype(np.float32)

    @pytest.mark.parametrize("variant", ["banded", "include_self", "dense_head", "edge_d1"])
    def test_matches_jax(self, variant):
        win, mg = self._win()
        include_self = variant == "include_self"
        if variant in ("banded", "include_self"):
            jc, k = jsp._lws_consts(P, 3, 8), tsp._lws_consts(TP, 3, 8, include_self, CPU)
        else:
            d = 0 if variant == "dense_head" else 1
            jc = jsp._lws_online_consts(P, 3, 8, 2, True)[d]
            k = tsp._lws_online_consts(TP, 3, 8, 2, True, False, CPU)[d]
            assert ("dense" in jc) == (d == 0)
        jr, ji = jsp._lws_update(jnp.asarray(win.real), jnp.asarray(win.imag), jnp.asarray(mg),
                                 jc, include_self)
        got = tsp._lws_update(torch.tensor(win), torch.tensor(mg), k).numpy()
        assert got.shape == (3, P.n_freq) and got.dtype == np.complex64
        np.testing.assert_allclose(got, _cplx(jr, ji), rtol=0, atol=1e-5 * mg.max())
        np.testing.assert_allclose(np.abs(got), mg, rtol=1e-5)

    def test_batch_equals_rows_and_out_in_place(self):
        """The same update on (B·K) rows and row by row: the GEMM of one row
        and of many round the same sums differently, within 1e-6 × peak
        (measured 5e-7). ``out`` writes the same values in place."""
        win, mg = self._win(6)
        k = tsp._lws_consts(TP, 3, 8, False, CPU)
        batch = tsp._lws_update(torch.tensor(win), torch.tensor(mg), k)
        rows = torch.cat([tsp._lws_update(torch.tensor(win[i : i + 1]), torch.tensor(mg[i : i + 1]),
                                          k) for i in range(6)])
        torch.testing.assert_close(rows, batch, rtol=0, atol=1e-6 * float(mg.max()))
        buf = torch.zeros((6, 9, P.n_freq), dtype=torch.complex64)
        tsp._lws_update(torch.tensor(win), torch.tensor(mg), k, out=buf[:, 4])
        torch.testing.assert_close(buf[:, 4], batch, rtol=0, atol=0)
        assert float(buf[:, :4].abs().max()) == float(buf[:, 5:].abs().max()) == 0.0


class TestLws:
    @pytest.mark.parametrize("n_sweeps,colors", [(2, 1), (3, 4)])
    def test_matches_jax(self, mag, n_sweeps, colors):
        """Sequential and chromatic, two rows: ≤ 1e-4 relative (measured
        6e-6 and 2e-6)."""
        m = np.stack([mag[:32], 0.5 * mag[16:48]])
        want = np.asarray(jsp.lws(jnp.asarray(m), n_sweeps=n_sweeps, colors=colors, params=P))
        got = tsp.lws(torch.tensor(m), n_sweeps=n_sweeps, colors=colors, params=TP).numpy()
        assert got.shape == want.shape == (2, 32 * HOP)
        assert _rel(got, want) < 1e-4

    def test_matches_float64_oracle(self, mag):
        gold = jref.lws(mag[:32].astype(np.float64), n_sweeps=3, params=P)
        assert _rel(tsp.lws(torch.tensor(mag[:32]), n_sweeps=3).numpy(), gold) < 1e-4

    def test_degenerate_chromatic_is_sequential(self, mag):
        """colors ≥ T makes every color one frame in ascending order: the
        same updates on the same windows, so the same bits."""
        m = torch.tensor(mag[:24])
        seq = tsp.lws(m, n_sweeps=2)
        for colors in (24, 30):
            torch.testing.assert_close(tsp.lws(m, n_sweeps=2, colors=colors), seq, rtol=0, atol=0)

    def test_batched_rows_equal_single_rows(self, mag):
        m = torch.tensor(np.stack([mag[:16], 0.5 * mag[:16], mag[20:36]]))
        out = tsp.lws(m, n_sweeps=2)
        assert out.shape == (3, 16 * HOP)
        for i in range(3):
            torch.testing.assert_close(out[i], tsp.lws(m[i], n_sweeps=2), rtol=0, atol=1e-5)

    def test_length_and_lead_dims(self, mag):
        m = torch.tensor(np.stack([mag[:8]] * 2)).reshape(2, 1, 8, P.n_freq)
        assert tsp.lws(m, 8 * HOP - 100, n_sweeps=1).shape == (2, 1, 8 * HOP - 100)


class TestLwsOnline:
    @pytest.mark.parametrize("asymmetric", [False, True])
    def test_matches_jax_and_oracle(self, mag, asymmetric):
        """Symmetric (banded updates only): ≤ 1e-4 of JAX (measured 2e-6).
        Asymmetric: the float64 oracle within 1e-3 (measured 4.5e-4), and
        JAX within its own bound to the oracle, 2e-3 (measured 1.4e-3)."""
        m = mag[:24]
        want = np.asarray(jsp.lws_online(jnp.asarray(m), n_sweeps=2, asymmetric=asymmetric,
                                         params=P))
        got = tsp.lws_online(torch.tensor(m), n_sweeps=2, asymmetric=asymmetric).numpy()
        assert got.shape == (24 * HOP,)
        assert _rel(got, want) < (2e-3 if asymmetric else 1e-4)
        if asymmetric:
            gold = jref.lws_online(m.astype(np.float64), n_sweeps=2, asymmetric=True, params=P)
            assert _rel(got, gold) < 1e-3

    def test_look_ahead_past_edge_region(self, mag):
        """look_ahead ≥ Q−1 mixes interior and edge kernel sets: the float64
        oracle within JAX's bound for this case, 2e-3."""
        m = mag[:16]
        gold = jref.lws_online(m.astype(np.float64), n_sweeps=1, look_ahead=4, params=P)
        assert _rel(tsp.lws_online(torch.tensor(m), n_sweeps=1, look_ahead=4).numpy(), gold) < 2e-3

    def test_push_chunk_invariance(self, mag):
        """Chunks of 8, 4 and 1 emit the same frames bit for bit, the first
        ``look_ahead`` of them zeros, and with the drained tail they are
        the spectrum of one ``lws_online`` (held to JAX above), bit for
        bit."""
        la, m = 2, torch.tensor(mag[None, :16])

        def run(cs):
            carry, ems = tsp.lws_online_init(1, la), []
            for c0 in range(0, 16, cs):
                (er, ei), carry = tsp.lws_online_push(m[:, c0 : c0 + cs], carry, look_ahead=la)
                ems.append(torch.complex(er, ei))
            return torch.cat(ems, 1), carry

        em8, carry = run(8)
        assert float(em8[:, :la].abs().max()) == 0.0
        for cs in (4, 1):
            torch.testing.assert_close(run(cs)[0], em8, rtol=0, atol=0)
        spec = torch.cat([em8[:, la:], torch.complex(*tsp.lws_online_drain(carry, la))], 1)
        torch.testing.assert_close(tsp.istft(spec, 16 * HOP), tsp.lws_online(m, look_ahead=la),
                                   rtol=0, atol=0)

    def test_push_writes_no_carry(self, mag):
        carry = tuple(torch.tensor(np.random.default_rng(0).standard_normal(s), dtype=torch.float32)
                      for s in ((2, 9, P.n_freq), (2, 9, P.n_freq), (2, 3, P.n_freq)))
        before = tuple(x.clone() for x in carry)
        tsp.lws_online_push(torch.tensor(np.stack([mag[:4]] * 2)), carry)
        tsp.lws_block_push(torch.tensor(np.stack([mag[:4]] * 2)), carry)
        for x, y in zip(carry, before):
            torch.testing.assert_close(x, y, rtol=0, atol=0)

    def test_drain_matches_offline_tail(self, mag):
        """Pushes + ``lws_online_drain`` through the streaming iSTFT (flush
        cropped to n_fft // 2) give exactly T·hop aligned samples, equal to
        offline ``lws_online`` past the stream head (where the streaming
        window-sum counts the leading zero frames): the JAX test's contract,
        1e-5."""
        la, t, cs = 2, 16, 8
        m = torch.tensor(mag[None, :t])
        off = tsp.lws_online(m, t * HOP, look_ahead=la)[0].numpy()
        carry, ola, outs = tsp.lws_online_init(1, la), tsp.istft_stream_init(1), []
        for c0 in range(0, t, cs):
            (er, ei), carry = tsp.lws_online_push(m[:, c0 : c0 + cs], carry, look_ahead=la)
            e, ola = tsp.istft_stream_push(torch.complex(er, ei), ola)
            outs.append(e[0].numpy())
        dr = tsp.lws_online_drain(carry, la)
        e, ola = tsp.istft_stream_push(torch.complex(*dr), ola)
        outs += [e[0].numpy(), tsp.istft_stream_flush(ola)[0, : P.n_fft // 2].numpy()]
        stream = np.concatenate(outs)
        start = P.n_fft // 2 + la * HOP
        assert stream.shape == (t * HOP + start,)
        np.testing.assert_allclose(stream[start:][P.n_fft :], off[P.n_fft :], rtol=0, atol=1e-5)
        jdr = jsp.lws_online_drain(tuple(jnp.asarray(x.numpy()) for x in carry), la, P)
        np.testing.assert_array_equal(_cplx(*dr), _cplx(*jdr))

    def test_needs_more_frames_than_look_ahead(self, mag):
        with pytest.raises(ValueError, match="look_ahead"):
            tsp.lws_online(torch.tensor(mag[:2]), look_ahead=2)


class TestLwsBlock:
    @pytest.mark.parametrize("init", ["advance", "zero"])
    def test_matches_jax(self, mag, init):
        """Three chunks of 8 through both, from the same fresh carry:
        ≤ 1e-4 relative (measured 4e-7 and 1.4e-6)."""
        m = np.stack([mag[:24], 0.7 * mag[24:48]])
        jpush = jax.jit(lambda x, c: jsp.lws_block_push(x, c, n_sweeps=2, init=init, params=P))
        jc, tc, want, got = jsp.lws_online_init(2, 2, P), tsp.lws_online_init(2, 2), [], []
        for c0 in range(0, 24, 8):
            (a, b), jc = jpush(jnp.asarray(m[:, c0 : c0 + 8]), jc)
            want.append(_cplx(a, b))
            (a, b), tc = tsp.lws_block_push(torch.tensor(m[:, c0 : c0 + 8]), tc, n_sweeps=2,
                                            init=init)
            got.append(_cplx(a, b))
        got, want = np.concatenate(got, 1), np.concatenate(want, 1)
        assert np.abs(got[:, :2]).max() == 0.0
        assert _rel(got, want) < 1e-4
        for x, y in zip(tc, jc):
            assert tuple(x.shape) == y.shape
            assert _rel(x.numpy(), y) < 1e-4

    def test_jacobi(self, mag):
        """colors=1: every mutable frame from the same pre-sweep state."""
        (a, b), _ = jsp.lws_block_push(jnp.asarray(mag[None, :6]), jsp.lws_online_init(1, 2, P),
                                       n_sweeps=1, colors=1, params=P)
        (c, d), _ = tsp.lws_block_push(torch.tensor(mag[None, :6]), tsp.lws_online_init(1, 2),
                                       n_sweeps=1, colors=1)
        assert _rel(_cplx(c, d), _cplx(a, b)) < 1e-4

    def test_validation(self):
        carry, m = tsp.lws_online_init(1, 2), torch.ones((1, 4, P.n_freq))
        with pytest.raises(ValueError, match="colors"):
            tsp.lws_block_push(m, carry, colors=0)
        with pytest.raises(ValueError, match="init"):
            tsp.lws_block_push(m, carry, init="pghi")


class TestOneCallVocoders:
    # Per mode at 2 iterations: fast and classic G-L from a zero phase hold
    # test_torch_spectral.py's bound between two float32 G-L programs (5e-4
    # × peak); batch LWS 1e-4; online LWS the asymmetric bound above.
    MODES = {"lws": 5e-4, "griffin_lim": 5e-4, "lws_exact": 1e-4, "lws_chromatic": 1e-4,
             "lws_online": 2e-3}

    @pytest.fixture(scope="class")
    def mel(self):
        x = loader.synthetic_speech(0, 24 * HOP)
        return np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(x), P))[:24]

    @pytest.mark.parametrize("phase_method", list(MODES))
    def test_r9y9_melspec_to_waveform_matches_jax(self, mel, phase_method):
        want = np.asarray(jsp.r9y9_melspec_to_waveform(jnp.asarray(mel), n_iters=2,
                                                       phase_method=phase_method, params=P))
        got = tsp.r9y9_melspec_to_waveform(torch.tensor(mel), n_iters=2,
                                           phase_method=phase_method).numpy()
        assert got.shape == want.shape == (24 * HOP,)
        assert _rel(got, want) < self.MODES[phase_method]

    def test_dispatch_and_unknown_mode(self, mel):
        m = torch.tensor(mel[None, :16])
        mag = tsp.r9y9_melspec_to_magspec(m)
        for method, direct in (("lws_chromatic", tsp.lws(mag, n_sweeps=1, colors=4)),
                               ("lws_online", tsp.lws_online(mag, n_sweeps=1)),
                               ("griffin_lim", tsp.magspec_to_waveform_griffin_lim(mag, 1)),
                               ("lws", tsp.magspec_to_waveform_lws(mag, 1))):
            torch.testing.assert_close(
                tsp.r9y9_melspec_to_waveform(m, n_iters=1, phase_method=method), direct,
                rtol=0, atol=0)
        with pytest.raises(ValueError, match="phase_method"):
            tsp.r9y9_melspec_to_waveform(m, phase_method="lws_fast")


class TestGriffinLimForms:
    @pytest.mark.parametrize("n_iters", [1, 3])
    def test_fft_form_matches_jax(self, mag, n_iters):
        """The istft/stft iteration: the bound between two float32 G-L
        programs from a zero phase, 5e-4 × peak (measured 2e-5)."""
        m = np.stack([mag[:32], mag[16:48]])
        want = np.asarray(jsp.griffin_lim(jnp.asarray(m), n_iters=n_iters, momentum=0.99,
                                          fft_impl="fft", params=P))
        got = tsp.griffin_lim(torch.tensor(m), n_iters=n_iters, momentum=0.99,
                              fft_impl="fft").numpy()
        assert _rel(got, want) < 5e-4
        matmul = tsp.griffin_lim(torch.tensor(m), n_iters=n_iters, momentum=0.99).numpy()
        assert _rel(got, matmul) < 5e-4
        with pytest.raises(ValueError, match="init_phase"):
            tsp.griffin_lim(torch.tensor(m), fft_impl="fft",
                            init_phase=(torch.ones(1), torch.zeros(1)))

    def test_matmul_default_precision(self, mag):
        """precision="default" in the matmul form: bf16 operands in the loop
        (so one iteration already differs from fp32 by more than fp32
        rounding), the final synthesis in fp32 (so with no iteration the two
        are the same), and the quality gate: re-extracted mel L1 within 2e-3
        of "highest" at 16 iterations."""
        x = loader.synthetic_speech(0, 48 * HOP)
        mel = tsp.waveform_to_r9y9_melspec(torch.tensor(x))[None, :48]
        m = tsp.r9y9_melspec_to_magspec(mel)  # the heuristic estimate, as vocoders see it
        kw = dict(momentum=0.99)
        for n_iters, same in ((0, True), (1, False)):
            hi = tsp.griffin_lim(m, n_iters=n_iters, precision="highest", **kw)
            de = tsp.griffin_lim(m, n_iters=n_iters, precision="default", **kw)
            assert torch.equal(hi, de) == same
        torch.testing.assert_close(tsp.griffin_lim(m, n_iters=1, **kw),
                                   tsp.griffin_lim(m, n_iters=1, precision="highest", **kw),
                                   rtol=0, atol=0)

        def l1(y):
            return float((tsp.waveform_to_r9y9_melspec(y)[..., :48, :] - mel).abs().mean())

        l1_hi = l1(tsp.griffin_lim(m, n_iters=16, precision="highest", **kw))
        l1_de = l1(tsp.griffin_lim(m, n_iters=16, precision="default", **kw))
        assert abs(l1_de - l1_hi) < 2e-3, (l1_de, l1_hi)

    def test_bf16_operands_with_fp32_accumulation(self):
        """The CPU form of a "default" product equals float64 sums of the
        bf16-rounded operands to fp32 rounding: the operands are rounded,
        the accumulation is not."""
        x = torch.tensor(np.random.default_rng(0).standard_normal((5, P.n_freq)),
                         dtype=torch.float32)
        got = tsp._dft_matmul(x, TP, "inv_re", "default").double()
        w = tsp._const(TP, "inv_re", CPU)
        want = x.bfloat16().double() @ w.bfloat16().double()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
        assert float((x @ w - want.float()).abs().max()) > 1e-4 * float(want.abs().max())
