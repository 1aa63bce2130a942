"""The port's StreamingVocoder lws engines (``lws_online``, ``lws_block``)
against the JAX package's, both on the CPU, and the serving contracts they
keep on their own.

Same numpy mels and the same weights (the tiny ``fast_head`` generator of
test_torch_streaming.py, converted from flax) into both. One push from an
identical carry is compared by waveform, within 1e-4 × peak. Online LWS
carries each frame's phase into the next arrival's update, so float32
rounding grows along a stream (test_torch_lws.py): whole streams are
compared by re-extracted mel L1, within 10%. The masked-row, flush, reset
and mel_context contracts are checked in the port, bit for bit where the
JAX package's tests check them so (tests/test_infer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.infer import StreamingVocoder as JStreaming
from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.infer import StreamingVocoder
from advoc_tpu_torch.models.advoc import AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import small_config

HOP = P.hop_length
CH = 16
# Small sweep budgets, as the JAX package's engine tests use.
ENGINES = {"lws_online": dict(lws_look_ahead=1, lws_sweeps=1),
           "lws_block": dict(lws_look_ahead=1, lws_sweeps=2)}
RTOL_PUSH = 1e-4  # one push from an identical carry, × peak
MEL_L1_RTOL = 0.1


def _mel(chunks, seed=0):
    wav = loader.synthetic_speech(seed, CH * chunks * HOP)
    m = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[: CH * chunks]
    return m.reshape(chunks, CH, P.n_mels)


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


@pytest.fixture(scope="module")
def jax_sv(gen):
    """JAX engines, one per configuration (each compiles its push once),
    reset before they are handed out."""
    cache = {}

    def get(engine, use_gen=False, n=1, ctx=0):
        key = (engine, use_gen, n, ctx)
        if key not in cache:
            apply, params, _ = gen
            g = dict(g_apply=apply, g_params=params) if use_gen else {}
            cache[key] = JStreaming(params=P, chunk_frames=CH, n_streams=n, phase_engine=engine,
                                    mel_context=ctx, **g, **ENGINES[engine])
        cache[key].reset()
        return cache[key]

    return get


def _sv(engine, use_gen=False, gen=None, **kw):
    g = gen[2] if use_gen else None
    return StreamingVocoder(g, params=P, chunk_frames=CH, phase_engine=engine, device="cpu",
                            **ENGINES[engine] | kw)


def _copy_carry(js, ts):
    ts._state_lws = tuple(torch.tensor(np.asarray(x)) for x in js._state_lws)
    ts._state_ola = tuple(torch.tensor(np.asarray(x)) for x in js._state_ola)
    ts._state_mel = torch.tensor(np.asarray(js._state_mel))


def _close(got, want, rtol=RTOL_PUSH):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _mel_l1(wav, mel):
    m = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))
    n = min(m.shape[0], mel.shape[0]) - 1
    return float(np.abs(m[:n] - mel[:n]).mean())


@pytest.mark.parametrize("engine", list(ENGINES))
class TestAgainstJax:
    def test_first_push_and_push_from_the_same_carry(self, gen, jax_sv, engine):
        """With the generator (and so the projection): the first push from a
        fresh carry; then, after two JAX pushes with the carry copied into
        the port, the third push, within 1e-4 × peak, and the carries. The
        carried window holds frames still refining, whose bins where the
        consistency sum nearly cancels have an ill-conditioned phase: 1e-3
        × peak (measured 1.4e-4)."""
        mel = _mel(3, seed=1)
        js, ts = jax_sv(engine, True), _sv(engine, True, gen)
        for attr in ("preroll_samples", "latency_frames", "flush_samples", "lws_sweeps"):
            assert getattr(ts, attr) == getattr(js, attr), attr
        want, got = js.push(mel[0]), ts.push(mel[0])
        assert got.shape == want.shape == (CH * HOP,)
        _close(got, want)
        js.push(mel[1])
        _copy_carry(js, ts)
        _close(ts.push(mel[2]), js.push(mel[2]))
        for t, j in zip(ts._state_lws + ts._state_ola, js._state_lws + js._state_ola):
            _close(t.numpy(), np.asarray(j), 1e-3)

    def test_whole_streams_mel_l1(self, jax_sv, engine):
        """Two heuristic streams of six chunks and a flush: the first push
        within 1e-4 × peak, then exactly T·hop samples per stream after
        dropping flush_samples, each re-extracting as closely as JAX's."""
        mel = np.stack([_mel(6, seed=s) for s in (0, 2)], axis=1)  # (6, 2, CH, M)
        js, ts = jax_sv(engine, n=2), _sv(engine, n_streams=2)
        out = {}
        for name, sv in (("jax", js), ("port", ts)):
            sig = np.concatenate([sv.push(c) for c in mel] + [sv.flush()], axis=1)
            sig = sig[:, sv.flush_samples :]
            assert sig.shape == (2, 6 * CH * HOP)
            out[name] = sig
        _close(out["port"][:, : CH * HOP - P.n_fft // 2], out["jax"][:, : CH * HOP - P.n_fft // 2])
        for row in range(2):
            target = mel[:, row].reshape(-1, P.n_mels)
            l_port, l_jax = _mel_l1(out["port"][row], target), _mel_l1(out["jax"][row], target)
            assert abs(l_port - l_jax) < MEL_L1_RTOL * l_jax, (row, l_port, l_jax)
            assert l_port < 0.15

    def test_mel_context_push_and_flush(self, gen, jax_sv, engine):
        """mel_context=8 with the generator (CH + 2·8 = 32, a multiple of
        2^depth): the first push, then the flush that drains the withheld
        context frames, the look-ahead frames and the iSTFT tail."""
        mel = _mel(2, seed=5)
        js, ts = jax_sv(engine, use_gen=True, ctx=8), _sv(engine, True, gen, mel_context=8)
        assert ts.latency_frames == js.latency_frames == 1 + 8
        _close(ts.push(mel[0]), js.push(mel[0]))
        want, got = js.flush(), ts.flush()
        assert got.shape == want.shape == (ts.flush_samples,)
        _close(got, want)


@pytest.mark.parametrize("engine", list(ENGINES))
class TestContracts:
    """The serving contracts, in the port alone, as tests/test_infer.py
    checks them in JAX."""

    def test_skipped_tick_resumes_bit_exact(self, engine):
        a, b = _mel(3, seed=0), _mel(2, seed=1)
        zeros = np.zeros_like(a[0])
        sv = _sv(engine, n_streams=2)
        o1 = sv.push(np.stack([a[0], b[0]]))
        o2 = sv.push(np.stack([a[1], zeros]), active=[True, False])
        o3 = sv.push(np.stack([a[2], b[1]]))
        np.testing.assert_array_equal(o2[1], 0.0)
        ref0 = _sv(engine, n_streams=2)
        r = [ref0.push(np.stack([a[0], b[0]])), ref0.push(np.stack([a[1], b[1]])),
             ref0.push(np.stack([a[2], b[1]]))]
        for o, ro in zip((o1, o2, o3), r):
            np.testing.assert_array_equal(o[0], ro[0])
        ref1 = _sv(engine, n_streams=2)
        s1, s2 = ref1.push(np.stack([a[0], b[0]])), ref1.push(np.stack([a[1], b[1]]))
        np.testing.assert_array_equal(o1[1], s1[1])
        np.testing.assert_array_equal(o3[1], s2[1])

    def test_one_hot_pushes_equal_batched_rows(self, engine):
        """The server's correctness: a slot's stream through one-hot masked
        pushes and flush equals its row of all-active ones, bit for bit."""
        chunks = np.stack([_mel(2, seed=s) for s in (0, 1, 2)], axis=1)
        batched = _sv(engine, n_streams=3)
        rows = [batched.push(c) for c in chunks] + [batched.flush()]
        for slot in range(3):
            sv = _sv(engine, n_streams=3)
            onehot = np.arange(3) == slot
            for k, c in enumerate(chunks):
                x = np.zeros_like(c)
                x[slot] = c[slot]
                np.testing.assert_array_equal(sv.push(x, active=onehot)[slot], rows[k][slot])
            np.testing.assert_array_equal(sv.flush(active=onehot)[slot], rows[-1][slot])

    def test_assembled_stream_is_exact_length_and_complete(self, engine):
        mel = _mel(4)
        sv = _sv(engine)
        outs = [sv.push(c) for c in mel]
        tail = sv.flush()
        assert tail.shape == (sv.flush_samples,)
        assert sv.flush_samples == P.n_fft // 2 + sv.latency_frames * HOP
        sig = np.concatenate(outs + [tail])[sv.flush_samples :]
        assert sig.shape == (4 * CH * HOP,)
        flat = mel.reshape(-1, P.n_mels)
        m2 = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(sig), P))
        assert np.abs(m2[1:63] - flat[1:63]).mean() < 0.15
        assert np.abs(m2[56:63] - flat[56:63]).mean() < 0.3
        mid = np.sqrt((sig[len(sig) // 2 :][:4096] ** 2).mean())
        assert np.sqrt((sig[-sv.flush_samples :] ** 2).mean()) > 0.05 * mid

    def test_flush_resets_and_masked_flush_is_row_independent(self, engine):
        a, b = _mel(2, seed=0), _mel(2, seed=1)
        sv = _sv(engine)
        np.testing.assert_array_equal(sv.flush(), 0.0)  # never pushed
        first = sv.push(a[0])
        sv.flush()
        np.testing.assert_array_equal(sv.push(a[0]), first)  # flushed = fresh
        sv2 = _sv(engine, n_streams=2)
        sv2.push(np.stack([a[0], b[0]]))
        out = sv2.flush(active=[False, True])
        assert out.shape == (2, sv2.flush_samples)
        np.testing.assert_array_equal(out[0], 0.0)
        o2 = sv2.push(np.stack([a[1], b[0]]))
        ref = _sv(engine, n_streams=2)
        ref.push(np.stack([a[0], b[0]]))
        np.testing.assert_array_equal(o2[0], ref.push(np.stack([a[1], b[0]]))[0])
        np.testing.assert_array_equal(o2[1], _sv(engine, n_streams=2).push(np.stack([a[1], b[0]]))[1])

    def test_reset_one_stream(self, engine):
        """reset(stream) zeroes that row of every carry out of place (a carry
        made under torch.inference_mode resets too); the slot then behaves
        fresh and the other row is untouched."""
        c = np.stack([_mel(2, seed=s) for s in (0, 1)], axis=1)
        sv = _sv(engine, n_streams=2, mel_context=4)
        first = sv.push(c[0])
        with torch.inference_mode():
            sv.push(c[1])
        sv.reset(1)
        for x in sv._state_lws + sv._state_ola + (sv._state_mel,):
            assert float(x[1].abs().max()) == 0.0 and float(x[0].abs().max()) > 0.0
        again = sv.push(c[0])
        np.testing.assert_array_equal(again[1], first[1])
        ref = _sv(engine, n_streams=2, mel_context=4)
        ref.push(c[0])
        ref.push(c[1])
        np.testing.assert_array_equal(again[0], ref.push(c[0])[0])
        sv.reset()
        assert sv._state_lws is sv._state_ola is sv._state_mel is None

    def test_int16_emit_and_readback_false(self, engine):
        mel = _mel(2)
        f, q = _sv(engine), _sv(engine, emit_dtype="int16")
        for x in mel:
            t = q.push(x, readback=False)
            assert torch.is_tensor(t) and t.dtype == torch.int16
            ref = f.push(x)
            np.testing.assert_array_equal(
                t.numpy(), np.round(np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16))
        np.testing.assert_array_equal(
            q.flush(), np.round(np.clip(f.flush(), -1.0, 1.0) * 32767.0).astype(np.int16))


class TestMelContext:
    @pytest.mark.parametrize("ctx", [0, 4])
    def test_alignment(self, ctx):
        """An impulse-like mel event lands at its own frame once preroll and
        latency_frames (look-ahead + ctx) are dropped."""
        mel = np.zeros((4 * CH, P.n_mels), np.float32)
        ev = 37
        mel[ev : ev + 3] = 0.9
        sv = _sv("lws_online", mel_context=ctx)
        assert sv.latency_frames == 1 + ctx
        stream = np.concatenate([sv.push(mel[c * CH : (c + 1) * CH]) for c in range(4)])
        sig = stream[sv.preroll_samples + sv.latency_frames * HOP :]
        e = np.array([(sig[k * HOP : (k + 1) * HOP] ** 2).sum() for k in range(len(sig) // HOP)])
        assert abs(int(np.argmax(e)) - (ev + 1)) <= 2
        assert e[: ev - 4].max() < 1e-3 * e.max()

    def test_flush_drains_withheld_frames(self):
        """An event in the last frames, inside the withheld context of the
        final chunk, appears at its aligned position after the flush."""
        ctx, t = 4, 3 * CH
        mel = np.zeros((t, P.n_mels), np.float32)
        ev = t - 3
        mel[ev:] = 0.9
        sv = _sv("lws_online", mel_context=ctx)
        outs = [sv.push(mel[c * CH : (c + 1) * CH]) for c in range(3)]
        tail = sv.flush()
        assert tail.shape == (sv.flush_samples,) == (P.n_fft // 2 + (1 + ctx) * HOP,)
        sig = np.concatenate(outs + [tail])[sv.flush_samples :]
        assert sig.shape == (t * HOP,)
        e = np.array([(sig[k * HOP : (k + 1) * HOP] ** 2).sum() for k in range(t)])
        assert int(np.argmax(e)) >= ev - 1
        assert e[: ev - 4].max() < 1e-3 * e.max()


class TestOptions:
    def test_sweep_defaults_are_engine_specific(self):
        kw = dict(chunk_frames=CH, device="cpu")
        assert StreamingVocoder(phase_engine="lws_block", **kw).lws_sweeps == 4
        assert StreamingVocoder(phase_engine="lws_online", **kw).lws_sweeps == 2
        assert StreamingVocoder(phase_engine="lws_block", lws_sweeps=2, **kw).lws_sweeps == 2
        sv = StreamingVocoder(phase_engine="lws_online", **kw)
        assert (sv.preroll_samples, sv.latency_frames, sv.flush_samples) == (512, 2, 512 + 2 * HOP)

    def test_validation(self):
        """JAX's ValueErrors; lws_block's colors and init are checked where
        the JAX package checks them, at the first push."""
        kw = dict(chunk_frames=CH, device="cpu")
        with pytest.raises(ValueError, match="mel_context"):
            StreamingVocoder(phase_engine="gl", mel_context=4, **kw)
        with pytest.raises(ValueError, match="mel_context"):
            StreamingVocoder(phase_engine="lws_online", mel_context=CH + 1, **kw)
        with pytest.raises(ValueError, match="phase_engine"):
            StreamingVocoder(phase_engine="rtisi", **kw)
        for bad in (dict(lws_colors=0), dict(lws_init="pghi")):
            sv = StreamingVocoder(phase_engine="lws_block", **kw, **bad)
            with pytest.raises(ValueError, match="colors|init"):
                sv.push(np.zeros((CH, P.n_mels), np.float32))

    def test_no_look_ahead(self):
        """lws_look_ahead=0: nothing to drain, the flush is the iSTFT tail."""
        sv = StreamingVocoder(phase_engine="lws_block", chunk_frames=CH, lws_look_ahead=0,
                              lws_sweeps=1, device="cpu")
        mel = _mel(2)
        sig = np.concatenate([sv.push(c) for c in mel] + [sv.flush()])
        assert sv.flush_samples == P.n_fft // 2
        assert sig[sv.flush_samples :].shape == (2 * CH * HOP,)
