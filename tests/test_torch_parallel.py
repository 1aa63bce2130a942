"""The port's parallel layer on the CPU, against the JAX package's on its 8
virtual CPU devices (tests/conftest.py): the ('data',) mesh's sizing
rules, the halo-exchanged time-sharded featurizer, and the mesh'd Vocoder
and StreamingVocoder.

The port's mesh here is a list of CPU devices, one repeated per shard (the
analog of ``xla_force_host_platform_device_count``): every shard runs its
own program on its own slice, as on separate cards. Same numpy inputs into
both packages; the generators are tiny float32 configs initialized in flax
and converted. Tolerances are the JAX package's own gates
(tests/test_parallel.py, tests/test_infer.py) or, against JAX, the port's
established ones (tests/test_torch_vocoder.py, test_torch_streaming.py).
"""

import queue
import types

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
from advoc_tpu.parallel import data_mesh as jax_mesh
from advoc_tpu.parallel.halo import sharded_melspec as j_sharded_melspec
from advoc_tpu.parallel.halo import sharded_stft_mag as j_sharded_stft_mag
from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
from advoc_tpu_torch.models.advoc import AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.advoc.model import AdvocConfig
from advoc_tpu_torch.ops import spectral as tsp
from advoc_tpu_torch.parallel import Mesh, data_mesh, distributed, halo, replicate, shard_batch

HOP = P.hop_length
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> Mesh:
    return data_mesh(devices=[CPU] * n)


class TestDataMesh:
    @pytest.mark.parametrize("batch", [2, 16, 12, 7])
    def test_shrinks_to_largest_divisor_as_jax(self, batch):
        assert cpu_mesh(8).size == 8
        got = data_mesh(batch_size=batch, devices=[CPU] * 8).shape["data"]
        assert got == jax_mesh(batch_size=batch).devices.size == {2: 2, 16: 8, 12: 6, 7: 7}[batch]

    def test_explicit_n_devices_must_divide_and_exist(self):
        with pytest.raises(ValueError, match="divisible"):
            data_mesh(8, batch_size=2, devices=[CPU] * 8)
        assert data_mesh(2, batch_size=2, devices=[CPU] * 8).size == 2
        with pytest.raises(ValueError, match="devices there are"):
            data_mesh(3, devices=[CPU] * 2)

    def test_default_devices_are_the_visible_cards(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert data_mesh(batch_size=6).devices == tuple(torch.device("cuda", i) for i in range(3))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_mesh()

    def test_replicate_and_shard_batch(self):
        m = torch.nn.Linear(3, 2)
        mesh = cpu_mesh(4)
        copies = replicate(m, mesh)
        assert copies == [m] * 4 and replicate(m, mesh)[0] is m  # one copy a device, cached
        # A copy on another device is cached, and reloaded once the
        # module's weights change in place (the meta device stands in).
        two = Mesh((CPU, torch.device("meta")))
        copy_ = replicate(m, two)[1]
        assert copy_.weight.is_meta and replicate(m, two)[1] is copy_
        loads = []
        copy_.load_state_dict = loads.append
        replicate(m, two)
        assert loads == []
        with torch.no_grad():
            m.weight.add_(1.0)
        assert replicate(m, two)[1] is copy_ and len(loads) == 1
        t = torch.ones(3)
        assert [tuple(x.shape) for x in replicate(t, mesh)] == [(3,)] * 4
        assert all(len(pair) == 2 for pair in replicate((t, t), mesh))
        x = torch.arange(24.0).reshape(2, 12)
        parts = shard_batch(x, mesh, axis=1)
        assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
        torch.testing.assert_close(torch.cat(parts, dim=1), x, rtol=0, atol=0)
        with pytest.raises(ValueError, match="divisible"):
            shard_batch(x, cpu_mesh(5), axis=1)


class TestLaunch:
    """The parent's wait for the ranks of ``distributed.launch`` (its
    ``_collect``) on a clock that runs an hour a poll: fake ranks that put
    their results after five empty polls, or die, or raise."""

    class _Ranks:
        def __init__(self, results, exitcodes=(None, None)):
            self.items, self.polls = list(results), 0
            self.procs = [types.SimpleNamespace(exitcode=c) for c in exitcodes]

        def get(self, timeout):
            self.polls += 1
            if self.polls <= 5 or not self.items:
                raise queue.Empty
            return self.items.pop(0)

    @pytest.mark.parametrize("case", ["no_deadline", "deadline", "died", "raised"])
    def test_collect(self, monkeypatch, case):
        hours = iter(range(0, 10**6, 3600))
        clock = types.SimpleNamespace(monotonic=lambda: next(hours))
        monkeypatch.setattr(distributed, "time", clock)
        ok = [(1, True, "b"), (0, True, "a")]
        ranks, timeout_s, want = {
            "no_deadline": (self._Ranks(ok), None, None),
            "deadline": (self._Ranks(ok), 3600.0, "did not finish within 3600 s"),
            "died": (self._Ranks([], (None, -9)), None, "rank 1 exited with code -9"),
            "raised": (self._Ranks([(0, False, "Traceback: boom")]), None,
                       "rank 0 failed:\nTraceback: boom"),
        }[case]
        results, failure = distributed._collect(ranks.procs, ranks, timeout_s)
        if want is None:
            assert failure is None and results == {0: "a", 1: "b"} and ranks.polls > 5
        else:
            assert want in failure and results == {}

    def test_training_has_no_deadline(self, monkeypatch):
        """A training run's ranks run as long as their steps do."""
        from advoc_tpu_torch.train import harness

        calls = []
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setattr(distributed, "launch", lambda *a, **kw: calls.append(kw) or ["r"])
        args = types.SimpleNamespace(device="cpu", n_devices=2, batch_size=4)
        assert harness.launch_training(None, args) == ["r"]
        assert calls == [{"threads": max(1, torch.get_num_threads() // 2), "timeout_s": None}]


class TestHalo:
    def test_frame_local_stft_mag_matches_jax(self):
        """The shared framing + window + rfft, on a padded signal: atol 1e-5
        (two libraries' float32 FFTs, measured 7.6e-6 at a peak of 34)."""
        xp = np.random.default_rng(0).uniform(-1, 1, (2, 20 * HOP + 300)).astype(np.float32)
        for n in (None, 9):
            want = np.asarray(jsp.frame_local_stft_mag(jnp.asarray(xp), P, n))
            got = tsp.frame_local_stft_mag(torch.tensor(xp), P, n).numpy()
            assert got.shape == want.shape == (2, n or 18, 513)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_sharded_stft_matches_jax_and_unsharded(self):
        """8 shards × 32 frames: the port's sharded |STFT| against its own
        unsharded one on the first L/hop frames and JAX's sharded one, atol
        1e-5 (the same frames from the same samples; against JAX measured
        7.6e-6 at a peak of 68)."""
        length = 8 * 8192
        wav = loader.synthetic_speech(0, length)
        got = halo.sharded_stft_mag(torch.tensor(wav), cpu_mesh(8))
        assert [tuple(x.shape) for x in got] == [(32, 513)] * 8
        got = torch.cat(got)
        full = tsp.waveform_to_magspec(torch.tensor(wav))
        assert full.shape[0] == length // HOP + 1
        torch.testing.assert_close(got, full[: length // HOP], rtol=0, atol=1e-5)
        want = np.asarray(j_sharded_stft_mag(jnp.asarray(wav), jax_mesh(8)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    def test_sharded_melspec_matches_jax_and_unsharded(self):
        """The mel of the sharded magnitudes: against the port's unsharded
        mel atol 1e-5; against JAX's sharded mel atol 1e-4 in normalized dB
        (measured 3.1e-5, mean 2.9e-7: near the dB floor the two FFT
        libraries' float32 magnitudes differ most, tests/test_torch_train.py)."""
        length = 8 * 4096
        wav = loader.synthetic_speech(1, length)
        got = torch.cat(halo.sharded_melspec(torch.tensor(wav), cpu_mesh(8)))
        full = tsp.waveform_to_r9y9_melspec(torch.tensor(wav))
        torch.testing.assert_close(got, full[: length // HOP], rtol=0, atol=1e-5)
        want = np.asarray(j_sharded_melspec(jnp.asarray(wav), jax_mesh(8)))
        assert got.shape == want.shape == (length // HOP, 80)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    def test_only_halos_cross_between_shards(self, monkeypatch):
        """The shards, passed in place on their devices, exchange two halos
        per inner boundary and nothing else: 512 samples rightwards and 256
        leftwards at n_fft 1024, hop 256."""
        sent = []
        send = halo._send
        monkeypatch.setattr(halo, "_send", lambda x, dev: sent.append(x.shape[-1]) or send(x, dev))
        wav = torch.tensor(loader.synthetic_speech(2, 4 * 2048))
        shards = list(wav.reshape(4, 2048))
        out = halo.sharded_stft_mag(shards, cpu_mesh(4))
        assert sorted(sent) == [256] * 3 + [512] * 3
        torch.testing.assert_close(torch.cat(out), tsp.waveform_to_magspec(wav)[:32], rtol=0,
                                   atol=1e-5)
        with pytest.raises(ValueError, match="whole number of hops"):
            halo.sharded_stft_mag(torch.zeros(4 * 2000), cpu_mesh(4))


@pytest.fixture(scope="module")
def mel():
    wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
    return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)


@pytest.fixture(scope="module")
def gens():
    """(flax apply, flax params, port generator): a tiny float32 generator
    (tests/test_torch_vocoder.py's)."""
    kw = dict(n_frames=64, width=8, depth=4, dtype="float32")
    g = jmodel.AdvocGenerator(jmodel.AdvocConfig(**kw))
    params = jax.jit(g.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 513)))["params"]
    tcfg = AdvocConfig(**kw)
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    return (lambda p, e: g.apply({"params": p}, e)), params, tg


class TestShardedVocoder:
    @pytest.mark.parametrize("n", [8, 2])
    def test_matches_jax_and_unsharded(self, gens, mel, n):
        """A batch of 5 (padded to the mesh, cropped back) at 2 G-L
        iterations: against JAX's Vocoder(mesh=) within 1e-3 × peak (two
        float32 programs, tests/test_torch_vocoder.py's RTOL_2_ITERS), and
        against the port's unsharded call within JAX's own gate between its
        sharded and unsharded calls, atol 1e-5."""
        apply, params, tg = gens
        mels = np.stack([mel[i * 20 : i * 20 + 64] for i in range(5)])
        kw = dict(chunk_frames=64, gl_iters=2)
        want = np.asarray(JVocoder(g_apply=apply, g_params=params, params=P,
                                   mesh=jax_mesh(n), **kw)(jnp.asarray(mels)))
        voc = Vocoder(tg, mesh=cpu_mesh(n), gl_precision="highest", **kw)
        got = voc(mels)
        assert voc.device == CPU and got.shape == want.shape == (5, 64 * HOP)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())
        alone = Vocoder(tg, device="cpu", gl_precision="highest", **kw)(mels)
        torch.testing.assert_close(got, alone, rtol=0, atol=1e-5)
        assert tuple(voc(mels[0]).shape) == (64 * HOP,)  # one utterance, padded to the mesh


def _stream_mels(n_streams: int, chunks: int, ch: int) -> np.ndarray:
    out = []
    for s in range(n_streams):
        wav = jnp.asarray(loader.synthetic_speech(s, ch * chunks * HOP))
        out.append(np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))[: ch * chunks])
    return np.stack(out).reshape(n_streams, chunks, ch, P.n_mels)


class TestShardedStreaming:
    """The stream axis over 8 shards, as tests/test_parallel.py's
    TestStreamingVocoderDP drives JAX's: 8 streams, 16-frame chunks, the
    heuristic generator, gl at 4 iterations and lws_block at one sweep."""

    CH = 16

    def _kw(self, engine):
        kw = dict(chunk_frames=self.CH, n_streams=8, phase_engine=engine)
        if engine == "gl":
            return {**kw, "gl_iters": 4}
        return {**kw, "lws_look_ahead": 1, "lws_sweeps": 1}

    @pytest.mark.parametrize("engine", ["gl", "lws_block"])
    def test_matches_jax_and_unsharded(self, engine):
        """gl: the first push from a zero carry within JAX's 1e-3 gate of
        JAX's sharded engine and of the port's unsharded one; later pushes
        carry chaotic G-L phase, so the streams are held by re-extracted
        mel L1 (within 5%, JAX's own sharded-vs-unsharded bound). lws_block:
        every push within 1e-3 of both. Every shard's carries stay on its
        device."""
        mels = _stream_mels(8, 2, self.CH)
        js = JStreaming(params=P, mesh=jax_mesh(8), **self._kw(engine))
        sv = StreamingVocoder(mesh=cpu_mesh(8), **self._kw(engine))
        alone = StreamingVocoder(device="cpu", **self._kw(engine))
        outs = {"jax": [], "mesh": [], "alone": []}
        for c in range(2):
            for key, eng in (("jax", js), ("mesh", sv), ("alone", alone)):
                outs[key].append(np.asarray(eng.push(mels[:, c])))
        if engine == "lws_block":
            for c in range(2):
                np.testing.assert_allclose(outs["mesh"][c], outs["jax"][c], rtol=0, atol=1e-3)
                np.testing.assert_allclose(outs["mesh"][c], outs["alone"][c], rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(outs["mesh"][0], outs["jax"][0], rtol=0, atol=1e-3)
            np.testing.assert_allclose(outs["mesh"][0], outs["alone"][0], rtol=0, atol=1e-3)
            target = torch.tensor(mels[0].reshape(-1, P.n_mels))

            def mel_l1(key):
                w = torch.tensor(np.concatenate([o[0] for o in outs[key]]))
                m = tsp.waveform_to_r9y9_melspec(w)
                n = min(m.shape[0], target.shape[0])
                return float((m[:n] - target[:n]).abs().mean())

            l_mesh = mel_l1("mesh")
            for key in ("jax", "alone"):
                assert abs(l_mesh - mel_l1(key)) < 0.05 * mel_l1(key), (key, l_mesh, mel_l1(key))
        carries = ([s._state_wav for s in sv._shards] if engine == "gl"
                   else [s._state_lws[0] for s in sv._shards])
        assert len(carries) == 8 and all(c.shape[0] == 1 and c.device == CPU for c in carries)

    @pytest.mark.parametrize("engine", ["gl", "lws_online", "lws_block"])
    def test_masked_push_reset_and_flush(self, engine):
        """Masked rows bit-equal to the same engine's batched rows, inactive
        rows zeros; a reset stream starts afresh on its own shard; flush
        emits every stream's pending audio."""
        mels = _stream_mels(8, 2, self.CH)
        sv, ref = (StreamingVocoder(mesh=cpu_mesh(8), **self._kw(engine)) for _ in range(2))
        active = np.array([True, False] * 4)
        masked, full = sv.push(mels[:, 0], active=active), ref.push(mels[:, 0])
        np.testing.assert_array_equal(masked[active], full[active])
        np.testing.assert_array_equal(masked[~active], 0.0)
        sv.reset(stream=2)
        fresh = StreamingVocoder(device="cpu", **{**self._kw(engine), "n_streams": 1})
        np.testing.assert_array_equal(sv.push(mels[:, 1])[2], fresh.push(mels[2, 1]))
        tail = sv.flush()
        assert tail.shape == (8, sv.flush_samples) and np.isfinite(tail).all()

    def test_stream_count_must_divide_mesh(self):
        with pytest.raises(ValueError, match="divisible"):
            StreamingVocoder(n_streams=6, mesh=cpu_mesh(8))
        with pytest.raises(TypeError, match="Mesh"):
            StreamingVocoder(n_streams=8, mesh=jax_mesh(8))
