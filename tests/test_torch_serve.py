"""The port's TCP serving layer on the CPU: protocol, slot multiplexing,
batched ticks, recovery, and the CLI.

As in tests/test_serve.py, the backbone is the masked-push contract: a
client's stream through the server equals, bit for bit, one-hot masked
pushes on an identical StreamingVocoder, whatever ticks the server's racing
clients happen to form. The wire format is shared with the JAX package:
clients of either package are run against servers of the other.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from advoc_tpu_torch.data.synthetic import synthetic_speech
from advoc_tpu_torch.infer import StreamingVocoder
from advoc_tpu_torch.ops import spectral as sp
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.serve import VocodeClient, start_in_thread
from advoc_tpu_torch.serve import protocol as pr

CH = 16


def make_sv(n_slots, **kw):
    kw.setdefault("gl_iters", 4)
    return StreamingVocoder(params=P, chunk_frames=CH, n_streams=n_slots, device="cpu", **kw)


def mel_chunks(chunks, seed=0):
    wav = synthetic_speech(seed, CH * chunks * P.hop_length)
    m = sp.waveform_to_r9y9_melspec(torch.tensor(wav), P)[: CH * chunks]
    return m.numpy().reshape(chunks, CH, P.n_mels)


def ref_stream(sv_ref, slot, mels):
    """Direct one-hot masked pushes: the grouping-invariant reference."""
    n = sv_ref.n_streams
    active = np.arange(n) == slot
    outs = []
    for m in mels:
        batch = np.zeros((n, CH, P.n_mels), np.float32)
        batch[slot] = m
        outs.append(sv_ref.push(batch, active=active)[slot])
    return outs


def lease_all(host, port, n, deadline_s=10.0):
    """Lease n slots, retrying while freed slots drain back."""
    deadline = time.time() + deadline_s
    clients = []
    while time.time() < deadline and len(clients) < n:
        try:
            clients.append(VocodeClient(host, port))
        except ConnectionError:
            time.sleep(0.05)
    assert len(clients) == n
    return clients


@pytest.fixture()
def served():
    """A 4-slot heuristic server and an identical reference vocoder."""
    handle = start_in_thread(make_sv(4), coalesce_ms=10.0)
    yield handle, make_sv(4)
    handle.stop()


class TestVocodeServer:
    def test_roundtrip_matches_direct_push(self, served):
        handle, sv_ref = served
        mels = mel_chunks(3)
        with VocodeClient(*handle.address) as c:
            got = [c.vocode(m) for m in mels]
            assert got[0].shape == (c.config["emit_samples"],) and got[0].dtype == np.float32
            ref = ref_stream(sv_ref, c.slot, mels)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)

    def test_concurrent_clients_are_isolated_and_batched(self, served):
        handle, sv_ref = served
        n_cli, pushes = 4, 3
        all_mels = [mel_chunks(pushes, seed=i) for i in range(n_cli)]
        results: list = [None] * n_cli
        barrier = threading.Barrier(n_cli, timeout=60)

        def client(i):
            with VocodeClient(*handle.address) as c:
                outs = []
                for k in range(pushes):
                    barrier.wait()  # so that ticks must multiplex slots
                    outs.append(c.vocode(all_mels[i][k]))
                results[i] = (c.slot, outs)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_cli)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len({r[0] for r in results}) == n_cli  # distinct leases
        for slot, outs in results:
            i = next(j for j in range(n_cli) if results[j][0] == slot)
            for g, r in zip(outs, ref_stream(sv_ref, slot, all_mels[i])):
                np.testing.assert_array_equal(g, r)
        stats = handle.server.stats
        assert stats.pushes == n_cli * pushes
        assert stats.ticks < stats.pushes, (stats.ticks, stats.pushes)

    def test_flush_drains_and_resets(self, served):
        handle, sv_ref = served
        mels = mel_chunks(2)
        with VocodeClient(*handle.address) as c:
            outs = [c.vocode(m) for m in mels]
            tail = c.flush()
            assert tail.shape == (c.config["flush_samples"],)
            for g, r in zip(outs, ref_stream(sv_ref, c.slot, mels)):
                np.testing.assert_array_equal(g, r)
            ref_tail = sv_ref.flush(active=np.arange(4) == c.slot)[c.slot]
            np.testing.assert_array_equal(tail, ref_tail)
            np.testing.assert_array_equal(c.vocode(mels[0]),
                                          ref_stream(sv_ref, c.slot, mels[:1])[0])
        assert handle.server.stats.flushes == 1

    def test_reset_starts_fresh_utterance(self, served):
        handle, _ = served
        mels = mel_chunks(2)
        with VocodeClient(*handle.address) as c:
            first = c.vocode(mels[0])
            c.vocode(mels[1])
            c.reset()
            np.testing.assert_array_equal(c.vocode(mels[0]), first)

    def test_slot_freed_and_carry_cleared_on_disconnect(self, served):
        handle, _ = served
        mels = mel_chunks(2)
        with VocodeClient(*handle.address) as c1:
            slot1 = c1.slot
            first = c1.vocode(mels[0])
            c1.vocode(mels[1])
        clients = lease_all(*handle.address, 4)
        try:
            c2 = next(c for c in clients if c.slot == slot1)
            np.testing.assert_array_equal(c2.vocode(mels[0]), first)
        finally:
            for c in clients:
                c.close()

    def test_server_full_rejected(self):
        handle = start_in_thread(make_sv(1))
        try:
            c1 = VocodeClient(*handle.address)
            with pytest.raises(ConnectionError, match="server full"):
                VocodeClient(*handle.address)
            c1.close()
        finally:
            handle.stop()

    @pytest.mark.parametrize("stage", ["dispatch", "readback"])
    def test_device_failure_propagates_and_resets(self, stage):
        """A push that fails (at dispatch, or when its emit is read back)
        reaches the waiting client as an ERR frame; the server resets every
        carry and keeps serving fresh streams."""
        sv = make_sv(2)
        real_push = sv.push
        calls = {"n": 0}

        class _PoisonEmit:
            def cpu(self):
                raise RuntimeError("injected readback failure")

        def flaky_push(mels, active=None, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                if stage == "dispatch":
                    raise RuntimeError("injected dispatch failure")
                real_push(mels, active=active, **kw)
                return _PoisonEmit()
            return real_push(mels, active=active, **kw)

        sv.push = flaky_push
        handle = start_in_thread(sv)
        mels = mel_chunks(2)
        try:
            with VocodeClient(*handle.address) as c:
                c.vocode(mels[0])
                with pytest.raises(RuntimeError, match=f"injected {stage}"):
                    c.vocode(mels[1])
            with VocodeClient(*handle.address) as c:
                out = c.vocode(mels[0])
                np.testing.assert_array_equal(out, ref_stream(make_sv(2), c.slot, mels[:1])[0])
        finally:
            handle.stop()

    def test_stop_with_connected_client_returns_promptly(self):
        handle = start_in_thread(make_sv(2))
        c = VocodeClient(*handle.address)
        c.vocode(mel_chunks(1)[0])
        t0 = time.time()
        handle.stop()
        assert time.time() - t0 < 10.0
        with pytest.raises((ConnectionError, OSError)):
            c.vocode(mel_chunks(1)[0])
        c._sock.close()

    def test_bad_payload_gets_error_frame(self, served):
        handle, _ = served
        s = socket.create_connection(handle.address, timeout=30)
        try:
            op, _ = pr.read_frame_sync(s)
            assert op == pr.OP_CONFIG
            s.sendall(pr.pack(pr.OP_PUSH, b"not a mel chunk"))
            op, payload = pr.read_frame_sync(s)
            assert op == pr.OP_ERR and b"payload must be" in payload
        finally:
            s.close()

    def test_churn_no_slot_or_stats_leak(self):
        n_slots, rounds = 3, 4
        handle = start_in_thread(make_sv(n_slots))
        mels = mel_chunks(2)
        pushes = flushes = 0
        try:
            for _ in range(rounds):
                clients = lease_all(*handle.address, n_slots)
                for i, c in enumerate(clients):
                    c.vocode(mels[0])
                    pushes += 1
                    if i % 2 == 0:
                        assert c.flush().shape == (c.config["flush_samples"],)
                        flushes += 1
                    else:
                        c.reset()
                for c in clients:
                    c.close()
            clients = lease_all(*handle.address, n_slots)
            assert sorted(c.slot for c in clients) == list(range(n_slots))
            for c in clients:
                c.close()
            stats = handle.server.stats
            assert (stats.pushes, stats.flushes) == (pushes, flushes)
            assert stats.connections == (rounds + 1) * n_slots
        finally:
            handle.stop()


class TestWireFormatAcrossPackages:
    """The same protocol in both packages: a JAX client on a port server
    and a port client on a JAX server."""

    def test_jax_client_on_port_server(self, served):
        from advoc_tpu.serve import VocodeClient as JaxClient

        handle, sv_ref = served
        mels = mel_chunks(2)
        with JaxClient(*handle.address) as c:
            assert c.config["phase_engine"] == "gl" and c.config["n_slots"] == 4
            got = [c.vocode(m) for m in mels]
            tail = c.flush()
            ref = ref_stream(sv_ref, c.slot, mels)
            ref_tail = sv_ref.flush(active=np.arange(4) == c.slot)[c.slot]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(tail, ref_tail)

    def test_port_client_on_jax_server(self):
        from advoc_tpu.infer import StreamingVocoder as JaxStreaming
        from advoc_tpu.serve import start_in_thread as jax_start

        def jax_sv():
            return JaxStreaming(params=P, chunk_frames=CH, n_streams=2, gl_iters=2,
                                emit_dtype="int16")

        handle = jax_start(jax_sv())
        mels = mel_chunks(2)
        try:
            with VocodeClient(*handle.address) as c:
                assert c.config["emit_dtype"] == "int16"
                got = [c.vocode(m) for m in mels]
                ref_sv = jax_sv()
                onehot = np.arange(2) == c.slot
                for m, g in zip(mels, got):
                    batch = np.zeros((2, CH, P.n_mels), np.float32)
                    batch[c.slot] = m
                    np.testing.assert_array_equal(g, ref_sv.push(batch, active=onehot)[c.slot])
        finally:
            handle.stop()


@pytest.mark.parametrize("engine", ["lws_block", "lws_online"])
class TestVocodeServerLWS:
    def test_roundtrip_and_exact_length(self, engine):
        """A client's pushes and flush through an lws engine equal direct
        one-hot masked pushes bit for bit; CONFIG tells the client the
        engine's preroll, latency and flush, and dropping flush_samples
        leaves exactly T·hop samples."""
        kw = dict(phase_engine=engine, lws_look_ahead=1, lws_sweeps=1)
        handle = start_in_thread(make_sv(2, **kw))
        try:
            mels = mel_chunks(3)
            with VocodeClient(*handle.address) as c:
                cfg = c.config
                assert (cfg["phase_engine"], cfg["preroll_samples"], cfg["latency_frames"]) == (
                    engine, P.n_fft // 2, 1)
                got = [c.vocode(m) for m in mels]
                tail = c.flush()
                sv_ref = make_sv(2, **kw)
                ref = ref_stream(sv_ref, c.slot, mels)
                ref_tail = sv_ref.flush(active=np.arange(2) == c.slot)[c.slot]
        finally:
            handle.stop()
        for g, r in zip(got + [tail], ref + [ref_tail]):
            np.testing.assert_array_equal(g, r)
        assert tail.shape == (cfg["flush_samples"],)
        sig = np.concatenate(got + [tail])[cfg["flush_samples"] :]
        assert sig.shape == (3 * CH * P.hop_length,)


def _result(out: str, tag: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith(tag + " "))
    return json.loads(line.split(" ", 1)[1])


class TestServerCLI:
    ARGS = ["--device", "cpu", "--n_slots", "2", "--chunk_frames", str(CH), "--gl_iters", "2"]

    def test_selftest(self, capsys):
        from advoc_tpu_torch.serve.cli import main

        r = main(["--selftest", "2", "--pushes", "3"] + self.ARGS)
        assert r == _result(capsys.readouterr().out, "VOCODE_SERVER_RESULT")
        assert r["n_clients"] == 2 and r["ticks"] >= 1 and r["p50_ms"] > 0
        assert r["p95_all_ms"] > 0 and r["device"] == "cpu"

    def test_background_warmup(self, capsys):
        from advoc_tpu_torch.serve.cli import main

        r = main(["--selftest", "2", "--pushes", "2", "--warmup", "background"] + self.ARGS)
        out = capsys.readouterr().out
        assert "warmup=background" in out and "warmup:" in out
        assert r["n_clients"] == 2

    def test_soak(self, capsys):
        from advoc_tpu_torch.serve.cli import main

        r = main(["--selftest", "3", "--soak", "1.0"] + self.ARGS)
        assert r == _result(capsys.readouterr().out, "VOCODE_SOAK_RESULT")
        assert r["ok"] and r["free_slots_after"] == 2 and r["cycles"] > 0

    def test_selftest_from_a_port_bundle(self, tmp_path, capsys):
        """build_vocoder's bundle branch: small_config with --model_overrides."""
        from advoc_tpu_torch.models.advoc import AdvocGenerator
        from advoc_tpu_torch.models.advoc.model import small_config
        from advoc_tpu_torch.serve.cli import main
        from advoc_tpu_torch.train.checkpoint import export_inference_bundle
        from advoc_tpu_torch.utils import apply_overrides

        tiny = "width=8,depth=4,n_frames=16,dtype=float32"
        g = AdvocGenerator(apply_overrides(small_config(), tiny))
        g.reset_parameters(torch.Generator().manual_seed(0))
        export_inference_bundle(tmp_path / "bundle", g.state_dict(), {"width": 8})
        r = main(["--selftest", "1", "--pushes", "2", "--bundle", str(tmp_path / "bundle"),
                  "--model_overrides", tiny] + self.ARGS)
        assert r["n_clients"] == 1 and r["ticks"] >= 1

    @pytest.mark.parametrize("engine", ["lws_block", "lws_online"])
    def test_selftest_lws_engines(self, capsys, engine):
        from advoc_tpu_torch.serve.cli import main

        r = main(["--selftest", "2", "--pushes", "2", "--engine", engine, "--lws_sweeps", "1",
                  "--lws_look_ahead", "1"] + self.ARGS)
        assert r == _result(capsys.readouterr().out, "VOCODE_SERVER_RESULT")
        assert r["engine"] == engine and r["n_clients"] == 2 and r["p50_ms"] > 0

    def test_lws_flags_reach_the_engine(self):
        import argparse

        from advoc_tpu_torch.serve.cli import add_args, build_vocoder

        p = argparse.ArgumentParser()
        add_args(p)
        args = p.parse_args(self.ARGS)
        assert (args.lws_sweeps, args.lws_look_ahead, args.mel_context) == (None, 2, 0)
        sv = build_vocoder(p.parse_args(self.ARGS + ["--engine", "lws_block"]))
        assert (sv.phase_engine, sv.lws_sweeps, sv.lws_look_ahead) == ("lws_block", 4, 2)
        sv = build_vocoder(p.parse_args(self.ARGS + [
            "--engine", "lws_online", "--lws_sweeps", "3", "--lws_look_ahead", "1",
            "--mel_context", "4"]))
        assert (sv.lws_sweeps, sv.lws_look_ahead, sv.mel_context, sv.latency_frames) == (3, 1, 4, 5)

    @pytest.mark.parametrize("extra", [["--train_dir", "x"],
                                       ["--engine", "lws_block", "--mel_context", str(CH + 1)],
                                       ["--mel_context", "2"]])
    def test_unported_options_raise(self, extra, tmp_path):
        """--train_dir, --engine lws_* and --mel_context, which raised
        NotImplementedError before, run now (tests/test_torch_train_cli.py,
        test_selftest_lws_engines): --train_dir on a directory without a
        checkpoint raises FileNotFoundError, and the other cases hold the JAX
        package's ValueErrors, a mel_context past the chunk and mel_context
        on the gl engine."""
        from advoc_tpu_torch.serve.cli import main

        if "--train_dir" in extra:
            with pytest.raises(FileNotFoundError, match="no checkpoint"):
                main(["--selftest", "1"] + self.ARGS + ["--train_dir", str(tmp_path / "run")])
            return
        with pytest.raises(ValueError, match="mel_context"):
            main(["--selftest", "1"] + self.ARGS + extra)

    def test_default_device_needs_cuda(self, monkeypatch):
        from advoc_tpu_torch.serve.cli import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--selftest", "1", "--n_slots", "1"])
