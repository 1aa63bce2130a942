"""CLI of the streaming vocoder server.

    python -m advoc_tpu_torch.serve --port 9700 --bundle runs/advoc/bundle_torch

serves a StreamingVocoder (a port bundle's generator, a training run's
latest checkpoint with ``--train_dir``, or the heuristic pipeline without
either) on the card; ``--device cpu`` runs it on the CPU.
``--selftest N`` instead starts the server, drives it with N concurrent
in-process clients through the TCP path, prints latency and batching stats
as one JSON line (``VOCODE_SERVER_RESULT {...}``) and exits; with
``--soak SECONDS`` the clients churn lease/push/flush/reset/disconnect
cycles and the line is ``VOCODE_SOAK_RESULT``. The port's copy of
``advoc_tpu.serve.cli``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch


def build_vocoder(args):
    """StreamingVocoder from the CLI flags."""
    from advoc_tpu_torch.infer.vocoder import StreamingVocoder
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P

    from advoc_tpu_torch.train.checkpoint import load_generator, load_train_generator

    generator = None
    if args.bundle:
        generator, _ = load_generator(args.bundle, args.model_size, args.model_overrides,
                                      default_size="small")
    elif args.train_dir:
        generator, _ = load_train_generator(args.train_dir, args.model_size,
                                            args.model_overrides, default_size="small")
    return StreamingVocoder(
        generator, params=P, chunk_frames=args.chunk_frames, n_streams=args.n_slots,
        gl_iters=args.gl_iters, phase_engine=args.engine,
        overlap_frames=args.overlap_frames, lws_sweeps=args.lws_sweeps,
        lws_look_ahead=args.lws_look_ahead, mel_context=args.mel_context,
        emit_dtype=args.emit_dtype, mel_dtype=args.mel_dtype,
        mel_projection=args.mel_projection, device=args.device,
    )


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (printed at startup)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the vocoder (default cuda; raises without a card)")
    p.add_argument("--n_slots", type=int, default=16,
                   help="concurrent streams = StreamingVocoder batch rows")
    p.add_argument("--coalesce_ms", type=float, default=0.0,
                   help="wait this long per tick for more clients' chunks")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="max ticks in flight (1 = serial readback; 2 "
                        "overlaps readback with the next tick's compute)")
    p.add_argument("--bundle", default=None,
                   help="port inference bundle dir (scripts/bundle_to_torch.py "
                        "converts a JAX bundle)")
    p.add_argument("--train_dir", default=None,
                   help="a training run: its latest checkpoint's generator")
    p.add_argument("--model_size", choices=["full", "small"], default=None,
                   help="default: the bundle config's model_size (a training run's "
                        "recorded config), else small")
    p.add_argument("--model_overrides", default=None,
                   help="default: the bundle config's overrides (a training run's "
                        "recorded config)")
    p.add_argument("--engine", choices=["gl", "lws_online", "lws_block"], default="gl",
                   help="phase engine: G-L with a crossfade, or streaming LWS")
    p.add_argument("--chunk_frames", type=int, default=64)
    p.add_argument("--gl_iters", type=int, default=16)
    p.add_argument("--overlap_frames", type=int, default=8,
                   help="gl engine: crossfade overlap = emission delay")
    p.add_argument("--lws_sweeps", type=int, default=None,
                   help="lws engines: sweeps per arrival (default 4 lws_block, 2 lws_online)")
    p.add_argument("--lws_look_ahead", type=int, default=2,
                   help="lws engines: frames of look-ahead (latency)")
    p.add_argument("--mel_context", type=int, default=0,
                   help="lws engines: mel frames of generator context on each side, "
                        "at as many frames of latency")
    p.add_argument("--mel_projection", type=float, default=None,
                   help="post-repair mel-consistency projection strength; "
                        "default auto (1.0 with a model, 0.0 heuristic)")
    p.add_argument("--emit_dtype", choices=["float32", "int16"], default="int16")
    p.add_argument("--mel_dtype", choices=["float32", "float16"], default="float32")
    p.add_argument("--warmup", choices=["background", "block"], default=None,
                   help="'background' (serving default): accept connections at "
                        "once and run the push/flush warmup through the server's "
                        "device queue, ahead of the first tick; 'block' "
                        "(selftest default): finish the warmup before accepting, "
                        "so the reported latencies are steady-state")
    p.add_argument("--selftest", type=int, default=0, metavar="N_CLIENTS",
                   help="start, drive with N concurrent clients, report, exit")
    p.add_argument("--pushes", type=int, default=10,
                   help="selftest: chunks per client")
    p.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                   help="selftest: instead of a fixed push count, churn "
                        "lease/push/flush/reset/disconnect cycles for this "
                        "long and check that no slot or stats leak")


def _client_mels(seed: int, n_frames: int) -> np.ndarray:
    """(n_frames, n_mels) mel of synthetic speech, featurized on the host."""
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P

    wav = synthetic_speech(seed, n_frames * P.hop_length)
    return spectral.waveform_to_r9y9_melspec(torch.tensor(wav), P)[:n_frames].numpy()


def _soak(args, handle, host, port) -> dict:
    """N client threads lease a slot, stream a random number of chunks, end
    with flush / reset / abrupt close (in turn) and reconnect, for --soak
    seconds. Checks that every slot returns to the free list, the stats add
    up, and a full house still serves afterwards."""
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.serve.client import VocodeClient

    n, ch = args.selftest, args.chunk_frames
    deadline = time.time() + args.soak
    counts = {"cycles": 0, "pushes": 0, "flushes": 0, "rejected": 0}
    lock = threading.Lock()
    errors: list[str] = []

    def churn(i: int) -> None:
        rng = np.random.default_rng(i)
        mel = _client_mels(i, 8 * ch)
        while time.time() < deadline:
            try:
                c = VocodeClient(host, port)
            except ConnectionError:  # pool full: the overload path
                with lock:
                    counts["rejected"] += 1
                time.sleep(0.01)
                continue
            try:
                for j in range(int(rng.integers(1, 5))):
                    out = c.vocode(mel[j * ch : (j + 1) * ch])
                    assert out.shape == (c.config["emit_samples"],)
                    with lock:
                        counts["pushes"] += 1
                with lock:
                    ending = counts["cycles"] % 3
                if ending == 0:
                    tail = c.flush()
                    assert tail.shape == (c.config["flush_samples"],)
                    with lock:
                        counts["flushes"] += 1
                    c.close()
                elif ending == 1:
                    c.reset()
                    c.close()
                else:  # abrupt close, no BYE
                    c._sock.close()
                with lock:
                    counts["cycles"] += 1
            except Exception as e:  # noqa: BLE001 — the soak reports every failure
                with lock:
                    errors.append(repr(e))
                c._sock.close()

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(n)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    # Every lease is released; frees apply on the next tick, so poll briefly.
    end = time.time() + 10
    while time.time() < end and len(handle.server._free) < args.n_slots:
        time.sleep(0.05)
    stats = handle.server.stats
    snap = {
        "server_pushes": stats.pushes,
        "server_flushes": stats.flushes,
        "server_connections": stats.connections,
        "free_slots_after": len(handle.server._free),
    }
    ok = (not errors and snap["free_slots_after"] == args.n_slots
          and snap["server_pushes"] == counts["pushes"]
          and snap["server_flushes"] == counts["flushes"])
    clients = []
    try:  # and a full house still serves
        for _ in range(args.n_slots):
            clients.append(VocodeClient(host, port))
        for c in clients:
            c.vocode(np.zeros((ch, P.n_mels), np.float32))
    except Exception as e:  # noqa: BLE001
        ok = False
        errors.append(f"post-soak lease: {e!r}")
    finally:
        for c in clients:
            c.close()
    return {"ok": ok, "soak_s": round(wall, 1), "clients": n, "n_slots": args.n_slots,
            **counts, **snap, "errors": errors[:5]}


def _selftest(args, handle, host, port) -> dict:
    """N concurrent clients through the TCP path, ``--pushes`` chunks and a
    flush each. p50/p95 cover every push but each client's first (as the
    JAX CLI's do); ``p95_all_ms`` covers every push."""
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.serve.client import VocodeClient

    n, ch = args.selftest, args.chunk_frames
    need = ch * args.pushes
    lat_ms: list[list[float]] = [[] for _ in range(n)]
    mels = [_client_mels(i, need) for i in range(n)]

    def run_client(i: int) -> None:
        with VocodeClient(host, port) as c:
            for k in range(args.pushes):
                t0 = time.perf_counter()
                out = c.vocode(mels[i][k * ch : (k + 1) * ch])
                lat_ms[i].append((time.perf_counter() - t0) * 1000.0)
                assert out.shape == (c.config["emit_samples"],)
            tail = c.flush()  # the engine's pending tail
            assert tail.shape == (c.config["flush_samples"],)

    threads = [threading.Thread(target=run_client, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if any(len(m) != args.pushes for m in lat_ms):
        raise RuntimeError("a selftest client failed (its traceback is above)")
    lat = np.asarray([m for c in lat_ms for m in c[1:]])  # each client's first push aside
    lat_all = np.asarray([m for c in lat_ms for m in c])
    stats = handle.server.stats
    audio_s = n * args.pushes * ch * P.hop_length / P.sample_rate
    return {
        "n_clients": n, "pushes": args.pushes, "chunk_frames": ch, "engine": args.engine,
        "device": str(handle.server.sv.device),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p95_all_ms": round(float(np.percentile(lat_all, 95)), 2),
        "ticks": stats.ticks,
        "mean_streams_per_tick": round(stats.mean_streams_per_tick, 2),
        "wall_s": round(wall, 2),
        "aggregate_rtf": round(audio_s / wall, 1),
    }


def main(argv=None) -> dict | None:
    """Serve until interrupted, or run the selftest or soak and return its
    result (also printed as one JSON line)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_args(p)
    args = p.parse_args(argv)

    from advoc_tpu_torch.serve.server import start_in_thread

    warmup = args.warmup or ("block" if args.selftest else "background")
    t_start = time.perf_counter()
    sv = build_vocoder(args)  # raises without the device it asks for
    t_build = time.perf_counter() - t_start

    def do_warmup() -> None:
        # All-inactive pushes leave every carry untouched bit-exactly, so the
        # warmup may run just ahead of real traffic. readback waits for the
        # card.
        t0 = time.perf_counter()
        sv.push(np.zeros((args.n_slots, args.chunk_frames, sv.params.n_mels), sv.mel_dtype),
                active=np.zeros(args.n_slots, bool))
        t_push = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv.flush(active=np.zeros(args.n_slots, bool))
        t_flush = time.perf_counter() - t0
        print(f"warmup: {t_push + t_flush:.1f} s (build {t_build:.1f}, device init "
              f"included; push {t_push:.1f}; flush {t_flush:.1f})", flush=True)

    if warmup == "block":
        do_warmup()
    handle = start_in_thread(sv, host=args.host, port=args.port,
                             coalesce_ms=args.coalesce_ms,
                             pipeline_depth=args.pipeline_depth)
    host, port = handle.address
    if warmup == "background":
        # Through the server's single-worker device pool: FIFO, so the
        # warmup runs before any tick that queues behind it.
        handle.server._pool.submit(do_warmup)
    print(f"serving {args.n_slots} slots on {host}:{port} (engine={args.engine}, "
          f"device={sv.device}, warmup={warmup}, accepting after "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    if not args.selftest:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            handle.stop()
        return None
    try:
        if args.soak:
            result = _soak(args, handle, host, port)
            print("VOCODE_SOAK_RESULT " + json.dumps(result), flush=True)
            if not result["ok"]:
                raise SystemExit(1)
        else:
            result = _selftest(args, handle, host, port)
            print("VOCODE_SERVER_RESULT " + json.dumps(result), flush=True)
    finally:
        handle.stop()
    return result


if __name__ == "__main__":
    main()
