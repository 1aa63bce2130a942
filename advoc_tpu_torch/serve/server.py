"""Streaming vocoder server: N TCP clients → ONE batched StreamingVocoder.

The port's ``advoc_tpu.serve.server``, with the same wire format and the
same design. The card wants one fixed-shape push per tick with as many
streams as possible in its batch, so the server is a slot multiplexer:
each connection leases one row of a ``StreamingVocoder(n_streams=n_slots)``,
one batching loop folds whatever chunks are pending into one
``push(batch, active=mask)`` (masked rows keep their carry bit-exactly),
and each client gets back its own row. All vocoder access runs on one
device thread; connection handling stays on the asyncio loop.

Ticks are pipelined: the device thread enqueues tick N's kernels and
returns its emit as a CUDA tensor without waiting (``push(...,
readback=False)``); a second single-thread stage reads it back with
``.cpu().numpy()`` and resolves the clients' futures, in tick order, while
the batch loop already collects and dispatches tick N+1. Both threads use
the card's default stream, so a readback waits for exactly the work queued
before it. The depth is bounded (``pipeline_depth``, default 2): every
tick in flight costs a whole fixed-shape push however few rows are active.
Each connection has at most one outstanding request, and the readback
stage is FIFO, so per-slot order holds.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading
from dataclasses import dataclass

import numpy as np

from advoc_tpu_torch.serve import protocol as pr


@dataclass
class _Request:
    kind: str  # "push" | "flush" | "reset" | "free"
    slot: int
    mel: np.ndarray | None = None
    fut: asyncio.Future | None = None


@dataclass
class ServerStats:
    connections: int = 0
    pushes: int = 0
    flushes: int = 0
    ticks: int = 0

    @property
    def mean_streams_per_tick(self) -> float:
        return self.pushes / self.ticks if self.ticks else 0.0


class VocoderServer:
    """Serve a :class:`StreamingVocoder` over TCP (see module docstring).

    ``coalesce_ms``: after the first pending chunk of a tick arrives, wait
    this long for other clients' chunks to join the batch — the throughput/
    latency knob (0 = push immediately, each tick carries whatever is
    already queued; concurrent clients still coalesce naturally while a
    previous tick's device call is in flight).

    ``pipeline_depth``: max ticks in flight (dispatched, not yet read
    back). 1 = the serial dispatch→compute→readback loop; 2 (default)
    overlaps one tick's readback with the next tick's compute. See the
    module docstring for why this must stay small.

    A failed push or readback fails that tick's requests with an ERR frame
    and resets every stream's carry on the device thread; the server goes
    on serving.
    """

    def __init__(
        self,
        sv,
        host: str = "127.0.0.1",
        port: int = 0,
        coalesce_ms: float = 0.0,
        pipeline_depth: int = 2,
    ):
        self.sv = sv
        self.host, self.port = host, port
        self.coalesce_ms = coalesce_ms
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._tick_slots: asyncio.Semaphore | None = None  # made on the loop
        self.stats = ServerStats()
        self._free: list[int] = list(range(sv.n_streams))[::-1]
        self._writers: set[asyncio.StreamWriter] = set()
        self._queue: asyncio.Queue[_Request] = asyncio.Queue()
        self._server: asyncio.AbstractServer | None = None
        self._batch_task: asyncio.Task | None = None
        # One worker: all sv (device) access happens on this thread.
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # Second pipeline stage: readback of already-dispatched emits (reads
        # only; never touches sv state). Single worker → FIFO → ticks
        # resolve in dispatch order.
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1
        )
        # task → that tick's (batch, flushes): stop() needs the requests
        # even if it cancels a task before the task body ever ran.
        self._readbacks: dict[asyncio.Task, tuple[dict, dict]] = {}
        p = sv.params
        emit = sv.chunk * p.hop_length  # uniform across engines
        self._config = {
            "n_slots": sv.n_streams,
            "chunk_frames": sv.chunk,
            "n_mels": p.n_mels,
            "mel_dtype": np.dtype(sv.mel_dtype).name,
            "emit_dtype": np.dtype(sv.emit_dtype).name,
            "emit_samples": emit,
            "sample_rate": p.sample_rate,
            "hop_length": p.hop_length,
            "phase_engine": sv.phase_engine,
            "preroll_samples": sv.preroll_samples,
            "latency_frames": sv.latency_frames,
            "flush_samples": sv.flush_samples,
        }
        self._chunk_bytes = (
            sv.chunk * p.n_mels * np.dtype(sv.mel_dtype).itemsize
        )

    @property
    def address(self) -> tuple[str, int]:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[:2]

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self._batch_task = asyncio.get_running_loop().create_task(
            self._batch_loop()
        )

    async def stop(self) -> None:
        """Shut down promptly even with connected clients / in-flight work:
        stop accepting, cancel the batch loop (it fails its in-flight
        batch's futures on the way out), fail anything still queued, close
        every live connection, then wait for handlers (3.12's wait_closed
        blocks until handlers finish — which they can't while parked on
        futures nobody will resolve, hence the ordering above)."""
        if self._server is not None:
            self._server.close()
        if self._batch_task is not None:
            self._batch_task.cancel()
            try:
                await self._batch_task
            except asyncio.CancelledError:
                pass
        # In-flight readbacks: cancel the tasks AND their ticks' client
        # futures (a task cancelled before its body ever ran can't do the
        # latter itself), so parked handlers unblock.
        inflight = list(self._readbacks.items())
        for t, _ in inflight:
            t.cancel()
        if inflight:
            await asyncio.gather(
                *(t for t, _ in inflight), return_exceptions=True
            )
        for _, (b, f) in inflight:
            for req in list(b.values()) + list(f.values()):
                if not req.fut.done():
                    req.fut.cancel()
        while not self._queue.empty():
            req = self._queue.get_nowait()
            if req.fut is not None and not req.fut.done():
                req.fut.cancel()
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()
        self._pool.shutdown(wait=True)
        # The fetch pool may still be mid-readback; its tasks' client futures
        # were cancelled above, so stop() does not wait on it: it only reads.
        self._fetch_pool.shutdown(wait=False, cancel_futures=True)

    # --- batching core -------------------------------------------------
    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        sv = self.sv
        n, ch = sv.n_streams, sv.chunk
        mel_dt = np.dtype(sv.mel_dtype)
        self._tick_slots = asyncio.Semaphore(self.pipeline_depth)
        while True:
            batch: dict[int, _Request] = {}
            flushes: dict[int, _Request] = {}
            resets: list[int] = []

            def waiting():
                return list(batch.values()) + list(flushes.values())

            def take(req: _Request) -> bool:
                # A slot's handler never pipelines requests, so at most one
                # replied-to request (push OR flush) per slot per tick holds
                # by construction; a push/flush after a queued reset of the
                # same slot stays ordered because resets apply before the
                # tick's device calls.
                if req.kind == "push":
                    batch[req.slot] = req
                elif req.kind == "flush":
                    flushes[req.slot] = req
                else:  # "reset" and "free" both zero the slot's carry
                    resets.append(req.slot)
                    if req.kind == "free":
                        self._free.append(req.slot)
                return True

            try:
                take(await self._queue.get())
                while not self._queue.empty():
                    take(self._queue.get_nowait())
                if self.coalesce_ms and batch:
                    await asyncio.sleep(self.coalesce_ms / 1000.0)
                    while not self._queue.empty():
                        take(self._queue.get_nowait())
            except asyncio.CancelledError:
                for req in waiting():
                    if not req.fut.done():
                        req.fut.cancel()
                raise

            # Backpressure: wait for a pipeline slot, then let anything
            # that queued up meanwhile join THIS tick's batch — this is
            # what keeps ticks full when the device is the bottleneck.
            try:
                await self._tick_slots.acquire()
            except asyncio.CancelledError:
                for req in waiting():
                    if not req.fut.done():
                        req.fut.cancel()
                raise
            while not self._queue.empty():
                take(self._queue.get_nowait())

            def device_dispatch():
                # Stage 1: enqueue the tick's device work; returns the emits
                # as device tensors without waiting (readback=False). The sv
                # carries are replaced here, so the next tick can dispatch
                # against them immediately.
                for s in resets:
                    sv.reset(stream=s)
                emit_push = emit_flush = None
                if batch:
                    mels = np.zeros((n, ch, self._config["n_mels"]), mel_dt)
                    active = np.zeros(n, bool)
                    for s, req in batch.items():
                        mels[s], active[s] = req.mel, True
                    emit_push = sv.push(mels, active=active, readback=False)
                if flushes:
                    fmask = np.zeros(n, bool)
                    for s in flushes:
                        fmask[s] = True
                    emit_flush = sv.flush(active=fmask, readback=False)
                return emit_push, emit_flush

            try:
                emit_d, emit_f_d = await loop.run_in_executor(
                    self._pool, device_dispatch
                )
            except asyncio.CancelledError:  # server stopping mid-tick
                self._tick_slots.release()
                for req in waiting():
                    if not req.fut.done():
                        req.fut.cancel()
                raise
            except Exception as e:  # propagate to the waiting clients
                self._tick_slots.release()
                for req in waiting():
                    if not req.fut.done():
                        req.fut.set_exception(
                            RuntimeError(f"vocode failed: {e!r}")
                        )
                # Same poisoned-carry recovery as the readback path.
                print(f"[serve] device failure at dispatch: {e!r}; "
                      "resetting vocoder state", flush=True)
                loop.run_in_executor(self._pool, sv.reset)
                continue
            if batch or flushes:
                self.stats.ticks += 1
                self.stats.pushes += len(batch)
                self.stats.flushes += len(flushes)
                # Stage 2, NOT awaited here: the loop goes straight back to
                # collecting the next tick while this tick's samples
                # materialize on the fetch thread. The readback releases
                # the pipeline slot when it resolves.
                t = loop.create_task(
                    self._readback(emit_d, emit_f_d, batch, flushes)
                )
                self._readbacks[t] = (batch, flushes)
                t.add_done_callback(
                    lambda t: self._readbacks.pop(t, None)
                )
            else:  # reset/free-only tick: nothing to read back
                self._tick_slots.release()

    async def _readback(self, emit_d, emit_f_d, batch, flushes) -> None:
        """Pipeline stage 2: read back one tick's emits (FIFO fetch thread;
        ``.cpu()`` waits for the tick's kernels), then resolve that tick's
        client futures."""
        loop = asyncio.get_running_loop()

        def fetch():
            emit = None if emit_d is None else emit_d.cpu().numpy()
            emit_f = (
                None if emit_f_d is None
                else np.atleast_2d(emit_f_d.cpu().numpy())
            )
            return emit, emit_f

        def all_reqs():
            return list(batch.values()) + list(flushes.values())

        try:
            emit, emit_f = await loop.run_in_executor(self._fetch_pool, fetch)
        except asyncio.CancelledError:  # server stopping mid-readback
            for req in all_reqs():
                if not req.fut.done():
                    req.fut.cancel()
            raise
        except Exception as e:  # a device failure surfaces at readback
            for req in all_reqs():
                if not req.fut.done():
                    req.fut.set_exception(
                        RuntimeError(f"vocode failed: {e!r}")
                    )
            # The carries computed by the failed tick are suspect and would
            # poison every later tick: log once and reset ALL carry state on
            # the device thread (which serializes sv access), so later ticks
            # start from clean streams.
            print(f"[serve] device failure at readback: {e!r}; "
                  "resetting vocoder state", flush=True)
            loop.run_in_executor(self._pool, self.sv.reset)
            return
        finally:
            self._tick_slots.release()
        for s, req in batch.items():
            if not req.fut.done():
                req.fut.set_result(np.ascontiguousarray(emit[s]))
        for s, req in flushes.items():
            if not req.fut.done():
                req.fut.set_result(np.ascontiguousarray(emit_f[s]))

    # --- per-connection handler -----------------------------------------
    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        loop = asyncio.get_running_loop()
        if not self._free:
            writer.write(pr.pack(pr.OP_ERR, b"server full: no free slot"))
            await writer.drain()
            writer.close()
            return
        slot = self._free.pop()
        self.stats.connections += 1
        self._writers.add(writer)
        writer.write(
            pr.pack(
                pr.OP_CONFIG,
                json.dumps(dict(self._config, slot=slot)).encode(),
            )
        )
        await writer.drain()
        try:
            while True:
                try:
                    op, payload = await pr.read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if op == pr.OP_BYE:
                    break
                if op == pr.OP_RESET:
                    await self._queue.put(_Request("reset", slot))
                    continue
                if op == pr.OP_FLUSH:
                    fut = loop.create_future()
                    await self._queue.put(_Request("flush", slot, None, fut))
                    try:
                        out = await fut
                    except RuntimeError as e:
                        writer.write(pr.pack(pr.OP_ERR, str(e).encode()))
                        await writer.drain()
                        break
                    except asyncio.CancelledError:
                        break  # server shutting down: exit cleanly
                    writer.write(pr.pack(pr.OP_PCM, out.tobytes()))
                    await writer.drain()
                    continue
                if op != pr.OP_PUSH:
                    writer.write(pr.pack(pr.OP_ERR, f"bad op {op}".encode()))
                    await writer.drain()
                    break
                if len(payload) != self._chunk_bytes:
                    writer.write(pr.pack(
                        pr.OP_ERR,
                        f"push payload must be {self._chunk_bytes} bytes "
                        f"({self._config['chunk_frames']}x"
                        f"{self._config['n_mels']} "
                        f"{self._config['mel_dtype']}), "
                        f"got {len(payload)}".encode(),
                    ))
                    await writer.drain()
                    break
                mel = np.frombuffer(payload, np.dtype(
                    self._config["mel_dtype"]
                )).reshape(
                    self._config["chunk_frames"], self._config["n_mels"]
                )
                fut = loop.create_future()
                await self._queue.put(_Request("push", slot, mel, fut))
                try:
                    out = await fut
                except RuntimeError as e:
                    writer.write(pr.pack(pr.OP_ERR, str(e).encode()))
                    await writer.drain()
                    break
                except asyncio.CancelledError:
                    break  # server shutting down: exit cleanly
                writer.write(pr.pack(pr.OP_PCM, out.tobytes()))
                await writer.drain()
        except OSError:
            pass  # abrupt client disconnect mid-write: clean up silently
        finally:
            self._writers.discard(writer)
            # Zero the slot's carry before releasing it so the next lease
            # starts a fresh utterance; "free" re-lists the slot only after
            # any in-flight tick (queue FIFO → applied on the next tick).
            await self._queue.put(_Request("free", slot))
            writer.close()


class ServerHandle:
    """A VocoderServer running on a background event loop (tests, CLIs)."""

    def __init__(self, server: VocoderServer, loop, thread):
        self.server = server
        self._loop = loop
        self._thread = thread

    @property
    def address(self) -> tuple[str, int]:
        return self.server.address

    def stop(self, timeout: float = 120.0) -> None:
        # stop() can sit behind an in-flight device dispatch.
        asyncio.run_coroutine_threadsafe(
            self.server.stop(), self._loop
        ).result(timeout=timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)


def start_in_thread(sv, host="127.0.0.1", port=0, **kw) -> ServerHandle:
    """Start a VocoderServer on a daemon thread; returns a ServerHandle."""
    loop = asyncio.new_event_loop()
    server = VocoderServer(sv, host=host, port=port, **kw)

    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not started.wait(timeout=30):
        raise RuntimeError("server failed to start within 30 s")
    return ServerHandle(server, loop, thread)
