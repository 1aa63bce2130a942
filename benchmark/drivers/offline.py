"""Offline vocoding: one bulk caller, host mels in and host PCM out,
``IN_FLIGHT`` calls dispatched ahead of the one whose PCM it waits for.

Each call of the window copies a (rows, T, M) float32 host array (made and
page-locked in set-up) to the card, hands it to the program's ``Vocoder``,
and queues the waveform's copy back into a page-locked host buffer of its
shape (made in set-up, reused), without waiting. Once more than
``IN_FLIGHT`` calls are in flight, the client waits for the oldest one's PCM
and crops each real row to its true length, as a batched CLI writes its
files. When the window's time is up nothing more is sent, every call sent is
waited for, and the clock is read after that wait. ``vocode_xrt`` is the
seconds of audio of the real rows of every call started in the window, at
their true lengths, over the seconds from the window's start to that last
wait's end. (The calls queued ahead keep the card fed while the host stalls;
a pageable copy each way, waited for, timed the host's memory system and
page faults, which the program cannot change and whose cost moves with the
host's load: PERF.md.)

Outputs are judged once the window has closed and the program is freed: a
sample of the window's calls drawn from the seed (reservoir sampling, the
longest bucket's calls sampled apart so that one is always in it) is run
through the plain reference, and :func:`judge` compares the generator's
output window by window and G-L's achieved consistency row by row.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time

import numpy as np
import torch

import common
import traffic
import weights
from reference import audio as ra, vocoder as rv

KEEP = 2  # calls kept for judging by the reservoir over all calls
IN_FLIGHT = 8  # calls dispatched ahead of the one whose PCM the client waits for


class PortVocoder:
    """The program under test: the port's ``Vocoder`` at the configuration,
    its generator and G-L wrapped from outside for the spans and for keeping
    the generator's output of the calls to be judged."""

    def __init__(self, cfg: dict, sd: dict, dev, spans: common.Spans):
        from advoc_tpu_torch.infer import Vocoder
        from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
        from advoc_tpu_torch.ops import spectral

        v = cfg["vocoder"]
        gen = AdvocGenerator(AdvocConfig(**cfg["model"]))
        gen.load_state_dict(sd)
        self.voc = Vocoder(gen, chunk_frames=v["chunk_frames"],
                           overlap_frames=v["overlap_frames"], gl_iters=v["gl_iters"],
                           phase_impl=v["phase_impl"], gl_precision=v["gl_precision"],
                           mel_projection=v["mel_projection"], device=dev)
        self.keep, self.kept = False, None
        inner, gl = self.voc.generator, spectral.griffin_lim

        def generator(x):
            with spans.span("unet", timed=True):
                y = inner(x)
            if self.keep:
                self.kept = y
            return y

        def griffin_lim(*a, **k):
            with spans.span("gl", timed=True):
                return gl(*a, **k)

        self.voc.generator = generator
        self._restore = (spectral, gl)
        spectral.griffin_lim = griffin_lim

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        return self.voc(mel)

    def close(self) -> None:
        mod, gl = self._restore
        mod.griffin_lim = gl
        del self.voc


def make_program(cfg: dict, sd: dict, dev, spans) -> PortVocoder:
    return PortVocoder(cfg, sd, dev, spans)


class Client:
    """The bulk caller's host side: every call's mels page-locked (on a card)
    and ``IN_FLIGHT`` + 1 page-locked PCM buffers per output shape, all made
    in set-up; :meth:`send` queues a call and its readback without waiting,
    :meth:`wait` waits for one call's PCM."""

    def __init__(self, calls: list[dict], dev, hop: int):
        self.dev, self.cuda = dev, dev.type == "cuda"
        self.mels = [torch.from_numpy(c["mel"]) for c in calls]
        if self.cuda:
            self.mels = [m.pin_memory() for m in self.mels]
        shapes = {(m.shape[0], m.shape[1] * hop) for m in self.mels}
        self.free = {s: [torch.empty(s, pin_memory=self.cuda) for _ in range(IN_FLIGHT + 1)]
                     for s in shapes}

    def send(self, prog, i: int) -> tuple:
        out = prog(self.mels[i].to(self.dev, non_blocking=True))
        buf = self.free[tuple(out.shape)].pop()
        buf.copy_(out, non_blocking=True)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    def wait(self, buf: torch.Tensor, ev) -> np.ndarray:
        """The PCM of a sent call; the buffer is free again once it is read."""
        if ev is not None:
            ev.synchronize()
        return buf.numpy()

    def release(self, buf: torch.Tensor) -> None:
        self.free[tuple(buf.shape)].append(buf)


def run(ctx: dict, make=make_program) -> dict:
    """One run of an offline cell; ``make`` builds the program (a control or
    a planted fault stands in for it in the checks of the judge)."""
    cfg, wl, dev, spans = ctx["config"], ctx["workload"], ctx["device"], ctx["spans"]
    a = ra.Audio(**cfg["audio"])
    t = wl["traffic"]
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in AdvocGenerator(AdvocConfig(**cfg["model"]))
                  .state_dict().items()}
    sd = weights.make(shapes, ctx["seed"], dev)
    prog = make(cfg, sd, dev, spans)
    calls = traffic.offline_calls(t, ctx["seed"], dev, a)
    hop, sr = a.hop_length, a.sample_rate
    client = Client(calls, dev, hop)
    for shape in sorted({c["mel"].shape for c in calls}):  # every shape the window uses
        i = next(i for i, c in enumerate(calls) if c["mel"].shape == shape)
        for _ in range(2):
            buf, ev = client.send(prog, i)
            client.wait(buf, ev)
            client.release(buf)
    common.sync(dev)
    setup_s = time.monotonic() - ctx["t0"]
    common.log(f"[bench] set-up {setup_s:.2f} s: {len(calls)} distinct calls, shapes "
               f"{sorted({c['mel'].shape for c in calls})}")

    rng = np.random.default_rng([ctx["seed"], 3])
    every, longest = common.Reservoir(KEEP, rng), common.Reservoir(1, rng)
    t_long = max(c["mel"].shape[1] for c in calls)
    order = traffic.call_order(calls, t, ctx["seed"])
    done, audio_s, failed = [], 0.0, 0
    pending: collections.deque = collections.deque()

    def retire() -> None:
        i, slots, buf, ev, gen = pending.popleft()
        wav = client.wait(buf, ev)
        if slots:  # the buffer is a later call's
            wav = wav.copy()
        client.release(buf)
        rows = [wav[r, : f * hop] for r, f in enumerate(calls[i]["frames"])]
        for res, s in slots:
            res.items[s] = {"call": i, "wav": wav, "rows": rows, "gen": gen}

    spans.reset()
    prof = ctx["profiler"]()
    with prof:
        with spans.span("window"):
            t_start = time.monotonic()
            t_end = t_start + ctx["seconds"]
            while time.monotonic() < t_end:
                i = next(order)
                call = calls[i]
                slots = [(every, every.offer())]
                if call["mel"].shape[1] == t_long:
                    slots.append((longest, longest.offer()))
                slots = [(res, s) for res, s in slots if s is not None]
                prog.keep = bool(slots)
                with spans.span("call"):
                    buf, ev = client.send(prog, i)
                pending.append((i, slots, buf, ev, prog.kept))
                prog.keep, prog.kept = False, None
                audio_s += sum(call["frames"]) * hop / sr
                done.append(call["mel"].shape)
                if len(pending) > IN_FLIGHT:
                    with spans.span("readback"):
                        retire()
            with spans.span("drain"):
                while pending:
                    retire()
            t_done = time.monotonic()
    window_s = t_done - t_start
    metrics = {"vocode_xrt": audio_s / window_s, "setup_s": setup_s}
    common.log(f"[bench] window {window_s:.3f} s: {len(done)} calls, {audio_s:.1f} s of audio, "
               f"{audio_s / window_s:.1f}x real time")
    run_info = {"calls": done, "window_s": window_s, "spans": spans, "config": cfg,
                "audio": dataclasses.asdict(a), "device": dev}
    if ctx["trace"]:
        run_info["trace"] = common.reduce_trace(prof, spans)
        run_info["trace"]["device_kind"] = torch.cuda.get_device_name(dev)
        run_info["unet_ms"] = spans.device_ms("unet")
        run_info["gl_ms"] = spans.device_ms("gl")
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = [x for x in every.items + longest.items if x is not None]
    checks = judge(kept, calls, sd, cfg, a, dev, wl["limits"])
    return {"metrics": metrics, "checks": checks, "attempted": len(done), "failed": failed,
            "run": run_info, "memory_peak_bytes": mem}


def consistency(wav: torch.Tensor, target: torch.Tensor, a: ra.Audio) -> torch.Tensor:
    """Per row: ‖ |STFT(wav)| − target ‖ / ‖target‖ over target's frames and
    the first n_fft // 2 bins (the loop's), float32."""
    nb, t = a.n_fft // 2, target.shape[-2]
    s = ra.stft_mag(wav, a)[..., :t, :nb]
    return (s - target[..., :nb]).norm(dim=(-1, -2)) / target[..., :nb].norm(dim=(-1, -2))


def judge(kept: list, calls: list, sd: dict, cfg: dict, a: ra.Audio, dev, limits: dict,
          q=ra.ident) -> dict:
    """The numbers that decide ``correct``, each beside its limit:

    * ``unet_gap``: the largest relative L2 distance between the program's
      generator output and the reference's, over every window of the kept calls;
    * ``gl_excess``: the largest excess of the program's G-L inconsistency
      over the reference's, ‖|STFT(y)| − M‖/‖M‖ with M the reference's G-L
      target, over every real row, at its true length;
    * ``bad_rows``: rows of the wrong length or with a non-finite sample (0).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hop = a.hop_length
    unet_gap, gl_excess, bad = 0.0, -1.0, 0
    with torch.no_grad():
        for k in kept:
            call = calls[k["call"]]
            mel = torch.as_tensor(call["mel"], device=dev)
            b, tb, _ = mel.shape
            rep, wav_ref, mag = rv.vocode(mel, sd, cfg["model"], cfg["vocoder"], a, q)
            if k["gen"] is not None:
                g = k["gen"].float().reshape(rep.shape)
                d = (g - rep).flatten(1).norm(dim=1) / rep.flatten(1).norm(dim=1)
                unet_gap = max(unet_gap, float(d.max()))
            else:
                unet_gap = 1e30
            if k["wav"].shape != (b, tb * hop):
                bad += b
                continue
            for r, f in enumerate(call["frames"]):
                y = torch.as_tensor(k["rows"][r], device=dev)
                if y.shape[0] != f * hop or not bool(torch.isfinite(y).all()):
                    bad += 1
                    continue
                pair = torch.stack([y, wav_ref[r, : f * hop]])
                sc = consistency(pair, mag[r : r + 1, :f], a)
                gl_excess = max(gl_excess, float(sc[0] - sc[1]))
    if not kept:
        unet_gap = gl_excess = 1e30
    return {"unet_gap": {"value": unet_gap, "limit": limits["unet_gap"]},
            "gl_excess": {"value": gl_excess, "limit": limits["gl_excess"]},
            "bad_rows": {"value": bad, "limit": 0}}

