"""Offline vocoding with BigVGAN: one bulk caller, host log-mels in and
host PCM out, the workload's ``in_flight`` calls dispatched ahead of the one
whose PCM it waits for.

The program is the port's ``BigVGANGenerator`` at the configuration, in
eval mode under ``torch.no_grad()``, called ``g(mel)`` → (B, T·hop)
float32. The mix is the ``bucketed`` one (:mod:`traffic`): LJSpeech-shaped
utterances of speech-like audio, featurised in set-up to BigVGAN's log-mel
(:func:`reference.bigvgan.log_mel`), sorted into ``chunk_frames`` buckets,
``batch`` rows a call; a bucket's last call is padded with silent rows and
every row past its true length with silent frames (ln 1e-5); the calls
ordered by :func:`traffic.call_order`. Each call of the window copies its
(batch, n_mels, T) float32 host array (page-locked in set-up) to the card,
hands it to the generator, and queues the waveform's copy back into a
page-locked host buffer of its shape (made in set-up, reused), without
waiting; once more than ``in_flight`` calls are in flight the client waits
for the oldest one's PCM, the whole padded (batch, T·hop), and cuts each
real row at its true length on the host, as a batched CLI writes its files.
When
the window's time is up, the client sends the rest of the pass it is in
(a pass: every call of the mix once), so that every window holds whole
passes; then nothing more is sent, every call sent is waited for, and the
clock is read after that wait. ``vocode_xrt`` is the seconds of audio of
the real rows of every call started in the window, at their true lengths,
over the seconds from the window's start to that last wait's end.

Why whole passes: the seed picks which calls of a bucket a stretch of the
pass holds, and the calls of a bucket carry different audio for the same
work (each bucket's last call is padded with silent rows). A window of a
few dozen of these calls, each hundreds of ms of the card's work, would
carry a seed's draw of audio: 1.3–3.7% between seeds at 20–50 calls, by
simulation of the order. Whole passes carry the same audio whatever the
seed; a window is then at least a pass, however long ``--seconds`` is.

Weights are :func:`weights.make`'s, rescaled by :func:`rescale`. The traced
run keeps the profiler's events (``run["events"]``) for the readers of the
program's ranges (:func:`bigvgan_flops.program_ms`) and each traced call's
padded shape (``run["calls"]``).

Outputs are judged once the window has closed and the program is freed: a
seeded sample of the window's calls (two by reservoir over all calls, one
more over the longest bucket's) is run through the plain reference
(:mod:`reference.bigvgan`) on the same padded mels and weights
(:func:`judge`).
"""

from __future__ import annotations

import collections
import gc
import math
import time

import numpy as np
import torch

import common
import traffic
import weights
from reference import audio as ra, bigvgan as rb

KEEP = 2  # calls kept for judging by the reservoir over all calls
BLOCK = 4  # rows of the reference at a time
MEL_RMS = 7.0  # the rms of a speech log-mel: conv_pre's input
RES_GAIN = 0.5  # an AMPBlock1 round adds half its input's rms
OUT_GAIN = 0.2  # conv_post: a pre-tanh rms near 0.35
SNAKE_STD = 0.1  # log-scale alpha and beta around BigVGAN's initial 0


def model_cls():
    """The port's BigVGAN: imported first, so that a program without it
    fails the cell at once."""
    from advoc_tpu_torch.models.bigvgan import BigVGANConfig, BigVGANGenerator

    return BigVGANConfig, BigVGANGenerator


class PortBigVGAN:
    """The program under test: the port's BigVGAN generator at the
    configuration, on the card, holding the given weights."""

    def __init__(self, cfg: dict, sd: dict, dev, spans: common.Spans):
        config, generator = model_cls()
        with torch.device(dev):
            self.g = generator(config(**cfg["model"]))
        self.g.load_state_dict(sd)
        self.g.eval()

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.g(mel)

    def close(self) -> None:
        del self.g


def rescale(sd: dict, model: dict) -> dict:
    """:func:`weights.make`'s tensors (kernels at 1/√(numel / shape[0]))
    rescaled in place: each convolution keeps its input's rms (fan-in
    C_in·k, C_in·k/u for a transposed convolution of stride u), ``conv_pre``
    takes a log-mel of rms :data:`MEL_RMS` to unit rms, each AMPBlock1's
    second convolution has gain :data:`RES_GAIN` and ``conv_post``
    :data:`OUT_GAIN`; SnakeBeta's log-scale α and β are :data:`SNAKE_STD`
    normal. Biases stay as drawn."""
    for name, w in sd.items():
        if name.endswith((".alpha", ".beta")):
            w.mul_(SNAKE_STD)
            continue
        if not name.endswith("weight"):
            continue
        drawn = 1.0 / math.sqrt(w.numel() / w.shape[0])
        if name.startswith("ups."):
            u = model["upsample_rates"][int(name.split(".")[1])]
            fan_in, gain = w.shape[0] * w.shape[2] / u, 1.0
        else:
            fan_in = w.shape[1] * w.shape[2]
            gain = (1.0 / MEL_RMS if name.startswith("conv_pre.") else
                    OUT_GAIN if name.startswith("conv_post.") else
                    RES_GAIN if ".convs2." in name else 1.0)
        w.mul_(gain / math.sqrt(fan_in) / drawn)
    return sd


def make_weights(cfg: dict, seed: int, dev) -> dict:
    """The weights both sides get: :func:`weights.make` from the seed for
    the generator's state dict, then :func:`rescale`."""
    config, generator = model_cls()
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in generator(config(**cfg["model"])).state_dict().items()}
    return rescale(weights.make(shapes, seed, dev), cfg["model"])


def audio_of(cfg: dict) -> ra.Audio:
    return ra.Audio(**cfg["audio"])


def mel_calls(t: dict, seed: int, device, a: ra.Audio) -> list[dict]:
    """The calls of a ``bucketed`` mix, as :func:`traffic.offline_calls`
    groups them, with BigVGAN's log-mel: each a dict with ``mel`` (batch,
    n_mels, T) float32 on the host, silence (ln amp_floor) past each row's
    true length and in padded rows, and ``frames`` (the true length of each
    real row)."""
    if t["kind"] != "bucketed":
        raise ValueError(f"not a bucketed mix: {t['kind']!r}")
    c, b = t["chunk_frames"], t["batch"]
    frames = np.ceil(traffic.lj_durations(t["utterances"], t, t["mix_seed"]) * a.sample_rate
                     / a.hop_length).astype(int)
    bucket = -(-frames // c)
    groups: list[list[int]] = []
    for i in np.argsort(bucket * c, kind="stable"):
        if groups and len(groups[-1]) < b and bucket[groups[-1][0]] == bucket[i]:
            groups[-1].append(int(i))
        else:
            groups.append([int(i)])
    gen = torch.Generator(device=device).manual_seed(seed)
    wavs = traffic.speech([int(f) * a.hop_length for f in frames], gen, device, a.sample_rate)
    silence = math.log(a.amp_floor)
    calls = []
    for g in groups:
        mb = np.full((b, a.n_mels, int(bucket[g[0]]) * c), silence, np.float32)
        for r, i in enumerate(g):
            mb[r, :, : frames[i]] = rb.log_mel(wavs[i], a).cpu().numpy()
        calls.append({"mel": mb, "frames": [int(frames[i]) for i in g]})
    return calls


class Client:
    """The bulk caller's host side: every call's mels page-locked (on a card)
    and ``in_flight`` + 1 page-locked PCM buffers per output shape, all made
    in set-up; :meth:`send` queues a call and its readback without waiting,
    :meth:`wait` waits for one call's PCM."""

    def __init__(self, calls: list[dict], dev, hop: int, in_flight: int):
        self.dev, self.cuda = dev, dev.type == "cuda"
        self.mels = [torch.from_numpy(c["mel"]) for c in calls]
        if self.cuda:
            self.mels = [m.pin_memory() for m in self.mels]
        shapes = {(m.shape[0], m.shape[2] * hop) for m in self.mels}
        self.free = {s: [torch.empty(s, pin_memory=self.cuda) for _ in range(in_flight + 1)]
                     for s in shapes}

    def send(self, prog, i: int) -> tuple:
        out = prog(self.mels[i].to(self.dev, non_blocking=True))
        shape = tuple(out.shape)
        if out.dtype == torch.float32 and self.free.get(shape):
            buf = self.free[shape].pop()
        else:  # a wrong answer is read back too, for the judge to see
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=self.cuda)
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
        if tuple(buf.shape) in self.free and buf.dtype == torch.float32:
            self.free[tuple(buf.shape)].append(buf)


def run(ctx: dict, make=PortBigVGAN) -> dict:
    """One run of the cell; ``make`` builds the program (a control or a
    planted fault stands in for it in the checks of the judge)."""
    cfg, wl, dev, spans = ctx["config"], ctx["workload"], ctx["device"], ctx["spans"]
    t, a = wl["traffic"], audio_of(cfg)
    sd = make_weights(cfg, ctx["seed"], dev)
    prog = make(cfg, sd, dev, spans)
    calls = mel_calls(t, ctx["seed"], dev, a)
    hop, sr = a.hop_length, a.sample_rate
    client = Client(calls, dev, hop, t["in_flight"])
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
    t_long = max(c["mel"].shape[2] for c in calls)
    order = traffic.call_order([{"mel": c["mel"].transpose(0, 2, 1)} for c in calls], t,
                               ctx["seed"])
    done, audio_s = [], 0.0
    pending: collections.deque = collections.deque()

    def retire() -> None:
        i, slots, buf, ev = pending.popleft()
        wav = client.wait(buf, ev)
        if slots:  # the buffer is a later call's
            wav = wav.copy()
        client.release(buf)
        rows = [wav[r, : f * hop] for r, f in enumerate(calls[i]["frames"])]
        for res, s in slots:
            res.items[s] = {"call": i, "wav": wav, "rows": rows}

    spans.reset()
    prof = ctx["profiler"]()
    with prof:
        with spans.span("window"):
            t_start = time.monotonic()
            t_end = t_start + ctx["seconds"]
            while time.monotonic() < t_end or len(done) % len(calls):
                i = next(order)
                call = calls[i]
                slots = [(every, every.offer())]
                if call["mel"].shape[2] == t_long:
                    slots.append((longest, longest.offer()))
                slots = [(res, s) for res, s in slots if s is not None]
                with spans.span("call"):
                    buf, ev = client.send(prog, i)
                pending.append((i, slots, buf, ev))
                audio_s += sum(call["frames"]) * hop / sr
                done.append(call["mel"].shape[::2])
                if len(pending) > t["in_flight"]:
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
    run_info = {"calls": done, "window_s": window_s, "config": cfg, "device": dev}
    if ctx["trace"]:
        run_info["trace"] = common.reduce_trace(prof, spans)
        run_info["trace"]["device_kind"] = torch.cuda.get_device_name(dev)
        run_info["events"] = prof.profiler.kineto_results.events()
        run_info["profiler"] = prof  # owns the events
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog.close()
    del prog, client
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = [x for x in every.items + longest.items if x is not None]
    checks = judge(kept, calls, sd, cfg["model"], a, dev, wl["limits"])
    return {"metrics": metrics, "checks": checks, "attempted": len(done), "failed": 0,
            "run": run_info, "memory_peak_bytes": mem}


def judge(kept: list, calls: list, sd: dict, model: dict, a: ra.Audio, dev,
          limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit:

    * ``wave_gap``: the largest relative L2 distance of a real row of PCM
      read back, at its true length, from the reference's row on the same
      padded mels and weights, over every real row of the kept calls
      (float32 reference, TF32 off, :data:`BLOCK` rows at a time);
    * ``bad_rows``: real rows with a non-finite sample, or every real row of
      a call whose PCM is not (batch, T·hop) float32 (0).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hop, taps = a.hop_length, rb.kaiser_sinc().to(dev)
    gap, bad = 0.0, 0
    with torch.no_grad():
        for k in kept:
            call = calls[k["call"]]
            b, _, tb = call["mel"].shape
            n = len(call["frames"])
            if k["wav"].shape != (b, tb * hop) or k["wav"].dtype != np.float32:
                bad += n
                continue
            mel = torch.as_tensor(call["mel"][:n], device=dev)
            for r0 in range(0, n, BLOCK):
                ref = rb.generate(mel[r0 : r0 + BLOCK], sd, model, taps=taps)
                for r in range(r0, min(r0 + BLOCK, n)):
                    f = call["frames"][r] * hop
                    y = torch.as_tensor(k["rows"][r], device=dev)
                    if not bool(torch.isfinite(y).all()):
                        bad += 1
                        continue
                    want = ref[r - r0, :f]
                    gap = max(gap, float((y - want).norm() / want.norm()))
    if not kept:
        gap = 1e30
    return {"wave_gap": {"value": gap, "limit": limits["wave_gap"]},
            "bad_rows": {"value": bad, "limit": 0}}
