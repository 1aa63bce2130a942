"""Bulk generation: one caller, host latents in and host PCM out, the
workload's ``in_flight`` calls dispatched ahead of the one whose PCM it
waits for.

The program is the port's ``WaveGANGenerator`` at the configuration, in
eval mode under ``torch.no_grad()``, called as the WaveGAN CLI's ``infer``
calls it: ``g(z)`` → (B, slice_len) float32. Each call of the window
copies a (batch, latent_dim) float32 host array (one of ``pool`` drawn
from the seed and page-locked in set-up, taken in turn) to the card, hands
it to the generator, and queues the waveform's copy back into a
page-locked host buffer (made in set-up, reused), without waiting. Once
more than ``in_flight`` calls are in flight, the client waits for the
oldest one's PCM. When the window's time is up nothing more is sent, every
call sent is waited for, and the clock is read after that wait.
``vocode_xrt`` is the seconds of audio of every call started in the window
over the seconds from the window's start to that last wait's end.

Weights are :func:`weights.make`'s, rescaled by :func:`rescale` so that the
output is the signal's and not the biases'. The traced run keeps the
profiler's events (``run["events"]``) for the readers of the program's
ranges (:func:`wavegan_flops.program_ms`).

Outputs are judged once the window has closed and the program is freed:
two calls of the window, drawn by a seeded reservoir, are compared whole
with the plain reference (:mod:`reference.wavegan`) on the same latents
and weights (:func:`judge`).
"""

from __future__ import annotations

import collections
import gc
import math
import time

import numpy as np
import torch

import common
import weights
from reference import wavegan as rw

KEEP = 2  # calls kept for judging by the reservoir over all calls
BLOCK = 64  # rows of the reference at a time
RELU_GAIN = math.sqrt(2.0)  # a level before a ReLU keeps its input's rms
OUT_RMS = 0.4  # the last level's gain: a pre-tanh rms of a trained model's audio


class PortGenerator:
    """The program under test: the port's WaveGAN generator at the
    configuration, on the card, holding the given weights."""

    def __init__(self, cfg: dict, sd: dict, dev, spans: common.Spans):
        from advoc_tpu_torch.models.wavegan import WaveGANConfig, WaveGANGenerator

        with torch.device(dev):
            self.g = WaveGANGenerator(WaveGANConfig(**cfg["model"]))
        self.g.load_state_dict(sd)
        self.g.eval()

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.g(z)

    def close(self) -> None:
        del self.g


def rescale(sd: dict, model: dict) -> dict:
    """:func:`weights.make`'s tensors (kernels at 1/√(numel / shape[0]))
    rescaled in place so that each layer keeps its input's rms: fan-in
    latent_dim for the projection and C_in·k/stride for a transposed
    convolution (the taps that reach one output sample), gain √2 before a
    ReLU and :data:`OUT_RMS` at the last level, so that the pre-tanh rms of
    unit-normal latents is about OUT_RMS. Biases stay as drawn."""
    n, s = rw.n_up(model), model["stride"]
    for name, w in sd.items():
        if not name.endswith("weight"):
            continue
        drawn = 1.0 / math.sqrt(w.numel() / w.shape[0])
        if name == "project.weight":
            fan_in, gain = w.shape[1], RELU_GAIN
        else:
            fan_in = w.shape[0] * w.shape[2] / s
            gain = OUT_RMS if name == f"upconv{n - 1}.weight" else RELU_GAIN
        w.mul_(gain / math.sqrt(fan_in) / drawn)
    return sd


def make_weights(cfg: dict, seed: int, dev) -> dict:
    """The weights both sides get: :func:`weights.make` from the seed for
    the generator's state dict, then :func:`rescale`."""
    from advoc_tpu_torch.models.wavegan import WaveGANConfig, WaveGANGenerator

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in WaveGANGenerator(WaveGANConfig(**cfg["model"]))
                  .state_dict().items()}
    return rescale(weights.make(shapes, seed, dev), cfg["model"])


def latent_pool(t: dict, latent_dim: int, seed: int) -> np.ndarray:
    """(pool, batch, latent_dim) standard normal float32 latents on the host,
    from the seed (the CLIs draw z standard normal too)."""
    rng = np.random.default_rng([seed, 5])
    return rng.standard_normal((t["pool"], t["batch"], latent_dim), dtype=np.float32)


class Client:
    """The bulk caller's host side: the pool's latents page-locked (on a
    card) and ``in_flight`` + 1 page-locked PCM buffers, all made in set-up;
    :meth:`send` queues a call and its readback without waiting,
    :meth:`wait` waits for one call's PCM."""

    def __init__(self, pool: np.ndarray, dev, slice_len: int, in_flight: int):
        self.dev, self.cuda = dev, dev.type == "cuda"
        self.z = [torch.from_numpy(p) for p in pool]
        if self.cuda:
            self.z = [z.pin_memory() for z in self.z]
        self.shape = (pool.shape[1], slice_len)
        self.free = [torch.empty(self.shape, pin_memory=self.cuda) for _ in range(in_flight + 1)]

    def send(self, prog, i: int) -> tuple:
        out = prog(self.z[i].to(self.dev, non_blocking=True))
        if tuple(out.shape) == self.shape:
            buf = self.free.pop()
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
        if tuple(buf.shape) == self.shape:
            self.free.append(buf)


def run(ctx: dict, make=PortGenerator) -> dict:
    """One run of a generation cell; ``make`` builds the program (a control
    or a planted fault stands in for it in the checks of the judge)."""
    cfg, wl, dev, spans = ctx["config"], ctx["workload"], ctx["device"], ctx["spans"]
    t, model = wl["traffic"], cfg["model"]
    if t["kind"] != "latents":
        raise ValueError(f"not a generation mix: {t['kind']!r}")
    sd = make_weights(cfg, ctx["seed"], dev)
    prog = make(cfg, sd, dev, spans)
    pool = latent_pool(t, model["latent_dim"], ctx["seed"])
    client = Client(pool, dev, model["slice_len"], t["in_flight"])
    for _ in range(2):  # the one shape the window uses
        buf, ev = client.send(prog, 0)
        client.wait(buf, ev)
        client.release(buf)
    common.sync(dev)
    setup_s = time.monotonic() - ctx["t0"]
    common.log(f"[bench] set-up {setup_s:.2f} s: {len(pool)} latent batches of "
               f"{pool.shape[1:]}")

    rng = np.random.default_rng([ctx["seed"], 3])
    every = common.Reservoir(KEEP, rng)
    clip_s = model["slice_len"] / cfg["audio"]["sample_rate"]
    n_calls, audio_s = 0, 0.0
    pending: collections.deque = collections.deque()

    def retire() -> None:
        i, slot, buf, ev = pending.popleft()
        wav = client.wait(buf, ev)
        if slot is not None:  # the buffer is a later call's
            every.items[slot] = {"call": i, "wav": wav.copy()}
        client.release(buf)

    spans.reset()
    prof = ctx["profiler"]()
    with prof:
        with spans.span("window"):
            t_start = time.monotonic()
            t_end = t_start + ctx["seconds"]
            while time.monotonic() < t_end:
                i = n_calls % len(pool)
                slot = every.offer()
                with spans.span("call"):
                    buf, ev = client.send(prog, i)
                pending.append((i, slot, buf, ev))
                n_calls += 1
                audio_s += pool.shape[1] * clip_s
                if len(pending) > t["in_flight"]:
                    with spans.span("readback"):
                        retire()
            with spans.span("drain"):
                while pending:
                    retire()
            t_done = time.monotonic()
    window_s = t_done - t_start
    metrics = {"vocode_xrt": audio_s / window_s, "setup_s": setup_s}
    common.log(f"[bench] window {window_s:.3f} s: {n_calls} calls, {audio_s:.1f} s of audio, "
               f"{audio_s / window_s:.1f}x real time")
    run_info = {"calls": n_calls, "batch": pool.shape[1], "window_s": window_s,
                "config": cfg, "device": dev}
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
    kept = [x for x in every.items if x is not None]
    checks = judge(kept, pool, sd, model, dev, wl["limits"])
    return {"metrics": metrics, "checks": checks, "attempted": n_calls, "failed": 0,
            "run": run_info, "memory_peak_bytes": mem}


def judge(kept: list, pool: np.ndarray, sd: dict, model: dict, dev, limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit:

    * ``wave_gap``: the largest relative L2 distance of a row of PCM read
      back from the reference's row on the same latents, over every row of
      the kept calls (float32 reference, TF32 off, :data:`BLOCK` rows at a
      time);
    * ``bad_rows``: rows with a non-finite sample, or every row of a call
      whose PCM is not (batch, slice_len) (0).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gap, bad = 0.0, 0
    with torch.no_grad():
        for k in kept:
            z = torch.as_tensor(pool[k["call"]], device=dev)
            wav = k["wav"]
            if wav.shape != (z.shape[0], model["slice_len"]):
                bad += z.shape[0]
                continue
            for r0 in range(0, z.shape[0], BLOCK):
                ref = rw.generate(z[r0 : r0 + BLOCK], sd, model)
                y = torch.as_tensor(wav[r0 : r0 + BLOCK], device=dev)
                finite = torch.isfinite(y).all(dim=1)
                bad += int((~finite).sum())
                d = (y - ref).norm(dim=1) / ref.norm(dim=1)
                if bool(finite.any()):
                    gap = max(gap, float(d[finite].max()))
    if not kept:
        gap = 1e30
    return {"wave_gap": {"value": gap, "limit": limits["wave_gap"]},
            "bad_rows": {"value": bad, "limit": 0}}
