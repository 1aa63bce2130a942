#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: fused mel → waveform vocoding
real time factor on one card (the port of ``bench.py``).

    python3 bench_torch.py [--device cpu]
    ADVOC_BENCH_FULL=1 python3 bench_torch.py     # with the extended panel

Prints logs on stderr (the first line names the device and, on a card,
``nvidia-smi``'s name and power limit) and ONE JSON line on stdout, last:

  {"metric": "vocoding_realtime_factor", "value": <× real time at the median>,
   "unit": "x_realtime", "mfu": ..., "ms_median": ..., "ms_p25": ...,
   "ms_p75": ..., "n_trials": ..., "device": "<name>", "power_limit_w": ...}

The headline is bench.py's config 2: ``AdvocConfig()`` at full width
(random weights from a seed, bf16, eval mode), B=128 × 256-frame mels of
synthetic speech, and the graph estimate → dB normalize → U-Net →
denormalize → mel-consistency projection → fast G-L ×30 (momentum 0.99,
precision "default", the G-L kernel in JAX's split_synth mode on 512
bins). One warmup call builds the kernels; three single calls are logged;
then ``N_TRIALS`` trials of ``K`` chained calls, each trial ended by one
synchronize, give ms per batch as a median with its quartiles (bench.py
took the best of its calls; the port's times move between runs).

Outputs are checked outside the timed window: the waveform is finite, and
the same graph with the matmul G-L at the same precision re-extracts a mel
within ``GL_FORMS_MEL_L1`` of the kernel's. The mfu is the graph's matrix
work, counted by ``FlopCounterMode`` on the matmul form (every eager
iteration counts), over the median time and the card's dense bf16 peak.
Nothing is added for the kernel's split synthesis, unlike bench.py: the
count is the work the graph needs, whatever implements G-L.

After the headline, bench.py's config 4 (``small_config()`` on one
64-frame chunk, 16 G-L iterations of the matmul form at "default"), and
with ``ADVOC_BENCH_FULL`` set its extended panel: configs 1 (heuristic
inversion), 3 (the advoc GAN train step), 6 (a 60 s utterance through the
``Vocoder``), 7 (``StreamingVocoder`` pushes at 1 and 16 streams) and 5
(WaveGAN generation). bench.py's ``vs_baseline`` (a ratio to a TPU
target) is not reported.

Runs on the card; without one it exits non-zero unless given
``--device cpu`` (the kernels then run their plain versions and no device
metric is reported). A failed check exits non-zero. Imports torch, numpy
and the port only.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from advoc_tpu_torch.data.synthetic import synthetic_speech  # noqa: E402
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator  # noqa: E402
from advoc_tpu_torch.models.advoc.model import small_config  # noqa: E402
from advoc_tpu_torch.models.wavegan import WaveGANConfig  # noqa: E402
from advoc_tpu_torch.ops import spectral  # noqa: E402
from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel  # noqa: E402
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P  # noqa: E402
from advoc_tpu_torch.utils.profiling import wait_for  # noqa: E402

# The sizes of the run (tests/test_torch_bench.py shrinks them).
B = 128  # headline chunks of CONFIG().n_frames frames: 380.4 s of audio
CONFIG = AdvocConfig
GL_ITERS = 30
N_TRIALS = 40  # the 75th percentile has ten trials beyond it
K = 8  # chained calls a trial
STREAM_CONFIG = small_config
STREAM_GL_ITERS = 16
# The extended panel's sizes (bench.py's).
HEURISTIC_B = 32
TRAIN_B = 16
LONG_S = 60
STREAMS = (1, 16)
WAVEGAN_B = 64
WAVEGAN_CONFIG = WaveGANConfig
# Checks.
GL_FORMS_MEL_L1 = 2e-3  # kernel against matmul G-L, re-extracted mel L1
MFU_LIMIT = 1.05  # above it the count or the clock is wrong


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@dataclasses.dataclass(frozen=True)
class VocodeGraph:
    """bench.py's fused vocoder graph, cut at its stage seams: normalized
    mel (B, T, n_mels) → waveform (B, T·hop). ``impl`` is G-L's form:
    "kernel" (on 512 bins, the Nyquist bin dropped) or "matmul";
    ``project`` applies the mel-consistency projection (the headline does,
    the streaming config does not)."""

    generator: torch.nn.Module
    n_iters: int
    impl: str = "kernel"
    precision: str = "default"
    project: bool = True

    def featurize(self, mel: torch.Tensor) -> torch.Tensor:
        est = spectral.r9y9_melspec_to_magspec(mel, P)
        return spectral.normalize_db(spectral.amp_to_db(est, P) - P.ref_level_db, P)

    def unet(self, est_norm: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.generator(est_norm)

    def to_mag(self, repaired: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        mag = spectral.db_to_amp(spectral.denormalize_db(repaired, P) + P.ref_level_db)
        return spectral.mel_consistency_project(mag, mel, P) if self.project else mag

    def gl(self, mag: torch.Tensor) -> torch.Tensor:
        return spectral.griffin_lim(mag, n_iters=self.n_iters, momentum=0.99,
                                    params=P, precision=self.precision,
                                    fft_impl=self.impl, drop_nyquist=self.impl == "kernel")

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.gl(self.to_mag(self.unet(self.featurize(mel)), mel))


def graph_flops(graph: VocodeGraph, mel: torch.Tensor) -> float:
    """The matrix FLOP of one call of ``graph`` on ``mel``: FlopCounterMode
    over the graph with the matmul G-L (n_freq bins), whatever ``graph.impl``
    is. The kernels are invisible to the counter, and their own work (the
    split synthesis's second product, the dropped Nyquist bin) is not the
    graph's: the count stays the same work whatever implements G-L."""
    from advoc_tpu_torch.utils.roofline import cost_of

    return cost_of(dataclasses.replace(graph, impl="matmul"), mel)["flops"]


def headline_mel(b: int, t: int, device) -> torch.Tensor:
    """(b, t, n_mels) normalized mels of synthetic speech (seed 0)."""
    wav = torch.tensor(synthetic_speech(0, b * t * P.hop_length), device=device)
    return spectral.waveform_to_r9y9_melspec(wav, P)[: b * t].reshape(b, t, P.n_mels)


def mel_l1(wav: torch.Tensor, mel: torch.Tensor) -> float:
    """Mean |mel of ``wav`` − ``mel``| over the mel's frames."""
    t = mel.shape[-2]
    return float((spectral.waveform_to_r9y9_melspec(wav, P)[..., :t, :] - mel).abs().mean())


def seeded(module: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """``module`` with flax's initializers drawn from ``seed``, on ``device``,
    in eval mode."""
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return module.to(device).eval()


def timed_trials(fn) -> list[float]:
    """Seconds a call of ``fn()`` in each of ``N_TRIALS`` trials: ``K``
    chained calls, then a wait for the card, over ``K``."""
    secs = []
    for _ in range(N_TRIALS):
        t0 = time.perf_counter()
        for _ in range(K):
            out = fn()
        wait_for(out)
        secs.append((time.perf_counter() - t0) / K)
    return secs


def spread(secs: list[float]) -> dict:
    """The median ms and its quartiles over the trials."""
    p25, p50, p75 = np.percentile(np.asarray(secs) * 1e3, [25, 50, 75])
    return {"ms_median": float(p50), "ms_p25": float(p25), "ms_p75": float(p75),
            "n_trials": len(secs)}


def fmt(s: dict) -> str:
    return (f"{s['ms_median']:.3f} ms median (p25 {s['ms_p25']:.3f}, p75 {s['ms_p75']:.3f}; "
            f"{s['n_trials']} trials)")


def launches_of(fn) -> dict[str, int]:
    """The G-L kernel wrapper's launches (fp32, tensor-core) in one call of
    ``fn()``."""
    def counts():
        return {"griffin_lim": griffin_lim_kernel.launches,
                "griffin_lim_tc": griffin_lim_kernel.tc_launches}

    before = counts()
    wait_for(fn())
    return {k: v - before[k] for k, v in counts().items()}


def resolve_device(name: str) -> tuple[torch.device, str, float | None]:
    """(device, its name, the card's power limit in W or None); exits
    non-zero where the card is asked for and absent."""
    if name == "cpu":
        return torch.device("cpu"), "cpu", None
    if not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA card is present (the benchmark runs on the card; "
                 "--device cpu runs it on the CPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[bench] device: cuda:0 {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    return torch.device("cuda:0"), torch.cuda.get_device_name(0), float(
        smi.rsplit(",", 1)[1].strip().split()[0])


def main(argv=None) -> dict:
    """Runs the benchmark; returns the result line's dict."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu (the "
                         "kernels run their plain versions; no device metric)")
    args = ap.parse_args(argv)
    dev, dev_name, power_w = resolve_device(args.device)
    if dev.type == "cpu":
        log("[bench] device: cpu (the kernels run their plain versions; no device metric)")

    # -- config 2: the headline graph ---------------------------------------------
    cfg = CONFIG()
    g = seeded(AdvocGenerator(cfg), 0, dev)
    t = cfg.n_frames
    mel = headline_mel(B, t, dev)
    graph = VocodeGraph(g, GL_ITERS)
    audio_s = B * t * P.hop_length / P.sample_rate
    log(f"[bench] config 2: AdvocConfig(width={cfg.width}, depth={cfg.depth}, "
        f"{cfg.dtype}), B={B} × {t} frames = {audio_s:.1f} s of audio, fast G-L "
        f"×{GL_ITERS} ({graph.impl}, {graph.precision})")

    t0 = time.perf_counter()
    out = graph(mel)
    wait_for(out)
    log(f"[bench] build + 1st call: {time.perf_counter() - t0:.1f} s; out "
        f"{tuple(out.shape)} {out.dtype}")
    for i in range(3):
        t0 = time.perf_counter()
        out = graph(mel)
        wait_for(out)
        log(f"[bench] single call {i}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    launches = launches_of(lambda: graph(mel))
    head = spread(timed_trials(lambda: graph(mel)))
    secs = head["ms_median"] / 1e3
    xrt = audio_s / secs
    log(f"[bench] {audio_s:.1f} s audio in {fmt(head)} a batch, {K} chained calls a trial "
        f"→ {xrt:.1f}× real time ({xrt * P.sample_rate / 1e6:.2f}M samples/s); G-L "
        f"launches a call {launches}")

    # -- outputs checked, outside the timed window ------------------------------------
    require(tuple(out.shape) == (B, t * P.hop_length) and bool(torch.isfinite(out).all()),
            f"headline output {tuple(out.shape)} finite")
    out_mm = dataclasses.replace(graph, impl="matmul")(mel)
    l1_k, l1_m = mel_l1(out, mel), mel_l1(out_mm, mel)
    require(abs(l1_k - l1_m) <= GL_FORMS_MEL_L1,
            f"mel L1 G-L {graph.impl} {l1_k} vs matmul {l1_m} (within {GL_FORMS_MEL_L1})")
    log(f"[bench] output finite; re-extracted mel L1 {graph.impl} {l1_k:.5f}, matmul form "
        f"{l1_m:.5f} (within {GL_FORMS_MEL_L1})")
    del out, out_mm

    # -- the mfu: the graph's matrix work over the median and the bf16 peak ------------
    flops = graph_flops(graph, mel)
    mfu = None
    if dev.type == "cuda":
        from advoc_tpu_torch.utils.roofline import device_peaks

        peaks = device_peaks(dev)
        mfu = flops / secs / peaks.flops_per_s
        log(f"[bench] whole graph: {flops / 1e12:.3f} TFLOP (FlopCounterMode, matmul G-L) in "
            f"{head['ms_median']:.2f} ms → {flops / secs / 1e12:.1f} TFLOP/s = "
            f"{mfu * 100:.2f}% MFU of {peaks.name}"
            + (" (peaks assumed: the card was not recognised)" if peaks.assumed else ""))
        require(0 < mfu <= MFU_LIMIT, f"mfu {mfu} outside (0, {MFU_LIMIT}]")
    else:
        log(f"[bench] whole graph: {flops / 1e12:.4f} TFLOP (FlopCounterMode, matmul G-L); "
            f"no mfu on the CPU")

    # -- config 4: the small streaming config -----------------------------------------
    scfg = STREAM_CONFIG()
    sg = seeded(AdvocGenerator(scfg), 0, dev)
    stream = VocodeGraph(sg, n_iters=STREAM_GL_ITERS, impl="matmul", project=False)
    smel = mel[:1, : scfg.n_frames]
    wait_for(stream(smel))
    lat = []
    for _ in range(10):  # bench.py's ten calls, each waited for
        t0 = time.perf_counter()
        wait_for(stream(smel))
        lat.append(time.perf_counter() - t0)
    chunk_s = scfg.n_frames * P.hop_length / P.sample_rate
    st = spread(lat)
    log(f"[bench] streaming small (width {scfg.width}, {scfg.n_frames}-frame chunk, G-L "
        f"×{STREAM_GL_ITERS} matmul default; a trial is one call): {fmt(st)} a chunk "
        f"({chunk_s * 1e3:.0f} ms audio → {chunk_s / (st['ms_median'] / 1e3):.1f}× real time)")

    line = {
        "metric": "vocoding_realtime_factor",
        "value": xrt,
        "unit": "x_realtime",
        "mfu": mfu,
        **head,
        "device": dev_name,
        "power_limit_w": power_w,
        "k": K,
        "flops": flops,
        "gl_launches_per_call": launches,
        "mel_l1": {graph.impl: l1_k, "matmul": l1_m},
        "streaming_small": st,
    }
    if os.environ.get("ADVOC_BENCH_FULL"):
        line["extended"] = extended_panel(dev, g, sg)
    print(json.dumps(line), flush=True)
    return line


def extended_panel(dev: torch.device, g: torch.nn.Module, sg: torch.nn.Module) -> dict:
    """bench.py's configs 1, 3, 6, 7 and 5; ``g`` the headline generator,
    ``sg`` the streaming one. Returns each config's numbers."""
    from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
    from advoc_tpu_torch.models.advoc import PatchDiscriminator
    from advoc_tpu_torch.models.wavegan import WaveGANGenerator
    from advoc_tpu_torch.train import gan
    from advoc_tpu_torch.utils.roofline import cost_of, device_peaks

    hop, sr = P.hop_length, P.sample_rate
    peaks = device_peaks(dev)
    out = {}

    def timed(fn) -> dict:
        wait_for(fn())  # warm: builds, caches
        return spread(timed_trials(fn))

    # Config 1: heuristic inversion (mel → pinv → fast G-L ×30), no generator.
    t = g.cfg.n_frames
    mel = headline_mel(HEURISTIC_B, t, dev)
    with torch.inference_mode():
        s = timed(lambda: spectral.r9y9_melspec_to_waveform(mel, n_iters=GL_ITERS, params=P))
    audio_s = HEURISTIC_B * t * hop / sr
    out["cfg1_heuristic"] = {**s, "x_rt": audio_s / (s["ms_median"] / 1e3)}
    log(f"[bench:cfg1] heuristic inversion B={HEURISTIC_B} × {t}: {fmt(s)} for "
        f"{audio_s:.0f} s → {out['cfg1_heuristic']['x_rt']:.1f}× real time")

    # Config 3: the advoc GAN train step at the headline's config.
    cfg = g.cfg
    gt, d = AdvocGenerator(cfg).to(dev), PatchDiscriminator(cfg).to(dev)
    gstate, dstate = gan.make_states(gt, d, seed=0)
    step = gan.make_advoc_train_step(gt, d, cfg, P)
    batch = torch.tensor(synthetic_speech(1, TRAIN_B * t * hop), device=dev).reshape(TRAIN_B, -1)
    s = timed(lambda: step(gstate, dstate, batch))
    secs = s["ms_median"] / 1e3
    out["cfg3_train_step"] = {**s, "clips_per_s": TRAIN_B / secs,
                              "samples_per_s": TRAIN_B * t * hop / secs}
    log(f"[bench:cfg3] advoc GAN train step, batch {TRAIN_B}: {fmt(s)} ({TRAIN_B / secs:.1f} "
        f"clips/s, {TRAIN_B * t * hop / secs / 1e6:.2f}M audio samples/s)")
    del gt, d, gstate, dstate, step

    # Config 6: long-form vocoding, one utterance through the Vocoder (the G-L
    # kernel iterates on the whole utterance: B2's case).
    voc = Vocoder(g, params=P, chunk_frames=t, gl_iters=GL_ITERS, device=dev)
    wav = torch.tensor(synthetic_speech(2, LONG_S * sr), device=dev)
    mel_long = spectral.waveform_to_r9y9_melspec(wav, P)
    s = timed(lambda: voc(mel_long))
    launches = launches_of(lambda: voc(mel_long))
    out["cfg6_long_form"] = {**s, "x_rt": LONG_S / (s["ms_median"] / 1e3),
                             "frames": mel_long.shape[0], "gl_launches_per_call": launches}
    log(f"[bench:cfg6] long-form {LONG_S} s utterance ({mel_long.shape[0]} frames): {fmt(s)} → "
        f"{out['cfg6_long_form']['x_rt']:.1f}× real time; G-L launches a call {launches}")

    # Config 7: multi-stream low-latency serving, pushes of small_config chunks.
    c = sg.cfg.n_frames
    n_chunks = min(20, mel_long.shape[0] // c)  # bench.py's 20 chunks of the utterance
    chunks = mel_long[: n_chunks * c].reshape(n_chunks, c, P.n_mels).cpu().numpy()
    for n in STREAMS:
        sv = StreamingVocoder(sg, P, chunk_frames=c, gl_iters=STREAM_GL_ITERS, n_streams=n,
                              device=dev)
        pushes = itertools.count()

        def push(sv=sv, n=n, pushes=pushes):
            i = next(pushes) % len(chunks)
            return sv.push(np.broadcast_to(chunks[i], (n,) + chunks.shape[1:]))

        for _ in range(5):  # bench.py's warm pushes
            push()
        s = spread(timed_trials(push))
        chunk_s = c * hop / sr
        secs = s["ms_median"] / 1e3
        out[f"cfg7_streams_{n}"] = {**s, "ms_per_stream": s["ms_median"] / n,
                                    "aggregate_x_rt": chunk_s * n / secs}
        log(f"[bench:cfg7] streaming ×{n}: {fmt(s)} a push, {s['ms_median'] / n:.3f} ms a "
            f"stream ({chunk_s * 1e3:.0f} ms audio a chunk; aggregate "
            f"{chunk_s * n / secs:.1f}× real time)")

    # Config 5: WaveGAN generation.
    wcfg = WAVEGAN_CONFIG()
    wg = seeded(WaveGANGenerator(wcfg), 0, dev)
    z = torch.randn((WAVEGAN_B, wcfg.latent_dim), generator=torch.Generator().manual_seed(1))
    z = z.to(dev)
    with torch.inference_mode():
        s = timed(lambda: wg(z))
    flops = cost_of(wg, z)["flops"]  # the transposed convolutions' own work, no zero fill
    audio_s = WAVEGAN_B * wcfg.slice_len / wcfg.sample_rate
    secs = s["ms_median"] / 1e3
    out["cfg5_wavegan"] = {**s, "x_rt": audio_s / secs, "flops": flops,
                           "mfu": flops / secs / peaks.flops_per_s}
    log(f"[bench:cfg5] WaveGAN generate {WAVEGAN_B} × {wcfg.slice_len}: {fmt(s)} for "
        f"{audio_s:.0f} s at {wcfg.sample_rate // 1000} kHz → "
        f"{out['cfg5_wavegan']['x_rt']:.1f}× real time; {flops / 1e9:.1f} GFLOP, "
        f"{out['cfg5_wavegan']['mfu'] * 100:.2f}% MFU of {peaks.name}"
        + (" (peaks assumed: the card was not recognised)" if peaks.assumed else ""))
    return out


if __name__ == "__main__":
    main()
