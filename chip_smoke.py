#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``advoc_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``advoc_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each kernel against its plain
PyTorch version on the card: fast G-L in both precisions (the 3xTF32
kernels at "highest", the bf16 tensor-core kernel at "default", JAX's
split_synth), the
fused featurizer, the packed-tail transpose-conv and the U-Net's GroupNorm +
activation (:func:`group_norm`, at the full-width generator's 11 levels on
128 windows). Then it drives two
paths at the full default width (random weights from a seed), each with the
kernel counts (one per CUDA library) set to 0 just before it and read just
after:

* the offline ``Vocoder`` on B=128 × 256-frame mels and on one 1024-frame
  utterance (the tensor-core G-L kernel, and the fp32 synthesis for the
  utterance's final step; ``gl_precision="highest"`` is checked to take the
  fp32 kernels alone);
* copy synthesis, wav → ``waveform_to_r9y9_melspec(impl="kernel")`` →
  ``Vocoder`` with ``AdvocGenerator(AdvocConfig(packed_tail=True))`` → wav,
  on the same two sizes as audio (all three kernels);
* serving (:func:`serving`): the ``StreamingVocoder`` with ``small_config``
  at its published size (16 streams, 64-frame chunks, 16 G-L iterations,
  int16 emit), held to the CPU port and to its one-hot masked pushes; the
  TCP server's ``--selftest 16`` from a port bundle and one client round
  trip against a direct masked push; ``Vocoder.vocode_longform`` at full
  width on a 4096-frame utterance against the bucketed call; and
  ``vocode_cli`` on 8 wavs of mixed lengths, ``--batch 8``, full width,
  held to the same generator with the plain matmul-scan G-L (the kernel
  itself is held to its plain version at each of the CLI's batch shapes);
* the LWS slice (:func:`lws_phases`), where no port kernel runs: the
  one-call heuristic vocoders (``r9y9_melspec_to_waveform``, all five phase
  methods, and G-L's fft form) at bench.py's config 1, B=32 × 256 frames;
  the full-width ``Vocoder(phase_method="lws_exact")``; the
  ``lws_online`` and ``lws_block`` streaming engines at the serve CLI's
  defaults (masked rows bit-exact, exact stream lengths, the card's
  ``lws_online_push`` the same in chunks of 64 and of 16, mel L1 within 10%
  of the CPU port's), one ``mel_context=32`` stream; and the TCP server
  on ``--engine lws_block``.
* training (:func:`training`, phase (i)), where no port kernel runs in the
  step: ``train_evaluate --mode train`` at ``AdvocConfig()``, batch 8, on
  8 synthetic wavs with the corpus on the card (``--data_placement hbm``)
  and streamed (``wire``, a child run killed after its first checkpoint
  and resumed), every G and D tensor updated and every logged metric
  finite; the card's first step against the CPU port's on the same
  weights; g_l1 falling over 10 steps at lr 2e-3; the step's split by
  CUDA events, peak memory and a device trace; ``eval --eval_once`` and
  ``infer`` on the run (the tensor-core G-L kernel); the packed tail
  refusing gradients on the card.
* the other model families (:func:`families`, phase (j)), where no port
  kernel runs in a step: the WaveGAN, conditional-WaveGAN and MelSpecGAN
  CLIs at their published widths and default batches (16, 16, 32) on the
  same wavs, 6, 10 (a child killed after its checkpoint at step 2 and
  resumed) and 6 steps, every G and D tensor updated and every logged
  metric finite; each card's first step against the CPU port's on the same
  weights and draws; the step's split by CUDA events, peak memory and a
  device trace; ``eval --eval_once``, and ``infer`` of both WaveGANs; and
  the melspecgan → advoc pipeline (``--mode infer --vocode``, heuristic and
  ``--advoc_ckpt`` on phase (i)'s full-width run), each through the
  tensor-core G-L kernel, held by mel L1 to the CPU port at the card's
  split G-L precision.
* data parallelism (:func:`parallel`, phase (k)): ``Vocoder(mesh=)`` at
  full width on B=128 × 256 frames over two shards on the card (the
  tensor-core G-L kernel on each shard) against the unsharded call; the
  ``StreamingVocoder(mesh=)`` gl and lws_block engines with
  ``small_config``, 16 streams over two shards, against the unsharded
  engine, masked rows bit-equal; ``sharded_melspec`` on a 4-shard mesh;
  the DP step by ``parallel.mp_check`` at full width, timed (the gradient
  all-reduce's bytes and ms per step, the step's ms), with two gloo ranks
  sharing the card and with one NCCL rank;
  where the machine has two cards or more, two NCCL ranks and the
  two-card ``Vocoder(mesh=)`` as well.
* the rest of the package (:func:`rest_of_package`, phase (l)): the
  tensor-core G-L kernel in the loop modes split, split_anal and bfloat16,
  each held to its plain version at (128, 256), (8, 64) and (1, 1024)
  frames, with its mel L1 gap to the fp32 plain version (gated at 2e-3 for
  split) and its time; the full-width Vocoder exported at (8, 256) by
  ``infer.export`` (the default and the packed tail, which record the
  GroupNorm operator on the card, and ``phase_impl="xla"``, plain aten)
  and served by a child process that imports no model code, against the
  live call; ``vocoder_eval`` and ``stress_panel`` (through the featurizer
  kernel) on the card against the CPU port; the generator's other decoder
  modes and an even head kernel at full width against the CPU port, timed
  at B=128 × 256, and ``truncate_after`` at every stage; the roofline and
  profiling tools.
* the repo's tools on the port (:func:`tools`, phase (m)):
  ``scripts/run_corpus_torch.py --synthetic 16`` at ``AdvocConfig()``
  (batch 8, 20 steps, the concurrent eval on the card, every stage a child
  process) and its AOT artifact served here; ``stress_eval_torch.py``
  through the trained generator, offline and streaming; ``roofline_torch.py``
  at B=128 × 256 (no row above a peak, B1's row within 15% of (l-a)'s B1
  time); ``phase_timing_torch.py`` at B=8 × 256 (each method's mel L1 on
  utterance 0 within 10% of the CPU port's); ``stream_serve_torch.py`` at
  16 streams on gl and lws_online; ``vocode_client_torch.py`` against the
  port's server; ``projection_sweep_torch.py``, ``stoi_analysis_torch.py``
  and ``quality_ab_torch.py --steps 4``.
* the headline benchmark (:func:`bench`, phase (n)): ``bench_torch.py`` as
  a user runs it, a child process, then again with ``ADVOC_BENCH_FULL=1``
  (its extended panel): each exits 0 after its own checks (finite output,
  the kernel and matmul G-L within 2e-3 mel L1) with a result line whose
  × real time is positive, whose mfu lies in (0, 1.05], whose device is
  this card and whose headline call launched B1 61 times; the headline's
  median beside phase (m)'s roofline whole call.

It checks that the waveforms are right, holds the packed-tail generator to
the default one on the same weights, times every kernel beside its plain
version, its bound and the library call, and traces one call of each path.
Prints one line per check, the card's name and power limit, a JSON line of
kernel numbers, and as its last line ``{"ok": true, "device": {...}}``. Any
failed phase exits nonzero; without a CUDA device it exits 1 and prints no
result. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SR, HOP = 22050, 256


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def norm_levels(cfg) -> int:
    """The normalised U-Net levels of an ``AdvocConfig``'s generator, each
    one GroupNorm kernel pair a call on the card without autograd."""
    from advoc_tpu_torch.utils.roofline import group_norm_levels

    return len(group_norm_levels(cfg, 1))


def norm_pairs(n: int, levels: int, calls: int | None = None) -> bool:
    """Whether ``n`` GroupNorm kernel launches are the pair at each of a
    generator's ``levels`` normalised levels, ``calls`` times (a positive
    number of times where None)."""
    if calls is not None:
        return n == 2 * levels * calls
    return n > 0 and n % (2 * levels) == 0


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean time of ``fn`` on the card after one warmup call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_trace(fn) -> tuple[float, dict[str, tuple[float, int]]]:
    """Wall ms of one call of ``fn`` (CUDA events) and, from a
    ``torch.profiler`` trace of it, device ms and launches per kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # Device activity alone: recording every host op of a call of ≈ 10k
    # launches would cost the script seconds, and only kernels are read.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    by_name: dict[str, tuple[float, int]] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.device_time / 1e3, n + 1)
    return start.elapsed_time(end), by_name


def group_norm(dev) -> dict:
    """2d. GroupNorm + activation against its plain version at each of the
    full-width U-Net's 11 normalised levels on 128 windows (chunks-b128's
    shapes), channels-last as the convolutions return them: the kernel's
    (mean, inv) within 1e-5 relative of the plain ones, its output bit-equal
    to the plain formula on its own statistics and within one bf16 ulp of
    the plain version (two on LeakyReLU's negative side) plus 1e-5 (the
    statistics' last bits, summed in another order, are many ulps of a value
    near 0), with the largest ulps where the output is at least 2^-4 and the
    largest difference below. Times each level:
    the kernel, the plain version and a yardstick the port never calls,
    ``F.group_norm`` (bf16 weights) followed by the activation; the bound is
    the floor, one read and one write of the activation at 3.35 TB/s, and
    ``two_pass_ms`` two reads and one write. Times are the
    card's kernel time a call from a profiler over 5 calls (a small level's
    call is shorter than its host's), and the kernel's wall time a call by
    CUDA events."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    def kernel_ms(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(ev.device_time for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps

    from advoc_tpu_torch.models.advoc import AdvocConfig
    from advoc_tpu_torch.ops.kernels import group_norm as gn
    from advoc_tpu_torch.utils.roofline import bound, group_norm_bytes, group_norm_levels

    rows = {}
    for name, act, shape in group_norm_levels(AdvocConfig(), 128):
        g = torch.Generator(device=dev).manual_seed(shape[1] + shape[2])
        c = shape[1]
        x = (torch.randn(shape, generator=g, device=dev) + 0.3).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        y, scratch = gn._launch(x, w, b, 8, act)
        stats = scratch[: 2 * 128 * 8].view(128, 8, 2)
        mean, inv = gn.group_norm_stats_plain(x, 8)
        stat_rel = max(float(((stats[..., 0] - mean).abs() / mean.abs().clamp(min=1e-6)).max()),
                       float(((stats[..., 1] - inv).abs() / inv).max()))
        same = torch.equal(y, gn.group_norm_apply_plain(x, stats[..., 0], stats[..., 1], w, b,
                                                        act))
        want = gn.group_norm_act_plain(x, w, b, 8, act).float()
        _, e = torch.frexp(want)
        ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want), e - 8))
        k = torch.where(want < 0, 2.0 if act == "leaky_relu" else 1.0, 1.0)
        diff = (y.float() - want).abs()
        excess = float((diff - (k * ulp + 1e-5)).max())
        big = want.abs() >= 2**-4
        ulps_big = float((diff[big] / ulp[big]).max())
        small_abs = float(diff[~big].max())
        require(same and stat_rel <= 1e-5 and excess <= 0 and y.stride() == x.stride(),
                f"group_norm {name} {tuple(shape)}: equal on its statistics {same}, statistics "
                f"rel {stat_rel}, beyond k ulps + 1e-5 by {excess}, strides {y.stride()}")
        del y, scratch, stats, mean, inv, want, e, ulp, k, diff, big
        actf = (lambda t: F.leaky_relu(t, 0.2)) if act == "leaky_relu" else F.relu
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        row = {
            "shape": list(shape), "stat_rel": stat_rel, "max_ulps_above": ulps_big,
            "max_abs_below": small_abs,
            "ms": kernel_ms(lambda: gn.group_norm_act_kernel(x, w, b, 8, act)),  # noqa: B023
            "wall_ms": cuda_ms(lambda: gn.group_norm_act_kernel(x, w, b, 8, act), reps=10),  # noqa: B023
            "plain_ms": kernel_ms(lambda: gn.group_norm_act_plain(x, w, b, 8, act)),  # noqa: B023
            "library_ms": kernel_ms(lambda: actf(F.group_norm(x, 8, wb, bb, eps=1e-6))),  # noqa: B023
            "bound_ms": bound(0.0, group_norm_bytes(shape))[0],
            "two_pass_ms": bound(0.0, group_norm_bytes(shape, reads=2))[0],
        }
        rows[name] = row
        print(f"group_norm {name} {tuple(shape)} {act}: kernel {row['ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.1%} of its {row['bound_ms']:.4f} ms bound, "
              f"two passes {row['two_pass_ms']:.4f}; wall {row['wall_ms']:.4f}), plain "
              f"{row['plain_ms']:.3f} ms, F.group_norm + act {row['library_ms']:.3f} ms; "
              f"statistics rel {stat_rel:.1e}, ulps at |y| ≥ 2^-4 {ulps_big:g}, below "
              f"{small_abs:.1e}")
        del x
    total = {k: sum(r[k] for r in rows.values()) for k in ("ms", "wall_ms", "plain_ms",
                                                            "library_ms", "bound_ms",
                                                            "two_pass_ms")}
    print(f"group_norm 11 levels B=128: kernel {total['ms']:.3f} ms ({total['bound_ms']:.3f} ms "
          f"bound, {total['bound_ms'] / total['ms']:.1%}; two passes {total['two_pass_ms']:.3f} "
          f"ms, {total['two_pass_ms'] / total['ms']:.1%}; wall {total['wall_ms']:.3f}), plain "
          f"{total['plain_ms']:.2f} ms, "
          f"F.group_norm + act {total['library_ms']:.2f} ms; up5 kernel {rows['up5']['ms']:.3f} "
          f"ms of {rows['up5']['bound_ms']:.3f}")
    return {"levels": rows, **total}


def serving(dev, gen, voc, mels, mel_l1, zero_counts, counts) -> dict:
    """The serving phase: (a) StreamingVocoder, (b) the TCP server, (c)
    vocode_longform, (d) vocode_cli, each with the kernel counts set to 0
    just before it and read just after. Returns the numbers it printed."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _serving(pathlib.Path(tmp), dev, gen, voc, mels, mel_l1, zero_counts, counts)


def _serving(tmp, dev, gen, voc, mels, mel_l1, zero_counts, counts) -> dict:

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import StreamingVocoder, Vocoder, vocode_cli
    from advoc_tpu_torch.models.advoc import AdvocGenerator
    from advoc_tpu_torch.models.advoc.model import small_config
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.serve import VocodeClient, start_in_thread
    from advoc_tpu_torch.serve.cli import main as serve_main
    from advoc_tpu_torch.train.checkpoint import export_inference_bundle

    out: dict = {}
    # -- (a) StreamingVocoder, small_config at its published size ---------------
    sgen = AdvocGenerator(small_config())
    sgen.reset_parameters(torch.Generator().manual_seed(5))
    sgen_cpu = copy.deepcopy(sgen)
    n_s, n_chunks, chunk = 16, 10, 64
    utts = np.stack([mels(1, n_chunks * chunk, seed=100 + s)[0].cpu().numpy()
                     for s in range(n_s)])  # (16, 640, 80)
    chunks = utts.reshape(n_s, n_chunks, chunk, 80).transpose(1, 0, 2, 3)

    def stream(sv) -> np.ndarray:
        emits = [sv.push(c) for c in chunks] + [sv.flush()]
        return np.concatenate(emits, axis=1)

    def streaming_vocoder(g, n=n_s, device="cuda"):
        return StreamingVocoder(g, n_streams=n, emit_dtype="int16", device=device)

    sv = streaming_vocoder(sgen)
    zero_counts()
    sig = stream(sv)
    torch.cuda.synchronize()
    out["stream_launches"] = counts()
    require(sig.dtype == np.int16 and sig.shape == (n_s, n_chunks * chunk * HOP + sv.flush_samples),
            f"stream output {sig.dtype} {sig.shape}")
    assembled = sig[:, sv.flush_samples :].astype(np.float32) / 32767.0
    require(assembled.shape == (n_s, n_chunks * chunk * HOP), "push + flush = T·hop samples")
    l1_card = mel_l1(torch.tensor(assembled, device=dev), torch.tensor(utts, device=dev))
    t0 = time.perf_counter()
    sig_cpu = stream(streaming_vocoder(sgen_cpu, device="cpu"))
    cpu_s = time.perf_counter() - t0
    l1_cpu = mel_l1(torch.tensor(sig_cpu[:, sv.flush_samples :].astype(np.float32) / 32767.0),
                    torch.tensor(utts))
    require(abs(l1_card - l1_cpu) <= 0.1 * l1_cpu, f"stream mel L1 card {l1_card} vs CPU {l1_cpu}")
    # The server's contract: one-hot masked pushes equal the batched rows.
    for slot in (0, 7, 15):
        sv1 = streaming_vocoder(sgen)
        onehot = np.arange(n_s) == slot
        for k, c in enumerate(chunks):
            x = np.zeros_like(c)
            x[slot] = c[slot]
            row = sv1.push(x, active=onehot)[slot]
            require(np.array_equal(row, sig[slot, k * chunk * HOP : (k + 1) * chunk * HOP]),
                    f"one-hot masked push, slot {slot} chunk {k}, equals the batched row")
        require(np.array_equal(sv1.flush(active=onehot)[slot], sig[slot, n_chunks * chunk * HOP :]),
                f"one-hot masked flush, slot {slot}")
    print(f"serving (a) StreamingVocoder small_config, 16 streams × 10 chunks of 64 frames, "
          f"16 iterations, int16: launches {out['stream_launches']}; mel L1 card {l1_card:.5f}, "
          f"CPU port {l1_cpu:.5f} ({cpu_s:.1f} s on the CPU); one-hot masked pushes of slots 0, "
          f"7, 15 bit-equal to the batched rows; push + flush = exactly T·hop")
    for n in (16, 1):
        svn = streaming_vocoder(sgen, n=n)
        x = chunks[0][:n]
        out[f"push_ms_{n}"] = cuda_ms(lambda: svn.push(x, readback=False), reps=20)
        out[f"flush_ms_{n}"] = cuda_ms(lambda: svn.flush(readback=False), reps=20)
        audio_s = n * chunk * HOP / SR
        print(f"serving push, {n} stream(s): push {out[f'push_ms_{n}']:.3f} ms "
              f"({audio_s / (out[f'push_ms_{n}'] / 1e3):.1f}× real time), flush "
              f"{out[f'flush_ms_{n}']:.3f} ms")
    svn = streaming_vocoder(sgen)
    wall_ms, by_name = device_trace(lambda: svn.push(chunks[0], readback=False))
    busy_ms = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    out.update(push_trace_wall_ms=wall_ms, push_trace_busy_ms=busy_ms, push_launches=launches)
    if busy_ms > 0:
        print(f"device trace of one 16-stream push: wall {wall_ms:.2f} ms, {launches} launches, "
              f"kernels {busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f}")
        for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"  {ms:8.3f} ms {n:4d}×  {k[:90]}")
    else:
        print("device trace of one push: not measured (the profiler recorded no device time)")

    # -- (b) the TCP server on the card, from a port bundle ---------------------
    export_inference_bundle(tmp / "small", sgen.state_dict(), {"model_size": "small"})
    zero_counts()
    res = serve_main(["--selftest", "16", "--pushes", "10", "--bundle", str(tmp / "small"),
                      "--n_slots", "16", "--device", "cuda"])
    out["server_launches"] = counts()
    require(res["n_clients"] == 16 and res["ticks"] >= 10 and res["p50_ms"] > 0,
            f"selftest result {res}")
    out["server"] = res
    handle = start_in_thread(streaming_vocoder(sgen))
    try:
        with VocodeClient(*handle.address) as c:
            got = [c.vocode(m[0]) for m in chunks[:3, :1]]
            tail = c.flush()
            ref = streaming_vocoder(sgen)
            onehot = np.arange(n_s) == c.slot
            for m, g in zip(chunks[:3], got):
                x = np.zeros_like(m)
                x[c.slot] = m[0]
                require(np.array_equal(g, ref.push(x, active=onehot)[c.slot]),
                        "client round trip equals a direct masked push")
            require(np.array_equal(tail, ref.flush(active=onehot)[c.slot]),
                    "client flush equals a direct masked flush")
    finally:
        handle.stop()
    print(f"serving (b) TCP server --selftest 16 --pushes 10 on the card: launches "
          f"{out['server_launches']}; p50 {res['p50_ms']} ms, p95 {res['p95_ms']} ms (each "
          f"client's first push aside; over every push {res['p95_all_ms']} ms), "
          f"{res['mean_streams_per_tick']} streams per tick, aggregate {res['aggregate_rtf']}× "
          f"real time; a client's 3 pushes and flush bit-equal to direct masked pushes")

    # -- (c) vocode_longform at full default width, 4096 frames, tile 1024 ------
    # At the Vocoder's own gl_precision: None is "default" (the engine's
    # matmul G-L loop with bf16 operands, JAX's DEFAULT), and "highest".
    utt = mels(1, 4096, seed=7)[0]
    zero_counts()
    t0 = time.perf_counter()
    wav_lf = voc.vocode_longform(utt.cpu().numpy(), tile_frames=1024)
    out["longform_s"] = time.perf_counter() - t0
    out["longform_launches"] = counts()
    require(voc._longform[(1024, 32)].gl_precision == "default", "longform engine precision")
    wav_b = voc(utt)
    require(wav_lf.shape == (4096 * HOP,) and np.isfinite(wav_lf).all(), "longform output")
    l1_lf = mel_l1(torch.tensor(wav_lf, device=dev), utt)
    l1_b = mel_l1(wav_b, utt)
    require(l1_lf < 1.3 * l1_b + 5e-3, f"longform mel L1 {l1_lf} vs bucketed {l1_b}")
    t0 = time.perf_counter()
    voc.vocode_longform(utt.cpu().numpy(), tile_frames=1024)
    out["longform_warm_s"] = time.perf_counter() - t0
    voc_hi = Vocoder(gen, device="cuda", gl_precision="highest")
    wav_hi = voc_hi.vocode_longform(utt.cpu().numpy(), tile_frames=1024)
    t0 = time.perf_counter()
    voc_hi.vocode_longform(utt.cpu().numpy(), tile_frames=1024)
    out["longform_highest_warm_s"] = time.perf_counter() - t0
    l1_hi = mel_l1(torch.tensor(wav_hi, device=dev), utt)
    require(abs(l1_lf - l1_hi) < 2e-3, f"longform mel L1 default {l1_lf} vs highest {l1_hi}")
    print(f"serving (c) vocode_longform full width, 4096 frames, tile 1024: launches "
          f"{out['longform_launches']}; mel L1 {l1_lf:.5f} vs bucketed call {l1_b:.5f}; "
          f"{out['longform_warm_s'] * 1e3:.1f} ms warm = "
          f"{4096 * HOP / SR / out['longform_warm_s']:.1f}× real time "
          f"(first call {out['longform_s'] * 1e3:.1f} ms); at gl_precision='highest' mel L1 "
          f"{l1_hi:.5f} (default within 2e-3), {out['longform_highest_warm_s'] * 1e3:.1f} ms warm")

    # -- (d) vocode_cli, 8 wavs of mixed lengths, --batch 8, full width ---------
    export_inference_bundle(tmp / "full", gen.state_dict(), {"model_size": "full"})
    (tmp / "in").mkdir()
    lengths = [f * HOP + e for f, e in ((150, 17), (230, 0), (255, 100), (300, 5),
                                        (380, 250), (500, 3), (700, 40), (1000, 128))]
    for i, n in enumerate(lengths):
        audioio.save_as_wav(synthetic_speech(200 + i, n), tmp / "in" / f"u{i}.wav")
    zero_counts()
    summary = vocode_cli.main(["--input", str(tmp / "in"), "--out_dir", str(tmp / "out"),
                               "--bundle", str(tmp / "full"), "--batch", "8"])
    torch.cuda.synchronize()
    out["cli_launches"] = counts()
    require(out["cli_launches"]["griffin_lim_tc"] > 0, f"vocode_cli launches {out['cli_launches']}")
    # The Vocoder gate against the plain G-L: the same generator with the
    # fp32 matmul scan (phase_impl="xla"), which launches no kernel.
    voc_ref = Vocoder(gen, device="cuda", phase_impl="xla")
    cli_l1: list[tuple[float, float]] = []
    zero_counts()
    for i, n in enumerate(lengths):
        got = audioio.decode_audio(tmp / "out" / f"u{i}.wav")
        frames = 1 + n // HOP
        require(got.shape == (frames * HOP,), f"vocode_cli u{i}: {got.shape} ≠ {frames * HOP}")
        wav_in = torch.tensor(audioio.decode_audio(tmp / "in" / f"u{i}.wav"), device=dev)
        mel = sp.waveform_to_r9y9_melspec(wav_in)
        l1_cli = mel_l1(torch.tensor(got, device=dev), mel)
        l1_ref = mel_l1(voc_ref(mel), mel)
        cli_l1.append((l1_cli, l1_ref))
        require(l1_cli < 1.1 * l1_ref + 1e-3,
                f"vocode_cli u{i}: mel L1 {l1_cli} vs matmul-scan Vocoder {l1_ref}")
    torch.cuda.synchronize()
    got = counts()
    gn = got.pop("group_norm_act")
    require(not any(got.values()) and norm_pairs(gn, norm_levels(gen.cfg), len(lengths)),
            f"the matmul-scan reference launched {counts()}: no kernel but the GroupNorm pair at "
            f"each level of its {len(lengths)} generator calls")
    out["cli_x_realtime"] = summary["audio_s"] / summary["seconds"]
    print(f"serving (d) vocode_cli 8 wavs ({sum(lengths) / SR:.1f} s of audio), --batch 8, full "
          f"width: launches {out['cli_launches']}; exact lengths; mel L1 (CLI, matmul-scan "
          f"Vocoder) {', '.join(f'{a:.4f}/{b:.4f}' for a, b in cli_l1)}, each within 1.1 × the "
          f"scan's + 1e-3; {out['cli_x_realtime']:.1f}× real time after warmup")
    return out


def lws_phases(dev, gen, voc, mels, mel_l1, zero_counts, counts) -> dict:
    """The LWS slice: (e) the one-call heuristic vocoders at bench.py's config
    1, (f) the full-width Vocoder with phase_method="lws_exact", (g) the
    streaming lws engines at the serve CLI's defaults and (h) the TCP server
    on lws_block. None of these paths runs a port kernel (the JAX package's
    have no Pallas call either): every count must stay 0. Returns the
    numbers it printed."""
    import tempfile

    from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
    from advoc_tpu_torch.models.advoc import AdvocGenerator
    from advoc_tpu_torch.models.advoc.model import small_config
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS
    from advoc_tpu_torch.serve.cli import main as serve_main
    from advoc_tpu_torch.train.checkpoint import export_inference_bundle

    out: dict = {}
    t_start = time.perf_counter()

    def no_kernel(what: str, levels: int = 0, calls: int | None = None) -> None:
        """No port kernel launched, but the GroupNorm pairs of a generator
        of ``levels`` normalised levels where it runs one."""
        torch.cuda.synchronize()
        got = counts()
        gn = got.pop("group_norm_act")
        require(not any(got.values()) and (norm_pairs(gn, levels, calls) if levels else gn == 0),
                f"{what}: port kernels launched {counts()} (GroupNorm: {levels} levels, "
                f"{calls} calls)")

    def traced(fn) -> tuple[int, float | None]:
        """Launches and busy share of one traced call (None: no device time)."""
        wall_ms, by_name = device_trace(fn)
        busy = sum(ms for ms, _ in by_name.values())
        return sum(n for _, n in by_name.values()), (busy / wall_ms if busy > 0 else None)

    # -- (e) heuristic vocoders, bench.py config 1: B=32 × 256 frames -----------
    # G-L at bench.py's 30 iterations; the LWS modes at 5 sweeps (the JAX
    # package's A/B point) and lws_online at its default 2: cuts of the
    # script's time. Each mel L1 is held to the CPU port's on row 0.
    mel_b = mels(32, 256, seed=0)
    mel_row = mel_b[:1].cpu()
    audio_s = 32 * 256 * HOP / SR
    for mode, n_iters in (("lws", 30), ("griffin_lim", 30), ("lws_chromatic", 5),
                          ("lws_exact", 5), ("lws_online", 2)):
        def run(m=mel_b, mode=mode, n_iters=n_iters):
            return sp.r9y9_melspec_to_waveform(m, n_iters=n_iters, phase_method=mode)

        zero_counts()
        wav = run()
        no_kernel(f"r9y9_melspec_to_waveform({mode!r})")
        require(tuple(wav.shape) == (32, 256 * HOP) and bool(torch.isfinite(wav).all()),
                f"{mode} output {tuple(wav.shape)}")
        ms = cuda_ms(run, reps=1)
        launches, busy = traced(run)
        l1, l1_row = mel_l1(wav, mel_b), mel_l1(wav[:1], mel_b[:1])
        l1_cpu = mel_l1(run(mel_row), mel_row)
        require(abs(l1_row - l1_cpu) <= 0.1 * l1_cpu,
                f"{mode}: row 0 mel L1 card {l1_row} vs CPU {l1_cpu}")
        out[f"e_{mode}"] = dict(n_iters=n_iters, ms=ms, x_realtime=audio_s / (ms / 1e3),
                                launches=launches, busy_share=busy, mel_l1=l1,
                                mel_l1_row0=l1_row, mel_l1_row0_cpu=l1_cpu)
        print(f"(e) r9y9_melspec_to_waveform {mode!r}, {n_iters} iterations, B=32×256: "
              f"{ms:.2f} ms = {audio_s / (ms / 1e3):.1f}× real time, {launches} launches, busy "
              f"share {busy if busy is None else round(busy, 3)}; mel L1 {l1:.5f}, row 0 "
              f"{l1_row:.5f} (CPU port {l1_cpu:.5f})")
    mag = sp.r9y9_melspec_to_magspec(mel_b)
    l1_fft = mel_l1(sp.griffin_lim(mag, n_iters=30, momentum=0.99, fft_impl="fft"), mel_b)
    l1_mm = mel_l1(sp.griffin_lim(mag, n_iters=30, momentum=0.99), mel_b)
    require(abs(l1_fft - l1_mm) < 2e-3, f"G-L fft form mel L1 {l1_fft} vs matmul {l1_mm}")
    out["e_fft_ms"] = cuda_ms(lambda: sp.griffin_lim(mag, n_iters=30, momentum=0.99,
                                                     fft_impl="fft"), reps=2)
    out["e_matmul_ms"] = cuda_ms(lambda: sp.griffin_lim(mag, n_iters=30, momentum=0.99), reps=2)
    print(f"(e) griffin_lim 30 iterations momentum 0.99 B=32×256: fft form (cuFFT) "
          f"{out['e_fft_ms']:.2f} ms, mel L1 {l1_fft:.5f}; matmul form {out['e_matmul_ms']:.2f} "
          f"ms, mel L1 {l1_mm:.5f}")
    del mag
    out["e_s"] = time.perf_counter() - t_start

    # -- (f) the full-width Vocoder, phase_method="lws_exact", 5 sweeps -----------
    voc_lws = Vocoder(gen, device="cuda", phase_method="lws_exact", gl_iters=5)
    batch = mels(32, 256, seed=1)
    zero_counts()
    wav = voc_lws(batch)
    no_kernel("Vocoder(phase_method='lws_exact')", norm_levels(gen.cfg), 1)
    require(tuple(wav.shape) == (32, 256 * HOP) and bool(torch.isfinite(wav).all()),
            "lws_exact Vocoder output")
    l1, l1_gl = mel_l1(wav, batch), mel_l1(voc(batch), batch)
    p = DEFAULT_PARAMS
    with torch.inference_mode():
        est_norm = sp.normalize_db(sp.amp_to_db(sp.r9y9_melspec_to_magspec(batch)) - p.ref_level_db)
        mag = sp.mel_consistency_project(
            sp.db_to_amp(sp.denormalize_db(gen(est_norm)) + p.ref_level_db), batch)
        stages = {"estimate_ms": cuda_ms(lambda: sp.normalize_db(
                      sp.amp_to_db(sp.r9y9_melspec_to_magspec(batch)) - p.ref_level_db)),
                  "unet_ms": cuda_ms(lambda: gen(est_norm)),
                  "projection_ms": cuda_ms(lambda: sp.mel_consistency_project(mag, batch)),
                  "lws_ms": cuda_ms(lambda: sp.lws(mag, n_sweeps=5), reps=1)}
    out["f_ms"] = cuda_ms(lambda: voc_lws(batch), reps=1)
    out["f_stages"], out["f_mel_l1"] = stages, l1
    print(f"(f) Vocoder full width phase_method='lws_exact' 5 sweeps, B=32×256: "
          f"{out['f_ms']:.2f} ms = {audio_s / (out['f_ms'] / 1e3):.1f}× real time; stages "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; mel L1 {l1:.5f} (fast G-L Vocoder {l1_gl:.5f}); no G-L kernel launched")
    del mag, est_norm, wav
    out["f_s"] = time.perf_counter() - t_start

    # -- (g) the streaming lws engines, small_config, 16 streams × 10 chunks ------
    sgen = AdvocGenerator(small_config())
    sgen.reset_parameters(torch.Generator().manual_seed(5))
    sgen_cpu = copy.deepcopy(sgen)
    n_s, n_chunks, chunk = 16, 10, 64
    utts = np.stack([mels(1, n_chunks * chunk, seed=100 + s)[0].cpu().numpy()
                     for s in range(n_s)])  # (16, 640, 80)
    chunks = utts.reshape(n_s, n_chunks, chunk, 80).transpose(1, 0, 2, 3)

    # lws_online_push on the card in chunks of 64 and of 16: the same bits.
    mag_s = sp.r9y9_melspec_to_magspec(torch.tensor(utts[:, :128], device=dev))

    def online_frames(cs: int) -> torch.Tensor:
        carry, ems = sp.lws_online_init(n_s, 2, device=dev), []
        for c0 in range(0, 128, cs):
            (er, ei), carry = sp.lws_online_push(mag_s[:, c0 : c0 + cs], carry)
            ems.append(torch.complex(er, ei))
        return torch.cat(ems, dim=1)

    require(torch.equal(online_frames(64), online_frames(16)),
            "lws_online_push in chunks of 64 and of 16 bit-equal on the card")
    del mag_s
    for engine in ("lws_online", "lws_block"):
        def engine_sv(n=n_s, device="cuda", g=sgen, engine=engine, **kw):
            return StreamingVocoder(g, n_streams=n, emit_dtype="int16", phase_engine=engine,
                                    device=device, **kw)

        sv = engine_sv()
        zero_counts()
        sig = np.concatenate([sv.push(c) for c in chunks] + [sv.flush()], axis=1)
        no_kernel(f"StreamingVocoder {engine}", norm_levels(sgen.cfg))
        require(sig.dtype == np.int16
                and sig.shape == (n_s, n_chunks * chunk * HOP + sv.flush_samples),
                f"{engine} stream output {sig.dtype} {sig.shape}")
        assembled = sig[:, sv.flush_samples :].astype(np.float32) / 32767.0
        require(assembled.shape == (n_s, n_chunks * chunk * HOP), "push + flush = T·hop samples")
        l1_card = mel_l1(torch.tensor(assembled[:1], device=dev), torch.tensor(utts[:1], device=dev))
        svc = engine_sv(n=1, device="cpu", g=sgen_cpu)
        t0 = time.perf_counter()
        sig_c = np.concatenate([svc.push(c[0]) for c in chunks] + [svc.flush()])
        cpu_s = time.perf_counter() - t0
        l1_cpu = mel_l1(torch.tensor(sig_c[svc.flush_samples :].astype(np.float32)[None] / 32767.0),
                        torch.tensor(utts[:1]))
        require(abs(l1_card - l1_cpu) <= 0.1 * l1_cpu,
                f"{engine} stream mel L1 card {l1_card} vs CPU {l1_cpu}")
        for slot in (0, 7, 15):
            sv1 = engine_sv()
            onehot = np.arange(n_s) == slot
            for k, c in enumerate(chunks):
                x = np.zeros_like(c)
                x[slot] = c[slot]
                require(np.array_equal(sv1.push(x, active=onehot)[slot],
                                       sig[slot, k * chunk * HOP : (k + 1) * chunk * HOP]),
                        f"{engine} one-hot masked push, slot {slot} chunk {k}")
            require(np.array_equal(sv1.flush(active=onehot)[slot], sig[slot, n_chunks * chunk * HOP :]),
                    f"{engine} one-hot masked flush, slot {slot}")
        res = {"mel_l1_row0": l1_card, "mel_l1_row0_cpu": l1_cpu, "cpu_stream_s": cpu_s}
        for n in (16, 1):
            svn = engine_sv(n=n)
            x = chunks[0][:n]
            res[f"push_ms_{n}"] = cuda_ms(lambda: svn.push(x, readback=False), reps=5)
            res[f"flush_ms_{n}"] = cuda_ms(lambda: svn.flush(readback=False), reps=5)
        svn = engine_sv()
        wall_ms, by_name = device_trace(lambda: svn.push(chunks[0], readback=False))
        busy_ms = sum(ms for ms, _ in by_name.values())
        res["launches_per_push"] = sum(n for _, n in by_name.values())
        res["busy_share"] = busy_ms / wall_ms if busy_ms > 0 else None
        res["launches_by_kernel"] = dict(
            sorted(((k[:100], n) for k, (_, n) in by_name.items()), key=lambda kv: -kv[1])[:10])
        out[f"g_{engine}"] = res
        busy = res["busy_share"]
        print(f"(g) StreamingVocoder {engine} small_config, 16 streams × 10 chunks of 64, "
              f"int16: push {res['push_ms_16']:.2f} ms at 16 streams "
              f"({16 * chunk * HOP / SR / (res['push_ms_16'] / 1e3):.1f}× real time), "
              f"{res['push_ms_1']:.2f} ms at 1; flush {res['flush_ms_16']:.2f} / "
              f"{res['flush_ms_1']:.2f} ms; {res['launches_per_push']} launches per push, busy "
              f"share {busy if busy is None else round(busy, 3)}; mel L1 row 0 card "
              f"{l1_card:.5f}, CPU port {l1_cpu:.5f} ({cpu_s:.1f} s on the CPU); one-hot masked "
              f"pushes of slots 0, 7, 15 bit-equal; push + flush = exactly T·hop; launches by "
              f"kernel {res['launches_by_kernel']}")
    print("(g) lws_online_push in chunks of 64 and 16 bit-equal on the card")
    svc = StreamingVocoder(sgen, emit_dtype="int16", phase_engine="lws_block", mel_context=32,
                           device="cuda")
    sig1 = np.concatenate([svc.push(c[0]) for c in chunks] + [svc.flush()])
    require(svc.latency_frames == 2 + 32
            and sig1.shape == (n_chunks * chunk * HOP + svc.flush_samples,),
            f"lws_block mel_context=32 stream {sig1.shape}")
    l1_ctx = mel_l1(torch.tensor(sig1[svc.flush_samples :].astype(np.float32)[None] / 32767.0,
                                 device=dev), torch.tensor(utts[:1], device=dev))
    out["g_ctx32_push_ms"] = cuda_ms(lambda: svc.push(chunks[0][0], readback=False), reps=5)
    print(f"(g) lws_block mel_context=32, one stream (64 + 2·32 = 128 frames through the "
          f"generator): push {out['g_ctx32_push_ms']:.2f} ms, mel L1 {l1_ctx:.5f} (row 0 without "
          f"context {out['g_lws_block']['mel_l1_row0']:.5f}); push + flush = exactly T·hop")
    out["g_s"] = time.perf_counter() - t_start

    # -- (h) the TCP server on lws_block ------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lws_") as tmp:
        export_inference_bundle(pathlib.Path(tmp) / "small", sgen.state_dict(),
                                {"model_size": "small"})
        zero_counts()
        res = serve_main(["--selftest", "16", "--pushes", "10", "--engine", "lws_block",
                          "--bundle", str(pathlib.Path(tmp) / "small"), "--n_slots", "16",
                          "--device", "cuda"])
        no_kernel("server lws_block", norm_levels(sgen.cfg))
    require(res["n_clients"] == 16 and res["engine"] == "lws_block" and res["ticks"] >= 10
            and res["p50_ms"] > 0, f"lws_block selftest result {res}")
    out["h_server"] = res
    print(f"(h) TCP server --selftest 16 --pushes 10 --engine lws_block: p50 {res['p50_ms']} ms, "
          f"p95 {res['p95_ms']} ms (over every push {res['p95_all_ms']} ms), "
          f"{res['mean_streams_per_tick']} streams per tick, aggregate {res['aggregate_rtf']}× "
          f"real time")
    out["lws_phases_s"] = time.perf_counter() - t_start
    print(f"phases (e)-(h) took {out['lws_phases_s']:.1f} s (done at (e) {out['e_s']:.1f} s, "
          f"(f) {out['f_s']:.1f} s, (g) {out['g_s']:.1f} s)")
    return out


def run_train_cli(main, args: list[str]):
    """``main(args)`` of a train_evaluate CLI, its log echoed: (result, log,
    the [train] rows as (step, steps/s, metrics)), every logged metric
    finite."""
    import contextlib
    import io
    import math
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(args)
    text = buf.getvalue()
    print(text, end="")
    rows = []
    for step, rate, msg in re.findall(r"\[train\] step (\d+) \(([\d.]+) steps/s\) (.*)", text):
        m = {k: float(v) for k, v in (kv.split("=") for kv in msg.split())}
        require(all(math.isfinite(v) for v in m.values()), f"train step {step} metrics {m}")
        rows.append((int(step), float(rate), m))
    return res, text, rows


def changed_and_finite(state, init: dict, what: str, constant: tuple[str, ...] = ()) -> None:
    """Every parameter of ``state`` finite and moved from ``init`` (a CPU
    copy), but those named in ``constant``, which must not have moved."""
    for name, p in state.model.named_parameters():
        require(bool(torch.isfinite(p).all()), f"{what} {name} finite")
        moved = not torch.equal(p.detach().cpu(), init[name])
        require(moved != (name in constant),
                f"{what} {name} {'moved' if moved else 'was not updated'}")


def training(tmp, dev, mel_l1, zero_counts, counts) -> dict:
    """Phase (i): advoc GAN training at full width (``AdvocConfig()``,
    batch 8) on 8 synthetic 4-second wavs in ``tmp/wavs``, through the
    train_evaluate CLI and the step it builds; its full-width run stays in
    ``tmp/hbm`` for phase (j). Returns the numbers it printed."""
    import contextlib
    import io
    import math
    import re

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
    from advoc_tpu_torch.models.advoc import train_evaluate as cli
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.train import gan
    from advoc_tpu_torch.train.checkpoint import CheckpointManager
    from advoc_tpu_torch.utils import ensure_dataset

    t_start = time.perf_counter()
    out: dict = {}
    cfg = AdvocConfig()
    data = tmp / "wavs"
    ensure_dataset(None, str(data))  # synthetic_speech seeds 0-7, 4 s each
    common = ["--data_dir", str(data), "--batch_size", "8", "--device", "cuda"]
    zeros = {name: 0 for name in counts()}

    def run_cli(args: list[str]):
        return run_train_cli(cli.main, args)

    # -- (i-a) CLI train, the corpus staged on the card ---------------------------
    g0, d0, _, _ = cli._models_and_states(cfg, 0, dev)  # the CLI's initialization
    init = {k: {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
            for k, m in (("g", g0), ("d", d0))}
    del g0, d0
    run = tmp / "hbm"
    zero_counts()
    (gs, ds, step), text, rows = run_cli(["--mode", "train", "--train_dir", str(run),
                                          "--data_placement", "hbm", "--max_steps", "24",
                                          "--ckpt_every", "24", "--log_every", "8", *common])
    torch.cuda.synchronize()
    # The D update runs the frozen generator under no_grad: the GroupNorm pair
    # at each level a step. The G update, under autograd, the plain GroupNorm.
    require(counts() == {**zeros, "group_norm_act": 24 * 2 * norm_levels(cfg)},
            f"the train step runs no port kernel but the D update's GroupNorm: {counts()}")
    require(step == 24 and gs.step == ds.step == 24 and "staged in device memory" in text,
            f"hbm run ended at step {step}")
    changed_and_finite(gs, init["g"], "G")
    changed_and_finite(ds, init["d"], "D")
    out["hbm_steps_per_s"] = [r for _, r, _ in rows[1:]]
    print(f"(i) train --data_placement hbm, 24 steps at AdvocConfig() batch 8: every G and D "
          f"tensor updated and finite; steps/s after the first window {out['hbm_steps_per_s']}")
    del gs, ds

    # -- (i-b) kill a wire run after its first checkpoint, resume it ------------
    run_w = tmp / "wire"
    log_w = tmp / "wire_child.log"
    t0 = time.perf_counter()
    with open(log_w, "w") as f:
        child = subprocess.Popen(
            [sys.executable, "-m", "advoc_tpu_torch.models.advoc.train_evaluate", "--mode",
             "train", "--train_dir", str(run_w), "--data_placement", "wire", "--max_steps",
             "100000", "--ckpt_every", "8", "--log_every", "8", *common],
            stdout=f, stderr=subprocess.STDOUT, cwd=pathlib.Path(__file__).resolve().parent)
        try:
            while not (run_w / "8" / "state.pt").exists():
                require(child.poll() is None and time.perf_counter() - t0 < 180,
                        f"wire child ended or stalled: {log_w.read_text()[-2000:]}")
                time.sleep(0.2)
        finally:
            child.kill()
            child.wait()
    mgr = CheckpointManager(run_w, use_async=False)
    killed_at = mgr.latest_step()
    mgr.close()
    (gs, ds, step), text, rows = run_cli(["--mode", "train", "--train_dir", str(run_w),
                                          "--data_placement", "wire", "--max_steps",
                                          str(killed_at + 16), "--ckpt_every", "1000",
                                          "--log_every", "8", *common])
    require(f"resumed from step {killed_at}" in text and step == killed_at + 16
            and gs.step == ds.step == killed_at + 16,
            f"resume after the kill at {killed_at} ended at {step}")
    out["wire_steps_per_s"] = [r for _, r, _ in rows[1:]]
    print(f"(i) train --data_placement wire: killed after its checkpoint at step {killed_at} "
          f"({time.perf_counter() - t0:.1f} s), resumed to {step}; steps/s after the first "
          f"window {out['wire_steps_per_s']}")
    del gs, ds

    # -- (i-c) the card's first step against the CPU port's, same weights -------
    # bf16 convolutions summed in other orders on the two devices: the losses
    # are means over ≥ 2·256·512 values, so rounding averages out; 2e-2
    # relative.
    g_c, d_c = AdvocGenerator(cfg), PatchDiscriminator(cfg)
    gan.make_states(g_c, d_c, seed=1)
    g_d, d_d = copy.deepcopy(g_c).to(dev), copy.deepcopy(d_c).to(dev)
    wav2 = torch.tensor(np.stack([synthetic_speech(10 + i, cfg.n_frames * HOP) for i in range(2)]))
    states = {}
    for where, g, d, w in (("cpu", g_c, d_c, wav2), ("cuda", g_d, d_d, wav2.to(dev))):
        gs = gan.TrainState(g, gan.adam()(g.parameters()))
        ds = gan.TrainState(d, gan.adam()(d.parameters()))
        states[where] = gan.make_advoc_train_step(g, d, cfg)(gs, ds, w)[2]
    parity = {k: (float(states["cuda"][k]), float(states["cpu"][k]))
              for k in ("d_loss", "g_loss", "g_l1")}
    for k, (a, b) in parity.items():
        require(abs(a - b) <= 2e-2 * abs(b), f"first step {k}: card {a} vs CPU {b}")
    out["parity"] = parity
    print("(i) first step at full width, batch 2, card vs CPU port: " + ", ".join(
        f"{k} {a:.5f} vs {b:.5f} (rel {abs(a - b) / abs(b):.1e})" for k, (a, b) in parity.items()))
    del g_c, d_c, g_d, d_d

    # -- (i-d) learning, the step split, memory and a trace ---------------------
    g, d = AdvocGenerator(cfg).to(dev), PatchDiscriminator(cfg).to(dev)
    gs, ds = gan.make_states(g, d, seed=2, g_tx=gan.adam(2e-3), d_tx=gan.adam(2e-3))
    step_fn = gan.make_advoc_train_step(g, d, cfg)
    batch = torch.tensor(np.stack([synthetic_speech(20 + i, cfg.n_frames * HOP)
                                   for i in range(8)]), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l1s = [float(step_fn(gs, ds, batch)[2]["g_l1"]) for _ in range(10)]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    require(l1s[-1] < l1s[0], f"g_l1 over 10 steps at lr 2e-3: {l1s}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    feat = gan.featurize_advoc

    def timed_feat(*a, **k):
        r = feat(*a, **k)
        ev[1].record()
        return r

    def timed(apply, e):
        def f(grads):
            apply(grads)
            e.record()
        return f

    gan.featurize_advoc = timed_feat
    ds.apply_gradients = timed(ds.apply_gradients, ev[2])
    gs.apply_gradients = timed(gs.apply_gradients, ev[3])
    try:
        split = []
        for _ in range(5):
            ev[0].record()
            step_fn(gs, ds, batch)
            torch.cuda.synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    finally:
        gan.featurize_advoc = feat
        del ds.apply_gradients, gs.apply_gradients
    out["split_ms"] = {k: float(np.median([s[i] for s in split]))
                       for i, k in enumerate(("featurize", "d_update", "g_update"))}
    wall_ms, by_name = device_trace(lambda: step_fn(gs, ds, batch))
    busy = sum(ms for ms, _ in by_name.values())
    out["trace"] = {"wall_ms": wall_ms, "busy_ms": busy,
                    "launches": sum(n for _, n in by_name.values())}
    print(f"(i) g_l1 at lr 2e-3 over 10 steps on one batch of 8: {l1s[0]:.5f} → {l1s[-1]:.5f}; "
          f"step split by CUDA events (median of 5, ms): {out['split_ms']}; peak memory "
          f"{out['peak_gb']:.2f} GB")
    if busy > 0:
        print(f"device trace of one train step: wall {wall_ms:.2f} ms, kernels {busy:.2f} ms, "
              f"busy share {busy / wall_ms:.3f}, {out['trace']['launches']} launches")
        for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  {ms:8.2f} ms {n:4d}×  {k[:90]}")
    else:
        print("device trace of one train step: not measured (no device time recorded)")
    del g, d, gs, ds

    # -- (i-e) eval --eval_once and infer on the hbm run ------------------------
    zero_counts()
    seen = cli.main(["--mode", "eval", "--train_dir", str(run), "--eval_once", *common])
    torch.cuda.synchronize()
    out["eval_launches"] = counts()
    require(seen == 24 and out["eval_launches"]["griffin_lim_tc"] > 0,
            f"eval evaluated step {seen} with launches {out['eval_launches']}")
    zero_counts()
    paths = cli.main(["--mode", "infer", "--train_dir", str(run), "--device", "cuda"])
    torch.cuda.synchronize()
    out["infer_launches"] = counts()
    require(len(paths) == 1 and out["infer_launches"]["griffin_lim_tc"] > 0,
            f"infer wrote {paths} with launches {out['infer_launches']}")
    y = torch.tensor(audioio.decode_audio(paths[0]), device=dev)
    mel_in = sp.waveform_to_r9y9_melspec(torch.tensor(synthetic_speech(0, SR * 4), device=dev))
    out["infer_mel_l1"] = mel_l1(y, mel_in)
    require(math.isfinite(out["infer_mel_l1"]), f"infer mel L1 {out['infer_mel_l1']}")
    print(f"(i) eval --eval_once at step {seen}: launches {out['eval_launches']}; infer: "
          f"launches {out['infer_launches']}, mel L1 of its wav {out['infer_mel_l1']:.5f}")

    # -- (i-f) the packed tail under grad raises on the card --------------------
    cfg_pk = dataclasses.replace(cfg, packed_tail=True)
    g_pk = AdvocGenerator(cfg_pk).to(dev)
    x = torch.rand((1, cfg.n_frames, cfg.n_freq), device=dev)
    for what, fn in (("forward under grad", lambda: g_pk(x)),
                     ("make_advoc_train_step", lambda: gan.make_advoc_train_step(
                         g_pk, PatchDiscriminator(cfg_pk).to(dev), cfg_pk))):
        try:
            fn()
        except NotImplementedError as e:
            require("backward" in str(e), f"packed tail {what}: {e}")
        else:
            require(False, f"packed tail {what} did not raise on the card")
    with torch.no_grad():
        require(g_pk(x).shape == x.shape, "packed tail runs under no_grad")
    print("(i) packed_tail on the card: a forward under grad and the train step raise "
          "NotImplementedError; under no_grad it runs")
    out["phase_s"] = time.perf_counter() - t_start
    print(f"phase (i) took {out['phase_s']:.1f} s")
    return out


def step_split(step_fn, gs, ds, batch, featurize) -> dict:
    """The step's split by CUDA events (median of 5 after 2 warm steps, ms):
    D updates from the step's start to D's last Adam step, less
    ``featurize`` (the step's featurization of ``batch``, timed alone), and
    the G update; then one traced step and the peak memory of those steps."""
    ev = {"d": [], "g": []}

    def timed(apply, key):
        def f(grads):
            apply(grads)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev[key].append(e)
        return f

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step_fn(gs, ds, batch)
    ds.apply_gradients = timed(ds.apply_gradients, "d")
    gs.apply_gradients = timed(gs.apply_gradients, "g")
    rows = []
    try:
        for _ in range(5):
            ev["d"].clear()
            ev["g"].clear()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            step_fn(gs, ds, batch)
            torch.cuda.synchronize()
            rows.append((start.elapsed_time(ev["d"][-1]), ev["d"][-1].elapsed_time(ev["g"][-1])))
    finally:
        del ds.apply_gradients, gs.apply_gradients
    feat_ms = cuda_ms(lambda: featurize(batch))
    d_ms, g_ms = (float(np.median([r[i] for r in rows])) for i in range(2))
    out = {"split_ms": {"featurize": feat_ms, "d_updates": d_ms - feat_ms, "g_update": g_ms},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    wall_ms, by_name = device_trace(lambda: step_fn(gs, ds, batch))
    busy = sum(ms for ms, _ in by_name.values())
    out["trace"] = {"wall_ms": wall_ms, "busy_ms": busy,
                    "launches": sum(n for _, n in by_name.values())}
    return out


def family_draws(name: str, cfg, d, n_d: int, b: int) -> dict:
    """A step's draws from a seeded CPU generator, in the layout the port's
    steps take (``gan.make_*_train_step``'s ``draws``): the same on the card
    and on the CPU."""
    gen = torch.Generator().manual_seed(3)
    out = {}
    if name != "cond_wavegan":
        out["z"] = torch.randn((n_d + 1, b, cfg.latent_dim), generator=gen)
    if cfg.gan_type == "wgan-gp":
        out["eps"] = torch.rand((n_d, b) + ((1, 1) if name == "melspecgan" else (1,)),
                                generator=gen)
    if name != "melspecgan":
        out["shifts"] = torch.stack([d.draw_shifts(b, gen) for _ in range(n_d + 1)])
    return out


def families(tmp, dev, mel_l1, zero_counts, counts) -> dict:
    """Phase (j): the WaveGAN, conditional-WaveGAN and MelSpecGAN families at
    their published widths through their CLIs on the card, on phase (i)'s 8
    synthetic wavs (``tmp/wavs``), and the melspecgan → advoc pipeline
    through phase (i)'s full-width advoc run (``tmp/hbm``). Returns the
    numbers it printed."""
    import math

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.models import melspecgan, wavegan
    from advoc_tpu_torch.models.melspecgan import train_evaluate as mcli
    from advoc_tpu_torch.models.wavegan import train_evaluate as wcli
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel
    from advoc_tpu_torch.train import gan
    from advoc_tpu_torch.train.checkpoint import CheckpointManager, load_train_generator
    from advoc_tpu_torch.utils.roofline import bound, gl_bytes, gl_flops

    t_start = time.perf_counter()
    zeros = {name: 0 for name in counts()}
    common = ["--data_dir", str(tmp / "wavs"), "--device", "cuda"]
    out: dict = {}

    def featurize_mel(batch):
        return sp.waveform_to_r9y9_melspec(gan.as_waveform(batch))

    # (name, CLI main, extra flags, config, G, D, step maker, CLI batch, steps,
    # the step's input shape for a batch of b, its featurization)
    specs = (
        ("wavegan", wcli, [], wavegan.WaveGANConfig(), wavegan.WaveGANGenerator,
         wavegan.WaveGANDiscriminator, gan.make_wavegan_train_step, 16, 6,
         lambda c, b: (c.n_critic, b, c.slice_len), gan.as_waveform),
        ("cond_wavegan", wcli, ["--conditional"], wavegan.CondWaveGANConfig(),
         wavegan.CondWaveGANGenerator, wavegan.CondWaveGANDiscriminator,
         gan.make_cond_wavegan_train_step, 16, 10, lambda c, b: (b, c.slice_len), featurize_mel),
        ("melspecgan", mcli, [], melspecgan.MelSpecGANConfig(), melspecgan.MelSpecGANGenerator,
         melspecgan.MelSpecGANDiscriminator, gan.make_melspecgan_train_step, 32, 6,
         lambda c, b: (c.n_critic, b, c.n_frames * HOP), featurize_mel),
    )
    # A conditional-WaveGAN child run, killed by a watcher thread as soon as
    # its first checkpoint (step 2) is written, and resumed below: started
    # first, so that its start-up overlaps the first-step checks, which time
    # nothing.
    t0 = time.perf_counter()
    cond_run = tmp / "cond_wavegan"
    cond_args = ["--conditional", "--train_dir", str(cond_run), "--batch_size", "16", *common]
    child_log = tmp / "cond_wavegan_child.log"
    with open(child_log, "w") as f:
        child = subprocess.Popen(
            [sys.executable, "-m", "advoc_tpu_torch.models.wavegan.train_evaluate",
             "--mode", "train", *cond_args, "--max_steps", "100000", "--ckpt_every", "2",
             "--log_every", "2"],
            stdout=f, stderr=subprocess.STDOUT, cwd=pathlib.Path(__file__).resolve().parent)

    def kill_at_checkpoint() -> None:
        while (child.poll() is None and not (cond_run / "2" / "state.pt").exists()
               and time.perf_counter() - t0 < 180):
            time.sleep(0.05)
        child.kill()

    watcher = threading.Thread(target=kill_at_checkpoint, daemon=True)
    watcher.start()
    try:
        # The card's first step against the CPU port's: the same weights and
        # draws, batch 2, bf16. Losses are means, so rounding averages out;
        # 2e-2 relative, absolute below 1 (a mean logit near 0 has no scale).
        for name, _, _, cfg, G, D, make, _, _, shape, _ in specs:
            t1 = time.perf_counter()
            g_c, d_c = G(cfg), D(cfg)
            gan.make_states(g_c, d_c, seed=1)
            g_d, d_d = copy.deepcopy(g_c).to(dev), copy.deepcopy(d_c).to(dev)
            n = 1 if name == "cond_wavegan" else cfg.n_critic
            wav = torch.tensor(synthetic_speech(30, int(np.prod(shape(cfg, 2))))).reshape(
                shape(cfg, 2))
            draws = family_draws(name, cfg, d_c, n, 2)
            metrics = {}
            for where, g, d in (("cpu", g_c, d_c), ("cuda", g_d, d_d)):
                gs = gan.TrainState(g, gan.adam()(g.parameters()))
                ds = gan.TrainState(d, gan.adam()(d.parameters()))
                metrics[where] = make(g, d, cfg)(
                    gs, ds, wav.to(where), draws={k: v.to(where) for k, v in draws.items()})[2]
            parity = {k: (float(metrics["cuda"][k]), float(metrics["cpu"][k]))
                      for k in metrics["cpu"]}
            for k, (a, b) in parity.items():
                require(abs(a - b) <= 2e-2 * max(abs(b), 1.0), f"{name} first step {k}: card "
                        f"{a} vs CPU {b}")
            out[name] = {"parity": parity, "parity_s": time.perf_counter() - t1}
            print(f"(j) {name} first step, batch 2, card vs CPU port: " + ", ".join(
                f"{k} {a:.5f} vs {b:.5f}" for k, (a, b) in parity.items())
                + f"; {out[name]['parity_s']:.1f} s")
            del g_c, d_c, g_d, d_d
        watcher.join()
    finally:
        child.kill()
        child.wait()
    mgr = CheckpointManager(cond_run, use_async=False)
    killed_at = mgr.latest_step()
    mgr.close()
    require(killed_at is not None and 2 <= killed_at < 10,
            f"cond_wavegan child killed at step {killed_at}: {child_log.read_text()[-2000:]}")
    out["cond_wavegan"]["killed_at"] = killed_at
    child_s = time.perf_counter() - t0
    print(f"(j) the first-step checks and the conditional child up to its step-2 "
          f"checkpoint: {child_s:.1f} s")

    for name, cli, flags, cfg, G, D, make, batch_size, n_steps, shape, featurize in specs:
        t0 = time.perf_counter()
        run = tmp / name
        args = [*flags, "--train_dir", str(run), "--batch_size", str(batch_size), *common]
        extra = (bool(flags),) if cli is wcli else ()
        g0, d0, _, _ = cli._models_and_states(cfg, 0, dev, *extra)  # the CLI's initialization
        init = {k: {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
                for k, m in (("g", g0), ("d", d0))}
        del g0, d0
        # Under wgan-gp D's logit bias has a zero gradient (a critic's constant
        # shift leaves the Wasserstein loss unchanged), in JAX too.
        constant = ("logit.bias",) if cfg.gan_type == "wgan-gp" else ()
        r = out[name]
        zero_counts()
        (gs, ds, step), text, rows = run_train_cli(cli.main, [
            "--mode", "train", *args, "--max_steps", str(n_steps), "--ckpt_every",
            str(n_steps), "--log_every", "2"])
        torch.cuda.synchronize()
        require(counts() == zeros, f"the {name} step runs no port kernel: {counts()}")
        n_d = cfg.n_critic if name != "cond_wavegan" else 1
        require(step == gs.step == n_steps and ds.step == n_d * n_steps,
                f"{name} run ended at step {step} (G {gs.step}, D {ds.step})")
        if "killed_at" in r:
            require(f"resumed from step {r['killed_at']}" in text,
                    f"{name} resume after the kill at {r['killed_at']}")
        changed_and_finite(gs, init["g"], f"{name} G")
        changed_and_finite(ds, init["d"], f"{name} D", constant)
        r["steps_per_s"] = [rate for _, rate, _ in rows[1:]]
        r["train_s"] = time.perf_counter() - t0
        del gs, ds
        print(f"(j) {name} train at {type(cfg).__name__}() batch {batch_size}"
              + (f", a child killed after its checkpoint at step {r['killed_at']} and resumed"
                 if "killed_at" in r else "")
              + f", {n_steps} steps: every G and D tensor updated and finite"
              + (" (D's logit bias not, its gradient 0 under wgan-gp)" if constant else "")
              + f"; steps/s after the first window {r['steps_per_s']}; {r['train_s']:.1f} s")

        # The step's split, a trace and the peak memory at the CLI's batch.
        g, d = G(cfg).to(dev), D(cfg).to(dev)
        gs, ds = gan.make_states(g, d, seed=2)
        batch = torch.tensor(synthetic_speech(40, int(np.prod(shape(cfg, batch_size)))),
                             device=dev).reshape(shape(cfg, batch_size))
        step_fn = make(g, d, cfg)
        r.update(step_split(step_fn, gs, ds, batch, featurize))
        tr = r["trace"]
        print(f"(j) {name} step at batch {batch_size} by CUDA events (median of 5, ms): "
              f"{r['split_ms']}; peak memory {r['peak_gb']:.2f} GB; one traced step: wall "
              f"{tr['wall_ms']:.2f} ms, kernels {tr['busy_ms']:.2f} ms, busy share "
              + (f"{tr['busy_ms'] / tr['wall_ms']:.3f}" if tr["busy_ms"] > 0 else "not measured")
              + f", {tr['launches']} launches")
        del g, d, gs, ds, batch, step_fn

        # eval --eval_once, and infer for the WaveGANs (MelSpecGAN's is the
        # pipeline below).
        seen = cli.main(["--mode", "eval", "--eval_once", *args])
        require(seen == n_steps, f"{name} eval evaluated step {seen}")
        if cli is wcli:
            paths = cli.main(["--mode", "infer", *args])
            ys = [torch.tensor(audioio.decode_audio(p)) for p in paths]
            require(len(paths) == (1 if flags else 8) and all(
                bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0 for y in ys),
                f"{name} infer wrote {paths}")
        r["s"] = time.perf_counter() - t0
        print(f"(j) {name}: eval --eval_once at step {seen}"
              + (f", infer {len(paths)} finite wav(s)" if cli is wcli else "")
              + f"; {r['s']:.1f} s from the CLI's train run, {r['parity_s']:.1f} s of first-step "
              "check before")

    # The pipeline: MelSpecGAN samples 8 mels; the heuristic Vocoder (64-frame
    # chunks) and phase (i)'s full-width advoc generator (256-frame chunks)
    # vocode them, each through the tensor-core G-L kernel.
    msg_args = ["--mode", "infer", "--train_dir", str(tmp / "melspecgan"), "--n_samples", "8",
                "--vocode", "--device", "cuda"]
    pipe = {}
    for how, extra in (("vocode", []), ("advoc", ["--advoc_ckpt", str(tmp / "hbm")])):
        zero_counts()
        res = mcli.main([*msg_args, "--infer_dir", str(tmp / f"infer_{how}"), *extra])
        torch.cuda.synchronize()
        pipe[how] = {"launches": counts(), "mel_l1": res["mel_l1"]}
        require(pipe[how]["launches"]["griffin_lim_tc"] == 2 * 30 + 1
                and len(res["wavs"]) == 8, f"pipeline {how}: launches {counts()}")
        require(all(math.isfinite(v) for v in res["mel_l1"]), f"pipeline {how} {res['mel_l1']}")
    mels = torch.tensor(np.load(tmp / "infer_vocode" / "mels.npy"))
    require(torch.equal(mels, torch.tensor(np.load(tmp / "infer_advoc" / "mels.npy"))),
            "both pipeline runs sample the same mels")
    advoc_gen, _ = load_train_generator(tmp / "hbm")
    # The card against the CPU port on the same sampled mels, the CPU's G-L
    # being B1's plain version at the card's split precision
    # (phase_impl="kernel" on a CPU tensor): mel L1 within 10% either way;
    # the full-width U-Net on the CPU on two of the eight. (B1 itself is held
    # to its plain version at (8, 64) and (8, 256) in the kernel checks.)
    for how, voc_cpu, voc_dev, k in (
            ("vocode", Vocoder(chunk_frames=64, device="cpu", phase_impl="kernel"),
             Vocoder(chunk_frames=64, device="cuda"), 8),
            ("advoc", Vocoder(copy.deepcopy(advoc_gen), chunk_frames=advoc_gen.cfg.n_frames,
                              device="cpu", phase_impl="kernel"),
             Vocoder(advoc_gen, chunk_frames=advoc_gen.cfg.n_frames, device="cuda"), 2)):
        ref = float(np.mean([mel_l1(voc_cpu(m), m) for m in mels[:k]]))
        got = float(np.mean(pipe[how]["mel_l1"][:k]))
        require(abs(got - ref) <= 0.1 * ref, f"pipeline {how}: card mel L1 {got} vs CPU {ref}")
        pipe[how].update(cpu_mel_l1=ref, card_mel_l1=got,
                         ms=cuda_ms(lambda: voc_dev(mels.to(dev))))
        pipe[how]["x_real_time"] = 8 * 64 * HOP / SR / (pipe[how]["ms"] / 1e3)
        print(f"(j) melspecgan --vocode {how}: B1 launches {pipe[how]['launches']}; card mel L1 "
              f"{got:.5f} (first {k}) vs CPU port {ref:.5f}; vocoding 8 × 64 frames "
              f"{pipe[how]['ms']:.2f} ms = {pipe[how]['x_real_time']:.1f}× real time")
    # B1 at the pipeline's two shapes.
    for how, t in (("vocode", 64), ("advoc", 256)):
        mag = sp.r9y9_melspec_to_magspec(mels.to(dev))
        if t > 64:
            mag = torch.nn.functional.pad(mag, (0, 0, 0, t - 64))
        mag = mag[..., :512].contiguous()
        pipe[how]["b1_ms"] = cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99,
                                                                precision="default"))
        pipe[how]["b1_bound_ms"], _ = bound(gl_flops(8, t, 512, 30), gl_bytes(8, t, 512))
        print(f"(j) B1 tensor-core kernel at the pipeline's shape (8, {t}, 512), 30 "
              f"iterations: {pipe[how]['b1_ms']:.3f} ms, bound {pipe[how]['b1_bound_ms']:.4f} ms")
    out["pipeline"] = pipe
    out["phase_s"] = time.perf_counter() - t_start
    print(f"phase (j) took {out['phase_s']:.1f} s")
    return out


def parallel(dev, gen, voc, mels, mel_l1, zero_counts, counts, smi: str) -> dict:
    """Phase (k): the mesh'd vocoders, the halo-exchanged featurizer and
    the data-parallel step on the card (see the module's docstring).
    Returns the numbers it printed."""
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import StreamingVocoder, Vocoder
    from advoc_tpu_torch.models.advoc import AdvocGenerator
    from advoc_tpu_torch.models.advoc.model import small_config
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.parallel import data_mesh, mp_check
    from advoc_tpu_torch.parallel.halo import sharded_melspec

    t_phase = time.perf_counter()
    out: dict = {"ran": []}
    card = torch.device("cuda", 0)
    two = data_mesh(devices=[card, card])

    # -- (k-a) Vocoder(mesh=): two shards of 64 rows on the card -----------------
    # Each shard runs B1 on its rows (2·30 + 1 tensor-core launches a shard).
    # Waveforms are compared sample by sample with the unsharded Vocoder on
    # each shard's rows (the same shapes, so the same cuDNN algorithms):
    # atol 1e-3. Against the unsharded call on all 128 rows, by mel L1 within
    # 2e-3: the bf16 U-Net at 64 rows rounds apart from 128 rows (2.7e-2 at
    # most on an H100), which 30 G-L iterations at momentum 0.99 amplify
    # chaotically, so those waveforms are not sample-comparable.
    batch = mels(128, 256, seed=1)
    want = voc(batch)
    halves = torch.cat([voc(batch[:64]), voc(batch[64:])])
    voc_mesh = Vocoder(gen, mesh=two)
    zero_counts()
    got = voc_mesh(batch)
    torch.cuda.synchronize()
    out["vocoder_launches"] = counts()
    require(out["vocoder_launches"] == {"griffin_lim": 0, "griffin_lim_tc": 2 * (2 * 30 + 1),
                                        "fused_melspec": 0, "packed_up": 0,
                                        "group_norm_act": 2 * 2 * norm_levels(gen.cfg)},
            f"kernel launches of the two-shard Vocoder: {out['vocoder_launches']}")
    err = float((got - halves).abs().max())
    err_all = float((got - want).abs().max())
    l1_mesh, l1_one = mel_l1(got, batch), mel_l1(want, batch)
    require(tuple(got.shape) == (128, 256 * HOP) and bool(torch.isfinite(got).all()),
            f"two-shard Vocoder output {tuple(got.shape)}")
    require(err <= 1e-3 and abs(l1_mesh - l1_one) <= 2e-3,
            f"two-shard Vocoder: max|Δ| {err} vs the unsharded call on each shard's rows, "
            f"mel L1 {l1_mesh} vs {l1_one} unsharded")
    ms_mesh, ms_one = cuda_ms(lambda: voc_mesh(batch)), cuda_ms(lambda: voc(batch))
    out["k_a_s"] = time.perf_counter() - t_phase
    out["vocoder"] = {"max_abs_err": err, "max_abs_err_128_rows": err_all, "mel_l1": l1_mesh,
                      "ms": ms_mesh, "unsharded_ms": ms_one}
    print(f"(k-a) Vocoder(mesh=) two shards on one card, B=128×256, full width: launches "
          f"{out['vocoder_launches']}, max|Δ| vs the unsharded call on each shard's rows "
          f"{err:.2e} (vs all 128 rows at once {err_all:.2e}), mel L1 {l1_mesh:.5f} vs "
          f"{l1_one:.5f}; {ms_mesh:.2f} ms vs unsharded {ms_one:.2f} ms ({smi})")
    del got, want, halves

    # -- (k-b) StreamingVocoder(mesh=): 16 streams over two shards ---------------
    # Every push within 1e-3 of unsharded engines of each shard's 8 streams
    # (the same shapes, as in (k-a)); the streams within 10% by mel L1 of
    # one unsharded 16-stream engine (the bf16 generator rounds apart at 8
    # and 16 rows, and G-L's phase carry is chaotic). Masked rows equal the
    # same engine's batched rows bit for bit, inactive rows are zeros.
    sgen = AdvocGenerator(small_config())
    sgen.reset_parameters(torch.Generator().manual_seed(5))
    n_s, n_chunks, chunk = 16, 3, 64
    utts = np.stack([mels(1, n_chunks * chunk, seed=200 + s)[0].cpu().numpy()
                     for s in range(n_s)]).reshape(n_s, n_chunks, chunk, 80)
    active = np.arange(n_s) % 3 != 0
    for engine in ("gl", "lws_block"):
        sv_one = StreamingVocoder(sgen, n_streams=n_s, phase_engine=engine, device=card)
        sv_rows = [StreamingVocoder(sgen, n_streams=n_s // 2, phase_engine=engine, device=card)
                   for _ in range(2)]
        sv_mesh, sv_mask = (StreamingVocoder(sgen, n_streams=n_s, phase_engine=engine, mesh=two)
                            for _ in range(2))
        errs, streams = [], {"mesh": [], "one": []}
        for c in range(n_chunks):
            a, b = sv_mesh.push(utts[:, c]), sv_one.push(utts[:, c])
            rows = np.concatenate([sv.push(utts[i * n_s // 2 : (i + 1) * n_s // 2, c])
                                   for i, sv in enumerate(sv_rows)])
            m = sv_mask.push(utts[:, c], active=active)
            require(np.array_equal(m[active], a[active]) and not m[~active].any(),
                    f"{engine} masked push {c}: rows equal the batched rows, zeros elsewhere")
            errs.append(float(np.abs(a - rows).max()))
            streams["mesh"].append(a)
            streams["one"].append(b)
        require(max(errs) <= 1e-3, f"{engine} two-shard engine vs unsharded engines of its "
                                   f"shards' rows: max|Δ| {errs}")
        target = torch.tensor(utts.reshape(n_s, -1, 80), device=card)
        l1 = {k: mel_l1(torch.tensor(np.concatenate(v, axis=1), device=card), target)
              for k, v in streams.items()}
        require(abs(l1["mesh"] - l1["one"]) <= 0.1 * l1["one"], f"{engine} stream mel L1 {l1}")
        out[f"stream_{engine}"] = {"max_abs_err": errs, "mel_l1": l1}
        print(f"(k-b) StreamingVocoder(mesh=) {engine}, small_config, 16 streams over two shards, "
              f"{n_chunks} pushes of 64 frames: max|Δ| vs unsharded 8-stream engines per push "
              + ", ".join(f"{e:.2e}" for e in errs)
              + f"; mel L1 {l1['mesh']:.5f} vs {l1['one']:.5f}; masked rows bit-equal")

    out["k_b_s"] = time.perf_counter() - t_phase
    # -- (k-c) sharded_melspec on a 4-shard mesh, ≈ 4 s of audio ------------------
    length = 86 * 4 * HOP  # 88064 samples: whole hops on each of 4 shards
    wav = torch.tensor(synthetic_speech(300, length), device=card)
    got = torch.cat(sharded_melspec(wav, data_mesh(devices=[card] * 4)))
    want = sp.waveform_to_r9y9_melspec(wav)[: length // HOP]
    err = float((got - want).abs().max())
    require(tuple(got.shape) == (length // HOP, 80) and err <= 1e-4,
            f"sharded_melspec on 4 shards vs waveform_to_r9y9_melspec: max|Δ| {err}")
    out["halo_max_abs_err"] = err
    print(f"(k-c) sharded_melspec 4 shards × {length // 4} samples on one card vs the unsharded "
          f"mel: max|Δ| {err:.2e} (normalized dB)")

    # -- (k-d) the DP step: parallel.mp_check ------------------------------------
    def check(n: int, backend: str, config: str, timed: int, rtol: float, atol: float):
        t0 = time.perf_counter()
        rep = mp_check.run_check(n, device="cuda", backend=backend, config=config,
                                 timed_steps=timed, rtol=rtol, atol=atol, timeout_s=300)
        name = (f"{backend} ×{n} {config} on {sorted(set(rep['devices']))} "
                f"({time.perf_counter() - t0:.1f} s)")
        require(rep["match"], f"mp_check {name}: {json.dumps(rep)}")
        out["ran"].append(name)
        if timed:
            out[f"{backend}x{n}"] = {k: rep[k] for k in ("step_ms", "allreduce_ms",
                                                         "allreduce_bytes", "reference_step_ms")}
            print(f"(k-d) DP step {name}, global batch 8: step "
                  + ", ".join(f"{x:.1f}" for x in rep["step_ms"])
                  + f" ms a rank (one process on the whole batch "
                  f"{rep['reference_step_ms']:.1f} ms); gradient all-reduce "
                  f"{rep['allreduce_bytes'] / 1e6:.1f} MB in "
                  + ", ".join(f"{x:.1f}" for x in rep["allreduce_ms"])
                  + f" ms a step ({smi})")
        else:
            print(f"(k-d) mp_check {name}: match, metrics {rep['workers'][0]}")
        return rep

    # Full width, bf16 convolutions: each rank's half batch rounds in other
    # places than the whole batch, 2e-2 relative as phase (i)'s card-vs-CPU
    # step. (The float32 gate, JAX's rtol 2e-4, is the CPU tests'
    # tests/test_torch_parallel_dp.py: a third spawn costs this phase ≈ 30 s.)
    try:
        check(2, "gloo", "full", 3, 2e-2, 1e-3)
    except RuntimeError as exc:
        text = str(exc).lower()
        if "gloo" not in text or not any(w in text for w in ("not supported", "unsupported",
                                                             "not implemented")):
            raise
        out["gloo"] = f"refused: {str(exc)[-300:]}"
        print(f"(k-d) gloo refused CUDA tensors; its run stops here: {out['gloo']}")
    check(1, "nccl", "full", 3, 2e-2, 1e-3)
    if torch.cuda.device_count() >= 2:
        check(2, "nccl", "full", 3, 2e-2, 1e-3)
        cards = data_mesh(2)
        batch = mels(16, 256, seed=6)
        got = Vocoder(gen, mesh=cards)(batch)
        err = float((got - torch.cat([voc(batch[:8]), voc(batch[8:])])).abs().max())
        require(err <= 1e-3, f"two-card Vocoder vs one card on each shard's rows: max|Δ| {err}")
        out["ran"].append(f"Vocoder(mesh=) on {list(map(str, cards.devices))}")
        print(f"(k-d) Vocoder(mesh=) on two cards, B=16×256: max|Δ| vs one card {err:.2e}")
    print(f"(k) ran: {out['ran']} (visible cards: {torch.cuda.device_count()})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase (k) took {out['phase_s']:.1f} s ((k-a) done at {out['k_a_s']:.1f} s, "
          f"(k-b) at {out['k_b_s']:.1f} s)")
    return out


# The child of phase (l-b): serves the exported artifacts with no model code.
_EXPORT_CHILD = r'''
import json, pathlib, sys
import numpy as np, torch
from advoc_tpu_torch.infer.export import ExportedVocoder
from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel
from advoc_tpu_torch.ops.kernels.group_norm import group_norm_act_kernel
from advoc_tpu_torch.ops.kernels.packed_up import packed_up_kernel
root = pathlib.Path(sys.argv[1])
mels = torch.tensor(np.load(root / "mels.npy"), device="cuda")
res = {}
for name in sys.argv[2:]:
    ev = ExportedVocoder(root / name)
    ev(mels)
    torch.cuda.synchronize()
    griffin_lim_kernel.launches = griffin_lim_kernel.tc_launches = packed_up_kernel.launches = 0
    group_norm_act_kernel.launches = 0
    out = ev(mels)
    torch.cuda.synchronize()
    launches = {"griffin_lim": griffin_lim_kernel.launches,
                "griffin_lim_tc": griffin_lim_kernel.tc_launches,
                "packed_up": packed_up_kernel.launches,
                "group_norm_act": group_norm_act_kernel.launches}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        ev(mels)
    end.record()
    torch.cuda.synchronize()
    np.save(root / f"{name}.npy", out.cpu().numpy())
    res[name] = {"launches": launches, "ms": start.elapsed_time(end) / 3}
res["model_modules"] = sorted(m for m in sys.modules if m.startswith("advoc_tpu_torch.models"))
print("EXPORT_CHILD " + json.dumps(res))
'''


def rest_of_package(dev, gen, voc, voc_pk, mels, mel_l1, zero_counts, counts, gl_mag,
                    gl_mag_long, smi: str) -> dict:
    """Phase (l): G-L's other loop modes, AOT export, the evaluation panel,
    the generator's other decoder modes and the tools (see the module's
    docstring). Returns the numbers it printed."""
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.infer.export import export_vocoder
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel, griffin_lim_plain
    from advoc_tpu_torch.train import eval_metrics as em
    from advoc_tpu_torch.utils import profiling, roofline
    from advoc_tpu_torch.utils.roofline import bound, gl_bytes, gl_flops

    t_phase = time.perf_counter()
    out: dict = {"modes": {}}

    # -- (l-a) B1/B2 in the loop modes split, split_anal, bfloat16 ---------------
    # Each mode against its own plain version at the split mode's bounds
    # (the same operands rounded to bf16 and other sum orders: 1e-5 × peak
    # for the synthesis alone, 2e-2 and 5e-2 × peak after one and two
    # iterations, mean 3e-4 × peak); the 30-iteration mel L1 gap to the fp32
    # plain version gated at 2e-3 for split (JAX's split_synth-class mode),
    # printed for split_anal and bfloat16 (JAX's docstring: ≈ 9e-3 worse).
    # The main path of a mode: one call at B=128 × 256, 2·30 + 1 launches.
    flops = gl_flops(128, 256, 512, 30)
    gl_bound, _ = bound(flops, gl_bytes(128, 256, 512))
    long_bound, _ = bound(gl_flops(1, 1024, 512, 30), gl_bytes(1, 1024, 512))
    shapes = {(128, 256): gl_mag, (8, 64): None, (1, 1024): gl_mag_long}
    fp32_l1 = {}
    for (b, t), mag in shapes.items():
        mel = mels(b, t, seed=t + b)
        if mag is None:
            mag = sp.r9y9_melspec_to_magspec(mel)[..., :512].contiguous()
        shapes[(b, t)] = (mel, mag)
        fp32_l1[(b, t)] = mel_l1(griffin_lim_plain(mag, 30, 0.99), mel)
    for mode in ("split", "split_anal", "bfloat16"):
        row: dict = {"max_abs_err": 0.0, "gap": {}}
        for (b, t), (mel, mag) in shapes.items():
            errs = []
            for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (1, 0.0, 2e-2), (2, 0.99, 5e-2)):
                yk = griffin_lim_kernel(mag, n_iters, momentum, loop_dtype=mode)
                torch.cuda.synchronize()
                yp = griffin_lim_plain(mag, n_iters, momentum, loop_dtype=mode)
                peak = float(yp.abs().max())
                err, mean = float((yk - yp).abs().max()), float((yk - yp).abs().mean())
                require(err <= rtol * peak and mean <= 3e-4 * peak,
                        f"G-L {mode} {n_iters} iters B={b} T={t}: max {err} > {rtol} × {peak} "
                        f"or mean {mean}")
                errs.append(err / peak)
                if (b, t) == (128, 256):
                    row["max_abs_err"] = max(row["max_abs_err"], err)
            l1 = mel_l1(griffin_lim_kernel(mag, 30, 0.99, loop_dtype=mode), mel)
            gap = l1 - fp32_l1[(b, t)]
            if mode == "split":
                require(abs(gap) < 2e-3, f"G-L split B={b} T={t}: mel L1 {l1} vs fp32 plain "
                                         f"{fp32_l1[(b, t)]}")
            row["gap"][f"{b}x{t}"] = gap
            print(f"(l-a) griffin_lim {mode} B={b} T={t}: max|Δ|/peak vs plain 0-iter "
                  f"{errs[0]:.2e}, 1-iter {errs[1]:.2e}, 2-iter {errs[2]:.2e}; 30-iter mel L1 "
                  f"{l1:.5f}, fp32 plain {fp32_l1[(b, t)]:.5f}, gap {gap:+.2e}")
        mag = shapes[(128, 256)][1]
        zero_counts()
        griffin_lim_kernel(mag, 30, 0.99, loop_dtype=mode)
        torch.cuda.synchronize()
        row["launches"] = counts()
        require(row["launches"] == {"griffin_lim": 0, "griffin_lim_tc": 61, "fused_melspec": 0,
                                    "packed_up": 0, "group_norm_act": 0},
                f"G-L {mode} launches {row['launches']}")
        long_mag = shapes[(1, 1024)][1]
        row.update(
            ms=cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99, loop_dtype=mode)),
            plain_ms=cuda_ms(lambda: griffin_lim_plain(mag, 30, 0.99, loop_dtype=mode)),
            ms_split_synth=cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99, precision="default")),
            ms_b1_t1024=cuda_ms(lambda: griffin_lim_kernel(long_mag, 30, 0.99, loop_dtype=mode)),
            plain_ms_b1_t1024=cuda_ms(lambda: griffin_lim_plain(long_mag, 30, 0.99,
                                                                loop_dtype=mode)),
            bound_ms=gl_bound, bound_ms_b1_t1024=long_bound)
        row["ms_repeat"] = cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99, loop_dtype=mode))
        out["modes"][mode] = row
        print(f"(l-a) griffin_lim {mode} B=128 T=256 F=512 30 iters: launches "
              f"{row['launches']}, kernel {row['ms']:.2f} ms (repeat {row['ms_repeat']:.2f}; "
              f"split_synth {row['ms_split_synth']:.2f} ms in the same turn), plain "
              f"{row['plain_ms']:.2f} ms, bound {gl_bound:.2f} ms; B=1 T=1024 kernel "
              f"{row['ms_b1_t1024']:.3f} ms, plain {row['plain_ms_b1_t1024']:.2f} ms, bound "
              f"{long_bound:.4f} ms ({smi})")
    out["a_s"] = time.perf_counter() - t_phase

    # -- (l-b) AOT export of the full-width Vocoder at (8, 256) ------------------
    # Three artifacts of the AdvocConfig() generator (random weights from
    # seed 0): the default Vocoder (the tensor-core G-L as advoc::griffin_lim),
    # the packed tail (advoc::packed_up too), each recording
    # advoc::group_norm_act at its normalised levels (11, and 10 beside the
    # packed tail's own norm), and phase_impl="xla" (plain aten: exported
    # without allow_custom_calls, its levels traced as the plain GroupNorm).
    # A child process that imports no model code serves each on the same
    # mels: the same operators on the same weights, so bit-equal to the live
    # call is expected; held to mel L1 within 1e-4 of it and printed.
    batch8 = mels(8, 256, seed=11)
    vocs = {"default": voc, "packed_tail": voc_pk,
            "xla": Vocoder(gen, device="cuda", phase_impl="xla")}
    try:
        export_vocoder(Vocoder(device="cuda", gl_iters=2), [(1, 256)],
                       pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_refused_")))
        require(False, "a kernel artifact without allow_custom_calls was not refused")
    except ValueError as exc:
        require("allow_custom_calls" in str(exc), f"refusal message: {exc}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aot_") as tmp:
        root = pathlib.Path(tmp)
        np.save(root / "mels.npy", batch8.cpu().numpy())
        export_s = {}
        for name, v in vocs.items():
            t0 = time.perf_counter()
            export_vocoder(v, [(8, 256)], root / name, allow_custom_calls=name != "xla")
            export_s[name] = time.perf_counter() - t0
        proc = subprocess.run([sys.executable, "-c", _EXPORT_CHILD, str(root), *vocs],
                              capture_output=True, text=True, timeout=300, check=False)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("EXPORT_CHILD ")]
        require(proc.returncode == 0 and len(line) == 1,
                f"export child failed ({proc.returncode}): {proc.stderr[-3000:]}")
        child = json.loads(line[0][len("EXPORT_CHILD "):])
        require(child["model_modules"] == [],
                f"the export child imported model code: {child['model_modules']}")
        want_launches = {"default": (61, 0, 22), "packed_tail": (61, 1, 20), "xla": (0, 0, 0)}
        for name, v in vocs.items():
            live = v(batch8)
            got = torch.tensor(np.load(root / f"{name}.npy"), device=dev)
            err = float((got - live).abs().max())
            l1_live, l1_got = mel_l1(live, batch8), mel_l1(got, batch8)
            launches = child[name]["launches"]
            tc, pk, gn = want_launches[name]
            require(tuple(got.shape) == (8, 256 * HOP) and launches["griffin_lim_tc"] == tc
                    and launches["packed_up"] == pk and launches["griffin_lim"] == 0
                    and launches["group_norm_act"] == gn,
                    f"export {name}: shape {tuple(got.shape)}, launches {launches}")
            require(abs(l1_got - l1_live) <= 1e-4,
                    f"export {name}: mel L1 {l1_got} vs live {l1_live}, max|Δ| {err}")
            live_ms = cuda_ms(lambda: v(batch8))  # noqa: B023
            out[f"export_{name}"] = {"max_abs_err": err, "bit_equal": err == 0.0,
                                     "launches": launches, "ms": child[name]["ms"],
                                     "live_ms": live_ms, "export_s": export_s[name]}
            print(f"(l-b) exported Vocoder {name} (8, 256), full width: served by a child "
                  f"with no model code, launches {launches}; max|Δ| vs the live call {err:.3e}"
                  f" ({'bit-equal' if err == 0.0 else 'not bit-equal'}), mel L1 {l1_got:.5f} "
                  f"(live {l1_live:.5f}); {child[name]['ms']:.2f} ms a call against "
                  f"{live_ms:.2f} ms live; export took {export_s[name]:.1f} s")
    out["b_s"] = time.perf_counter() - t_phase

    # -- (l-c) the evaluation panel at full width ---------------------------------
    # vocoder_eval of the same pair on the card and on the CPU: the same
    # float32 reductions through two FFT libraries, 1e-3 relative. The
    # stress panel on the card (featurized by the B3 kernel, the full-width
    # Vocoder through B1) against the CPU port (the plain featurizer, the
    # CPU U-Net and B1's plain version at the card's split precision):
    # 30 chaotic G-L iterations from two U-Nets' roundings, so each metric
    # within 10% + a floor (the L1s 1e-3, LSD 0.5 dB, SNR 0.5 dB, STOI 0.1:
    # on the tone class STOI correlates bands that hold rounding-level
    # energy, and two CPU programs put it 2.3e-2 apart, tests/test_torch_eval.py).
    ref = torch.tensor(synthetic_speech_rows(8, 256 * HOP, 12), device=dev)
    gen_wav = voc(sp.waveform_to_r9y9_melspec(ref, impl="kernel"))[:, : 256 * HOP]
    ev_card = {k: float(v) for k, v in em.vocoder_eval(ref, gen_wav).items()}
    ev_cpu = {k: float(v) for k, v in em.vocoder_eval(ref.cpu(), gen_wav.cpu()).items()}
    for k, v in ev_cpu.items():
        require(abs(ev_card[k] - v) <= 1e-3 * abs(v) + 1e-6,
                f"vocoder_eval {k}: card {ev_card[k]} vs CPU {v}")
    stoi8 = em.stoi(ref[0], gen_wav[0])
    print(f"(l-c) vocoder_eval B=8×256 full width on the card: {ev_card} (CPU on the same "
          f"pair {ev_cpu}); STOI of row 0 {stoi8:.4f}")
    zero_counts()
    t0 = time.perf_counter()
    panel = em.stress_panel(voc, impl="kernel")
    torch.cuda.synchronize()
    panel_s, panel_launches = time.perf_counter() - t0, counts()
    require(panel_launches["fused_melspec"] == 6 and panel_launches["griffin_lim_tc"] == 6 * 61,
            f"stress panel launches {panel_launches}")
    gen_cpu = AdvocGenerator(gen.cfg)
    gen_cpu.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
    gen_cpu.eval()
    voc_cpu = Vocoder(gen_cpu, device="cpu", phase_impl="kernel", chunk_frames=voc.chunk,
                      overlap_frames=voc.overlap, gl_iters=voc.gl_iters)
    panel_cpu = em.stress_panel(voc_cpu, impl="kernel")
    floors = {"spec_l1": 1e-3, "mel_l1": 1e-3, "lsd_db": 0.5, "snr_db": 0.5, "stoi": 0.1}
    for kind, metrics in panel.items():
        for k, v in metrics.items():
            w = panel_cpu[kind][k]
            if not np.isfinite(w):
                require(kind == "silence" and not np.isfinite(v), f"stress {kind} {k}: {v} vs {w}")
                continue
            require(abs(v - w) <= 0.1 * abs(w) + floors[k],
                    f"stress panel {kind} {k}: card {v} vs CPU {w}")
        print(f"(l-c) stress panel {kind}: card "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()) + "; CPU "
              + ", ".join(f"{k} {v:.4f}" for k, v in panel_cpu[kind].items()))
    out["eval"] = {"vocoder_eval": ev_card, "stress_s": panel_s, "launches": panel_launches,
                   "stress": panel}
    print(f"(l-c) stress panel on the card: {panel_s:.2f} s for 6 classes, launches "
          f"{panel_launches}")
    out["c_s"] = time.perf_counter() - t_phase

    # -- (l-d) the generator's other modes at full width ---------------------------
    # Each decoder mode (and an even head kernel) with AdvocConfig()'s widths,
    # random weights from a seed: the card against the CPU port at B=2 × 256
    # (bf16: tests/test_torch_model.py's bounds, 5e-2 at most, 5e-3 mean),
    # timed at B=128 × 256 beside the default decoder; truncate_after on the
    # card against the CPU at three stages (the stage's mean, 1e-2 relative
    # + 1e-3: bf16 activations) and the cumulative time to every stage.
    x2 = torch.tensor(np.random.default_rng(13).uniform(0, 1, (2, 256, 513)), dtype=torch.float32)
    x128 = torch.rand((128, 256, 513), generator=torch.Generator(device=dev).manual_seed(14),
                      device=dev)
    with torch.inference_mode():
        default_ms = cuda_ms(lambda: gen(x128))
    out["decoders"] = {"convtranspose_ms": default_ms}
    for name, kw in (("pixelshuffle", dict(upsample="pixelshuffle")),
                     ("subpixel", dict(upsample="subpixel")),
                     ("resize", dict(upsample="resize")),
                     ("head_kernel_4", dict(head_kernel=4))):
        g = AdvocGenerator(AdvocConfig(**kw))
        g.reset_parameters(torch.Generator().manual_seed(15))
        g_card = copy.deepcopy(g).to(dev).eval()
        with torch.inference_mode():
            want, got = g.eval()(x2), g_card(x2.to(dev)).cpu()
            ms = cuda_ms(lambda: g_card(x128))  # noqa: B023
        d = (got - want).abs()
        require(float(d.max()) <= 5e-2 and float(d.mean()) < 5e-3,
                f"decoder {name}: card vs CPU max {float(d.max())}, mean {float(d.mean())}")
        out["decoders"][name] = {"max_abs_err": float(d.max()), "ms": ms}
        print(f"(l-d) generator {name} full width: card vs CPU B=2×256 max|Δ| "
              f"{float(d.max()):.3e}, mean {float(d.mean()):.2e}; B=128×256 {ms:.2f} ms "
              f"(convtranspose {default_ms:.2f} ms)")
        del g, g_card
    stages = ([f"down{i}" for i in range(6)] + ["bottleneck"] + [f"up{i}" for i in range(6)])
    stage_ms = {}
    with torch.inference_mode():
        for stage in stages:
            if stage in ("down0", "bottleneck", "up5"):
                v_card = float(gen(x2.to(dev), truncate_after=stage))
                v_cpu = float(gen_cpu(x2, truncate_after=stage))
                require(abs(v_card - v_cpu) <= 1e-2 * abs(v_cpu) + 1e-3,
                        f"truncate_after {stage}: card {v_card} vs CPU {v_cpu}")
            stage_ms[stage] = cuda_ms(lambda: gen(x128, truncate_after=stage))  # noqa: B023
    out["decoders"]["stage_ms"] = stage_ms
    print("(l-d) U-Net B=128×256 cumulative ms to each stage (truncate_after): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()) + f"; whole {default_ms:.2f}")
    out["d_s"] = time.perf_counter() - t_phase

    # -- (l-e) the tools on the card -------------------------------------------------
    peaks = roofline.device_peaks()
    est = x128[:8]
    cost = roofline.cost_of(gen, est)
    with torch.inference_mode():
        secs = roofline.slope_time(gen, est, k_lo=2, k_hi=6, trials=2)
    row = roofline.roofline_row("U-Net B=8×256", cost["flops"], cost["bytes"], secs, peaks)
    print("(l-e) roofline (utils/roofline.py; FlopCounterMode counts the convolutions):\n"
          + roofline.format_table([row], peaks))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with torch.inference_mode(), profiling.trace(tmp) as prof:
            gen(est)
            torch.cuda.synchronize()
        n_files = len(list(pathlib.Path(tmp).glob("*.pt.trace.json")))
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    with torch.inference_mode():
        best, _ = profiling.timed_call(gen, est)
    require(n_files == 1 and not peaks.assumed, f"tools: {n_files} trace files, {peaks}")
    print(f"(l-e) profiling.trace wrote {n_files} trace, device time {device_ms:.2f} ms; "
          f"timed_call best {best * 1e3:.2f} ms; device_peaks {peaks}")
    out["roofline"] = row
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase (l) took {out['phase_s']:.1f} s ((l-a) done at {out['a_s']:.1f} s, (l-b) at "
          f"{out['b_s']:.1f} s, (l-c) at {out['c_s']:.1f} s, (l-d) at {out['d_s']:.1f} s)")
    return out


def _script(name: str):
    """``scripts/<name>.py`` of this checkout, loaded as the module
    ``port_<name>`` (never by its bare name, which the JAX scripts share)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tools(tmp, dev, zero_counts, counts, smi: str, b1_ms: float) -> dict:
    """Phase (m): the port's scripts (``scripts/*_torch.py``) on the card.
    The runbook runs as a child, as a user runs it; the others in-process
    where the kernel counts are read, each with the counts set to 0 just
    before it and read just after. ``b1_ms``: (l-a)'s time of B1 at
    (128, 256), which the roofline's B1 row is held to. Returns the numbers
    it printed."""
    from advoc_tpu_torch.infer import StreamingVocoder
    from advoc_tpu_torch.infer.export import ExportedVocoder
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.serve import start_in_thread

    t_phase = time.perf_counter()
    out: dict = {}
    root = pathlib.Path(__file__).resolve().parent
    tc = lambda c: c["griffin_lim_tc"]  # noqa: E731

    # -- (m-a) the runbook at AdvocConfig(), full width ----------------------------
    # 16 synthetic LJ-shaped files, batch 8, 20 steps, a checkpoint every 10,
    # the concurrent eval on the same card, 30 G-L iterations, 4 clients.
    run = tmp / "run"
    cmd = [sys.executable, str(root / "scripts" / "run_corpus_torch.py"),
           "--corpus_dir", str(tmp / "corpus"), "--run_dir", str(run), "--synthetic", "16",
           "--batch_size", "8", "--max_steps", "20", "--ckpt_every", "10", "--log_every", "5",
           "--eval_timeout_s", "30", "--gl_iters", "30", "--serve_clients", "4"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    m = re.search(r"RUN_CORPUS_RESULT (\{.*\})", proc.stdout)
    if proc.returncode != 0 or not m:
        print(proc.stdout[-6000:], proc.stderr[-6000:])
    require(proc.returncode == 0 and m is not None, f"run_corpus_torch rc {proc.returncode}")
    rc = json.loads(m.group(1))
    stages = rc["stages_s"]
    require(rc["ok"] and set(stages) >= {"synthesize", "prep", "train", "bundle", "panel",
                                          "aot", "build", "serve"},
            f"run_corpus_torch stages {sorted(stages)}")
    require(rc["eval_last"] is not None, "the concurrent eval scored no checkpoint")
    require(rc["serve"] is not None and rc["serve"]["n_clients"] == 4
            and rc["serve"]["device"].startswith("cuda"), f"serve {rc['serve']}")
    out["run_corpus"] = rc
    print(f"(m-a) run_corpus_torch --synthetic 16 AdvocConfig() batch 8, 20 steps: wall "
          f"{wall:.1f} s; stages s {stages}; steps/s per 5-step window "
          f"{rc['steps_per_s_windows']} (median of the windows after the first "
          f"{rc['steps_per_s_median']}); eval_last {rc['eval_last']}; build {rc['build']}; "
          f"serve p50 {rc['serve']['p50_ms']} ms, p95 {rc['serve']['p95_ms']} ms, "
          f"aggregate {rc['serve']['aggregate_rtf']}× ({smi})")
    print("\n".join("(m-a) panel " + ln for ln in rc["panel_tail"]))
    # The aot stage's artifact, served here: its launches.
    mel1 = torch.zeros((1, 256, 80), device=dev)
    exported = ExportedVocoder(run / "aot", device=dev)
    zero_counts()
    wav = exported(mel1)
    torch.cuda.synchronize()
    out["aot_launches"] = counts()
    require(tuple(wav.shape) == (1, 256 * HOP) and bool(torch.isfinite(wav).all())
            and tc(out["aot_launches"]) == 61
            and norm_pairs(out["aot_launches"]["group_norm_act"], 11, 1),
            f"aot artifact {out['aot_launches']}")
    print(f"(m-a) the aot stage's artifact (1, 256) served: launches {out['aot_launches']}")
    train_dir = str(run / "train")

    # -- (m-b) the stress panel through the trained generator ----------------------
    stress = _script("stress_eval_torch")
    out["stress"] = {}
    for how, extra in (("offline", []), ("streaming gl", ["--streaming", "gl"])):
        zero_counts()
        panel = stress.main(["--train_dir", train_dir] + extra)
        torch.cuda.synchronize()
        out["stress"][how] = {"launches": counts(), "panel": panel}
        print(f"(m-b) stress_eval_torch {how}: launches {counts()}")
    require(tc(out["stress"]["offline"]["launches"]) > 0,
            f"stress panel launches {out['stress']['offline']['launches']}")

    # -- (m-c) the roofline at its defaults ----------------------------------------
    zero_counts()
    roof = _script("roofline_torch").main([])
    torch.cuda.synchronize()
    out["roofline"] = {"launches": counts(), **roof}
    for r in roof["rows"]:
        require(r["mfu"] <= 1.0 and r["bw_frac"] <= 1.0, f"roofline row above a peak: {r}")
    b1 = next(r for r in roof["rows"] if "B1 kernel" in r["stage"])
    require(abs(b1["ms"] / b1_ms - 1) <= 0.15,
            f"roofline B1 row {b1['ms']} ms vs (l-a)'s {b1_ms} ms")
    require(tc(out["roofline"]["launches"]) > 0, f"roofline launches {counts()}")
    print(f"(m-c) roofline_torch B=128×256, train batch 16: launches {counts()}; B1 row "
          f"{b1['ms']:.2f} ms against (l-a)'s {b1_ms:.2f} ms ({smi})")
    for r in roof["rows"]:
        print(f"(m-c) roofline {r['stage']}: {r['ms']:.3f} ms, {r['flops'] / 1e9:.1f} GFLOP, "
              f"{r['bytes'] / 1e6:.1f} MB, {r['tflops_per_s']:.2f} TFLOP/s, MFU "
              f"{100 * r['mfu']:.2f}%, HBM {100 * r['bw_frac']:.2f}%, SoL {r['sol_ms']:.3f} ms, "
              f"bound {r['bound']}")

    # -- (m-d) phase timing at its defaults; utterance 0 against the CPU port -------
    pt = _script("phase_timing_torch")
    zero_counts()
    timing = pt.main([])
    out["phase_timing"] = {"launches": counts(), **timing}
    mel_c, mag_c = pt.inputs(8, 256, 0, "cpu", P)
    with torch.inference_mode():
        for row, (name, fn) in zip(timing["rows"], pt.methods(30, 5, P), strict=True):
            cpu_l1 = pt.mel_l1_rows(fn(mag_c[:1]), mel_c[:1], P)[0]
            card_l1 = row["mel_l1_rows"][0]
            row["cpu_mel_l1_row0"] = cpu_l1
            require(row["method"] == name and np.isfinite(row["device_ms"])
                    and np.isfinite(row["mel_l1"]) and card_l1 < 1.1 * cpu_l1 + 1e-3
                    and cpu_l1 < 1.1 * card_l1 + 1e-3,
                    f"phase timing {name}: card {card_l1} vs CPU {cpu_l1}")
            print(f"(m-d) phase_timing {name}: {row['device_ms']:.2f} ms, mel L1 "
                  f"{row['mel_l1']:.5f}, {row['x_rt']:.1f}× real time; utterance 0 mel L1 "
                  f"card {card_l1:.5f}, CPU port {cpu_l1:.5f} ({smi})")

    # -- (m-e) streaming: 16 streams, and a client against the port's server --------
    ss = _script("stream_serve_torch")
    out["stream_serve"] = {}
    for engine in ("gl", "lws_online"):
        zero_counts()
        r = ss.main(["--engine", engine, "--n_streams", "16", "--fidelity"])
        out["stream_serve"][engine] = {"launches": counts(), **r}
        require(r["mel_l1"] < 0.2, f"stream_serve {engine}: mel L1 {r['mel_l1']}")
        print(f"(m-e) stream_serve_torch {engine} 16 streams: p50 {r['p50_ms']} ms, p95 "
              f"{r['p95_ms']} ms, {r['ms_per_stream']} ms/stream, {r['aggregate_rtf']}× real "
              f"time, mel L1 {r['mel_l1']}, STOI {r.get('stoi')}; launches {counts()} ({smi})")
    sv = StreamingVocoder(params=P, chunk_frames=64, n_streams=16, gl_iters=16,
                          emit_dtype="int16", device=dev)
    handle = start_in_thread(sv)
    try:
        host, port_ = handle.address
        r = _script("vocode_client_torch").main(
            ["--host", host, "--port", str(port_), "--fidelity",
             "--output", str(tmp / "client.wav")])
    finally:
        handle.stop()
    out["vocode_client"] = r
    require(r["mel_l1"] < 0.2 and abs(r["seconds_out"] - 4.0) < 0.05,
            f"vocode_client {r}")
    print(f"(m-e) vocode_client_torch 4.0 s against the port's server (16 slots, gl): "
          f"{r['chunks']} chunks, p50 {r['p50_ms']} ms, p95 {r['p95_ms']} ms, "
          f"{r['seconds_out']} s out, mel L1 {r['mel_l1']} ({smi})")

    # -- (m-f) the research harnesses on the run -------------------------------------
    for name in ("projection_sweep_torch", "stoi_analysis_torch"):
        zero_counts()
        r = _script(name).main(["--train_dir", train_dir, "--n_utts", "2"])
        torch.cuda.synchronize()
        out[name] = {"launches": counts(), **r}
        require(tc(counts()) > 0, f"{name} launches {counts()}")
        print(f"(m-f) {name} --n_utts 2: launches {counts()}")
    zero_counts()
    ab = _script("quality_ab_torch").main(["--steps", "4",
                                           "--fixture_dir", str(tmp / "ab_fixture")])
    out["quality_ab"] = ab
    require(all(np.isfinite(v) for k, v in ab.items() if k.startswith("eval_")),
            f"quality_ab {ab}")
    print(f"(m-f) quality_ab_torch --steps 4 AdvocConfig() batch 16: {ab}")

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase (m) took {out['phase_s']:.1f} s")
    return out


def bench(smi: str, whole_ms: float) -> dict:
    """Phase (n): ``bench_torch.py`` run as a child process, as a user runs
    it, then with ``ADVOC_BENCH_FULL=1``; each result line checked. Its
    launches are counted by the child and reported in its line. ``whole_ms``:
    phase (m)'s roofline time of the whole call, which the headline's median
    is printed beside. Returns both result lines."""
    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    kind = torch.cuda.get_device_name(0)
    panel = {"cfg1_heuristic", "cfg3_train_step", "cfg6_long_form", "cfg7_streams_1",
             "cfg7_streams_16", "cfg5_wavegan"}
    torch.cuda.empty_cache()  # the children need the card's memory
    out: dict = {}
    for mode, full in (("headline", False), ("full", True)):
        env = {k: v for k, v in os.environ.items() if k != "ADVOC_BENCH_FULL"}
        if full:
            env["ADVOC_BENCH_FULL"] = "1"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "bench_torch.py")], cwd=root, env=env,
                              capture_output=True, text=True, timeout=400)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        if proc.returncode != 0 or not isinstance(line, dict):
            print(proc.stdout[-4000:], proc.stderr[-8000:])
        require(proc.returncode == 0 and isinstance(line, dict),
                f"bench_torch.py {mode}: rc {proc.returncode}, last line {lines[-1:]}")
        require(line["metric"] == "vocoding_realtime_factor" and line["value"] > 0,
                f"bench_torch.py {mode}: value {line['value']}")
        require(line["mfu"] is not None and 0 < line["mfu"] <= 1.05,
                f"bench_torch.py {mode}: mfu {line['mfu']}")
        require(line["device"] == kind, f"bench_torch.py {mode}: device {line['device']!r}")
        require(line["gl_launches_per_call"]["griffin_lim_tc"] == 61,
                f"bench_torch.py {mode}: B1 launches a call {line['gl_launches_per_call']}")
        require(not full or set(line.get("extended", {})) == panel,
                f"bench_torch.py {mode}: extended panel {sorted(line.get('extended', {}))}")
        if full:
            wavegan = line["extended"]["cfg5_wavegan"]
            require(0 < wavegan["mfu"] <= 1.05, f"bench_torch.py {mode}: WaveGAN {wavegan}")
        out[mode] = line
        print("\n".join(f"(n) {mode} " + ln for ln in proc.stderr.strip().splitlines()
                        if ln.startswith("[bench")))
        print(f"(n) bench_torch.py {mode} ({wall:.1f} s; {smi}): {json.dumps(line)}")
    head = out["headline"]
    print(f"(n) headline median {head['ms_median']:.3f} ms (p25 {head['ms_p25']:.3f}, p75 "
          f"{head['ms_p75']:.3f}, {head['n_trials']} trials of {head['k']}), {head['value']:.1f}× "
          f"real time, mfu {head['mfu']:.4f}; the ADVOC_BENCH_FULL run's "
          f"{out['full']['ms_median']:.3f} ms; (m-c) roofline whole call {whole_ms:.3f} ms ({smi})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase (n) took {out['phase_s']:.1f} s")
    return out


def synthetic_speech_rows(b: int, length: int, seed: int) -> np.ndarray:
    """(b, length) rows cut from one synthetic signal."""
    from advoc_tpu_torch.data.synthetic import synthetic_speech

    return synthetic_speech(seed, b * length).reshape(b, length)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.kernels import _build
    from advoc_tpu_torch.ops.kernels.featurizer import fused_melspec_kernel, fused_melspec_plain
    from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel, griffin_lim_plain
    from advoc_tpu_torch.ops.kernels.group_norm import group_norm_act_kernel
    from advoc_tpu_torch.ops.kernels.packed_up import packed_up_kernel, packed_up_plain
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS, AudioParams
    from advoc_tpu_torch.utils.roofline import (
        FP32_FLOPS_PER_S, TF32_FLOPS_PER_S, bound, feat_work, gl_bytes, gl_flops, packed_up_work,
    )

    dev = torch.device("cuda")
    # True fp32 matmuls: the plain versions and the spectral core need them.
    require(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 is False")

    # -- 1. Device and build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, sources))
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s")
    # Launch counters, one per CUDA library: (name, wrapper, attribute).
    counters = (("griffin_lim", griffin_lim_kernel, "launches"),
                ("griffin_lim_tc", griffin_lim_kernel, "tc_launches"),
                ("fused_melspec", fused_melspec_kernel, "launches"),
                ("packed_up", packed_up_kernel, "launches"),
                ("group_norm_act", group_norm_act_kernel, "launches"))

    def zero_counts() -> None:
        for _, k, attr in counters:
            setattr(k, attr, 0)

    def counts() -> dict[str, int]:
        return {name: getattr(k, attr) for name, k, attr in counters}

    def audio(b: int, length: int, seed: int) -> torch.Tensor:
        """(b, length) rows cut from one synthetic signal."""
        return torch.tensor(synthetic_speech(seed, b * length), device=dev).reshape(b, length)

    def mels(b: int, t: int, seed: int) -> torch.Tensor:
        wav = audio(1, b * t * HOP, seed)[0]
        return sp.waveform_to_r9y9_melspec(wav)[: b * t].reshape(b, t, 80)

    def mel_l1(wav: torch.Tensor, mel: torch.Tensor) -> float:
        t = mel.shape[-2]
        return float((sp.waveform_to_r9y9_melspec(wav)[..., :t, :] - mel).abs().mean())

    # -- 2. G-L kernels against their plain version, on the card ---------------
    # precision="highest", the fp32 kernels (csrc/griffin_lim.cu, 3xTF32):
    # (0) no iteration, the synthesis alone: a linear map in fp32 with K = 2048,
    # atol 1e-5 × peak (H100 runs of the 3xTF32 kernels showed 2.4e-6 × peak
    # at most).
    # (a) one iteration without momentum: the projection divides by the rebuilt
    # |u|, which is ill-conditioned where |u| is tiny. One fp32 iteration
    # differs from float64 by up to 2e-4 × peak on CPU, and kernel from plain
    # by up to 3.5e-4 × peak on an H100; atol 1e-3 × peak.
    # (m) two iterations, the second at momentum 0.99, so the momentum step of
    # the epilogue acts: fp32 differs from float64 by 3e-4 × peak on CPU;
    # atol 1e-3 × peak.
    # (b) 30 iterations at momentum 0.99 are chaotic, so only the re-extracted
    # mel L1 is compared, within 2e-3 (tests/test_pallas_gl.py's bound).
    # precision="default", the tensor-core kernel (csrc/griffin_lim_tc.cu),
    # against the split plain version:
    # (0) the synthesis alone rounds the same operands to bf16 in both and
    # sums exact products in f32: atol 1e-5 × peak (the 1024-frame case's
    # final synthesis is the fp32 kernel's).
    # (a), (m) kernel and plain sum in other orders; where y lies on a bf16
    # rounding boundary they round it to neighbouring bf16 values (2^-8
    # relative), and the projection amplifies that where |u| is tiny. The
    # difference is isolated samples, and the more samples the larger the
    # largest: H100 runs showed up to 6.3e-3 (one iteration) and 1.1e-2 (two)
    # × peak, at a mean of 2e-5 × peak, and the split plain version summed by
    # the CPU differs from itself summed on the card by the same kind of
    # spikes (printed below). atol 2e-2 and 5e-2 × peak, and a mean |Δ|
    # within 3e-4 × peak, which an error of layout, map or race would break.
    # (b) the 30-iteration mel L1 of the tensor-core kernel within 2e-3 of the
    # fp32 plain version's: the quality gate between the two modes.
    checks = {
        "highest": ((0, 0.0, 1e-5), (1, 0.0, 1e-3), (2, 0.99, 1e-3)),
        "default": ((0, 0.0, 1e-5), (1, 0.0, 2e-2), (2, 0.99, 5e-2)),
    }
    mean_rtol = 3e-4  # the split mode's mean |Δ| bound, × peak

    def hold(mag, init=None, params=DEFAULT_PARAMS, precision="highest") -> list[float]:
        """Kernel against plain for each check of ``precision``: max|Δ| / peak
        for each, then the mean |Δ| / peak of the last."""
        b, t, _ = mag.shape
        rel = []
        for n_iters, momentum, rtol in checks[precision]:
            yk = griffin_lim_kernel(mag, n_iters, momentum, init, params, precision)
            torch.cuda.synchronize()
            yp = griffin_lim_plain(mag, n_iters, momentum, init, params, precision)
            peak = float(yp.abs().max())
            err = float((yk - yp).abs().max())
            mean = float((yk - yp).abs().mean())
            require(yk.shape == (b, t * params.hop_length) and err <= rtol * peak
                    and (precision == "highest" or mean <= mean_rtol * peak),
                    f"G-L {precision} {n_iters} iters B={b} T={t} hop={params.hop_length}: "
                    f"max {err} > {rtol} × {peak} or mean {mean}")
            rel.append(err / peak)
            if (b, t) == (128, 256):
                main_errs[precision].append(err)
        return rel + [mean / peak]

    def fmt(errs: list[float]) -> str:
        return (f"0-iter {errs[0]:.2e}, 1-iter {errs[1]:.2e}, 2-iter momentum {errs[2]:.2e} "
                f"(mean {errs[3]:.1e})")

    rng = np.random.default_rng(0)
    main_errs: dict[str, list[float]] = {"highest": [], "default": []}
    gl_mag_b8: dict[int, torch.Tensor] = {}
    # B=8 at 256, 512, 768 and 1024 frames: the shapes vocode_cli's --batch 8
    # groups give the kernel in the serving phase (d); B=8 at 64 frames, a
    # partial tile: the heuristic melspecgan --vocode pipeline's in phase (j).
    # B=64 at 256 frames, a partial last 128-row tile: a shard of the
    # two-shard Vocoder(mesh=) in phase (k); B=8 at 72 frames from a carried
    # phase: a shard of the two-shard gl StreamingVocoder(mesh=) there.
    cases = [(2, 256, False), (2, 1024, False), (2, 256, True), (1, 1024, False),
             (128, 256, False), (8, 64, False), (8, 256, False), (8, 512, False),
             (8, 768, False), (8, 1024, False), (64, 256, False), (8, 72, True)]
    for b, t, with_init in cases:
        mel = mels(b, t, seed=t + b)
        mag = sp.r9y9_melspec_to_magspec(mel)[..., :512].contiguous()
        init = None
        if with_init:
            phi = torch.tensor(rng.uniform(0, 2 * np.pi, mag.shape), dtype=torch.float32,
                               device=dev)
            init = (torch.cos(phi), torch.sin(phi))
        errs = hold(mag, init)
        errs_tc = hold(mag, init, precision="default")
        l1k = mel_l1(griffin_lim_kernel(mag, 30, 0.99, init_phase=init), mel)
        l1p = mel_l1(griffin_lim_plain(mag, 30, 0.99, init_phase=init), mel)
        l1t = mel_l1(griffin_lim_kernel(mag, 30, 0.99, init_phase=init, precision="default"), mel)
        require(abs(l1k - l1p) < 2e-3, f"G-L 30 iters B={b} T={t}: mel L1 {l1k} vs {l1p}")
        require(abs(l1t - l1p) < 2e-3,
                f"G-L tensor cores 30 iters B={b} T={t}: mel L1 {l1t} vs fp32 plain {l1p}")
        # The split plain version summed by the CPU against itself on the card.
        yc = griffin_lim_plain(mag.cpu(), 1, 0.0, None if init is None else
                               tuple(x.cpu() for x in init), precision="default")
        yg = griffin_lim_plain(mag, 1, 0.0, init, precision="default").cpu()
        floor = (f"; split plain CPU vs card after 1 iter max|Δ|/peak "
                 f"{float((yc - yg).abs().max() / yg.abs().max()):.2e}")
        print(f"griffin_lim B={b} T={t} F=512 init_phase={with_init}: max|Δ|/peak fp32 kernel "
              f"{fmt(errs)}; tensor-core kernel {fmt(errs_tc)}{floor}; 30-iter mel L1 fp32 "
              f"kernel {l1k:.5f} plain {l1p:.5f}, tensor-core kernel {l1t:.5f}")
        if (b, t) == (128, 256):
            gl_mag = mag
        elif (b, t) == (1, 1024):
            gl_mag_long = mag  # B2's shape: one utterance past 256 frames
        elif (b, t, with_init) in ((8, 64, False), (8, 256, False)):
            gl_mag_b8[t] = mag  # the melspecgan --vocode pipeline's two shapes

    # Other AudioParams the kernels take (n_fft = 4 · hop): hop 512 with the
    # Nyquist bin dropped, hop 250 with a ragged F = 501 (both kernels pad it
    # to 256 and 512).
    for hop, n_bins in ((512, 1024), (250, 501)):
        q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        wav = torch.tensor(synthetic_speech(hop, 2 * 128 * hop), device=dev).reshape(2, -1)
        mag = sp.waveform_to_magspec(wav, q)[:, :128, :n_bins].contiguous()
        errs = hold(mag, params=q)
        errs_tc = hold(mag, params=q, precision="default")
        print(f"griffin_lim B=2 T=128 hop={hop} F={n_bins}: max|Δ|/peak fp32 kernel "
              f"{fmt(errs)}; tensor-core kernel {fmt(errs_tc)}")

    def gl_times(mag: torch.Tensor) -> dict[str, float]:
        """Both kernels, both plain versions and the two yardsticks at one shape."""
        b, t, f = mag.shape
        # The yardsticks: one bf16 and one fp32 matmul (allow_tf32 off: cuBLAS
        # SGEMM) at the analysis GEMM's shape, (B·T) × n_fft × 2F (timed only;
        # the port never calls them).
        a32 = torch.randn((b * t, 4 * HOP), device=dev)
        w32 = torch.randn((4 * HOP, 2 * f), device=dev)
        a16, w16 = a32.to(torch.bfloat16), w32.to(torch.bfloat16)
        return {
            "fp32_ms": cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99)),
            "tc_ms": cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99, precision="default")),
            "tc_ms_repeat": cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99, precision="default")),
            "fp32_ms_repeat": cuda_ms(lambda: griffin_lim_kernel(mag, 30, 0.99)),
            "plain_ms": cuda_ms(lambda: griffin_lim_plain(mag, 30, 0.99)),
            "plain_split_ms": cuda_ms(lambda: griffin_lim_plain(mag, 30, 0.99,
                                                                precision="default")),
            "bf16_matmul_ms": cuda_ms(lambda: a16 @ w16, reps=20),
            "fp32_matmul_ms": cuda_ms(lambda: a32 @ w32, reps=20),
        }

    times = gl_times(gl_mag)
    gl_ms, gl_tc_ms, plain_ms = times["fp32_ms"], times["tc_ms"], times["plain_ms"]
    flops = gl_flops(128, 256, 512, 30)
    bound_tc, _ = bound(flops, gl_bytes(128, 256, 512))
    bound_fp32, _ = bound(flops, gl_bytes(128, 256, 512), FP32_FLOPS_PER_S)

    def bound_3xtf32(b: int, t: int) -> float:
        """The fp32 kernels' ceiling: every product three times at the TF32 rate."""
        return bound(3 * gl_flops(b, t, 512, 30), gl_bytes(b, t, 512), TF32_FLOPS_PER_S)[0]

    print(f"griffin_lim B=128 T=256 F=512 30 iters: fp32 kernel {gl_ms:.2f} ms "
          f"(repeat {times['fp32_ms_repeat']:.2f}, {3 * flops / gl_ms / 1e9:.1f} TFLOP/s of "
          f"3xTF32 work), tensor-core kernel {gl_tc_ms:.2f} ms (repeat "
          f"{times['tc_ms_repeat']:.2f}, {1.5 * flops / gl_tc_ms / 1e9:.1f} TFLOP/s of split "
          f"work), plain fp32 {plain_ms:.2f} ms, plain split {times['plain_split_ms']:.2f} ms, "
          f"bf16 matmul yardstick {times['bf16_matmul_ms']:.3f} ms, fp32 matmul yardstick "
          f"{times['fp32_matmul_ms']:.3f} ms; {flops / 1e12:.3f} TFLOP; bound {bound_tc:.2f} ms "
          f"at bf16 tensor cores, 3xTF32 ceiling {bound_3xtf32(128, 256):.2f} ms, fp32 "
          f"CUDA-core ceiling {bound_fp32:.2f} ms")
    # The fp32 kernels at the melspecgan pipeline's shapes (phase (j)).
    fp32_b8 = {}
    for t, mag in gl_mag_b8.items():
        fp32_b8[t] = {"ms": cuda_ms(lambda m=mag: griffin_lim_kernel(m, 30, 0.99)),
                      "plain_ms": cuda_ms(lambda m=mag: griffin_lim_plain(m, 30, 0.99)),
                      "bound_ms": bound(gl_flops(8, t, 512, 30), gl_bytes(8, t, 512))[0],
                      "bound_ms_3xtf32": bound_3xtf32(8, t)}
        print(f"griffin_lim B=8 T={t} F=512 30 iters: fp32 kernel {fp32_b8[t]['ms']:.3f} ms, "
              f"plain fp32 {fp32_b8[t]['plain_ms']:.3f} ms, bound {fp32_b8[t]['bound_ms']:.4f} ms, "
              f"3xTF32 ceiling {fp32_b8[t]['bound_ms_3xtf32']:.4f} ms")

    # -- 2b. Fused featurizer (B3) against its plain version --------------------
    # 3xTF32 tensor-core products against fp32 matmuls over the same n_fft
    # samples: max|Δ| ≤ 2e-4 in normalized units (H100 runs measured 2.8e-5
    # to 4.2e-5; one bf16 hi/lo split misses by 1e-3 on a quiet stretch,
    # tests/test_torch_featurizer.py); against the STFT path (impl="xla") on
    # the first L//hop frames ≤ 3e-3 (tests/test_pallas.py's bound between
    # the two paths). The quiet cases scale a stretch of their second row to
    # 1e-3: the quiet bins where reduced precision fails. B=128 takes
    # 128-frame tiles, the rest 64; hop 200 pads its blocks to 208 samples,
    # and hop 512 (44.1 kHz, n_fft 2048) runs a shorter ring.
    feat_err = 0.0
    for b, length, quiet, q in ((128, 256 * HOP, False, DEFAULT_PARAMS),
                                (2, 300 * HOP + 77, False, DEFAULT_PARAMS),
                                (1, 1024 * HOP, False, DEFAULT_PARAMS),
                                (2, 300 * HOP + 77, True, DEFAULT_PARAMS),
                                (2, 300 * 200 + 77, True,
                                 AudioParams(n_fft=800, hop_length=200, win_length=800)),
                                (2, 300 * 512 + 77, True,
                                 AudioParams(sample_rate=44100, n_fft=2048, hop_length=512,
                                             win_length=2048))):
        hop = q.hop_length
        wav = audio(b, length, seed=b + length)
        if quiet:
            wav[1, 20 * hop : 280 * hop] *= 1e-3
        got = fused_melspec_kernel(wav, q)
        torch.cuda.synchronize()
        err = float((got - fused_melspec_plain(wav, q)).abs().max())
        err_xla = float((got - sp.waveform_to_r9y9_melspec(wav, q)[:, : length // hop])
                        .abs().max())
        require(tuple(got.shape) == (b, length // hop, 80) and err <= 2e-4 and err_xla <= 3e-3,
                f"featurizer B={b} L={length} hop={hop} quiet={quiet}: shape "
                f"{tuple(got.shape)}, max|Δ| {err} vs plain, {err_xla} vs xla")
        print(f"featurizer B={b} L={length} hop={hop} quiet row={quiet}: max|Δ| vs plain "
              f"{err:.2e}, vs impl='xla' {err_xla:.2e}")
        if b == 128:
            feat_err, feat_wav = err, wav
        elif (b, length) == (1, 1024 * HOP):
            feat_wav_long = wav  # one 1024-frame utterance: 16 CTAs of 64 frames
    feat_long_ms = cuda_ms(lambda: fused_melspec_kernel(feat_wav_long), reps=20)
    feat_long_plain_ms = cuda_ms(lambda: fused_melspec_plain(feat_wav_long), reps=20)
    feat_long_xla_ms = cuda_ms(lambda: sp.waveform_to_r9y9_melspec(feat_wav_long), reps=20)
    feat_long_bound, _ = bound(*feat_work(1, 1024 * HOP))
    feat_ms = cuda_ms(lambda: fused_melspec_kernel(feat_wav))
    feat_plain_ms = cuda_ms(lambda: fused_melspec_plain(feat_wav))
    feat_xla_ms = cuda_ms(lambda: sp.waveform_to_r9y9_melspec(feat_wav))
    feat_flops, feat_bytes = feat_work(128, 256 * HOP)
    feat_bound, feat_by = bound(feat_flops, feat_bytes)
    # The form's ceiling: 3xTF32 does every product three times at the TF32 rate.
    feat_ceiling = bound(3 * feat_flops, 0.0, TF32_FLOPS_PER_S)[0]
    print(f"featurizer B=128 L={256 * HOP}: kernel {feat_ms:.3f} ms "
          f"({feat_flops / feat_ms / 1e9:.1f} TFLOP/s of the work counted once, "
          f"{3 * feat_flops / feat_ms / 1e9:.1f} of 3xTF32 products), plain "
          f"{feat_plain_ms:.3f} ms, impl='xla' {feat_xla_ms:.3f} ms; bound {feat_bound:.4f} ms "
          f"({feat_by}), 3xTF32 ceiling {feat_ceiling:.3f} ms")
    print(f"featurizer B=1 L={1024 * HOP}: kernel {feat_long_ms:.4f} ms, plain "
          f"{feat_long_plain_ms:.4f} ms, impl='xla' {feat_long_xla_ms:.4f} ms; bound "
          f"{feat_long_bound:.5f} ms")

    # -- 2c. Packed-tail transpose-conv (B4) against its plain version ----------
    # y within 1e-2 × peak (about two bf16 ulps: the two sum in other orders
    # before rounding, so a value can round to the neighbouring bf16); Σy, Σy²
    # within 1e-3 relative of f32 sums of the kernel's own output.
    def up_inputs(b, h, w, cin, f, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randn((4, 4, cin, f), generator=g, device=dev) / (16 * cin) ** 0.5
        return x, wt, 0.1 * torch.randn(f, generator=g, device=dev)

    up_err = 0.0
    # The full-width finest level: cin 192 = 128 from the level below + 64 skip.
    # cin 200 pads to 256, which leaves room for one x stage per warpgroup.
    for b, h, w, cin, f, tm in ((128, 128, 128, 192, 64, 16), (128, 128, 128, 128, 64, 16),
                                (2, 32, 72, 24, 40, 8), (1, 32, 40, 200, 40, 8)):
        x, wt, bias = up_inputs(b, h, w, cin, f, seed=h + w)
        y, s1, s2 = packed_up_kernel(x, wt, bias, f=f, tm=tm, with_stats=True)
        torch.cuda.synchronize()
        want = packed_up_plain(x, wt, bias, f=f, tm=tm).float()
        err = float((y.float() - want).abs().max())
        peak = float(want.abs().max())
        yf = y.float()
        r1 = float(((s1 - yf.sum(dim=(1, 2))).abs() / yf.abs().sum(dim=(1, 2))).max())
        r2 = float(((s2 - (yf * yf).sum(dim=(1, 2))).abs() / (yf * yf).sum(dim=(1, 2))).max())
        require(tuple(y.shape) == (b, 2 * h, w, 2 * f) and err <= 1e-2 * peak
                and r1 <= 1e-3 and r2 <= 1e-3,
                f"packed_up B={b} H={h} W={w} cin={cin} f={f} tm={tm}: max|Δ| {err} "
                f"(peak {peak}), Σy {r1}, Σy² {r2}")
        print(f"packed_up B={b} H={h} W={w} cin={cin} f={f} tm={tm}: max|Δ| {err:.3e} "
              f"= {err / peak:.2e} × peak; Σy rel {r1:.2e}, Σy² rel {r2:.2e}")
        if (h, w, cin, f) == (128, 128, 192, 64):  # the full-width finest level
            up_err, up_args = err, (x, wt, bias)
        if cin == 128:  # the same layer with a 128-channel concat, timed for comparison
            up128_ms = cuda_ms(lambda: packed_up_kernel(x, wt, bias, f=f, tm=tm, with_stats=True))
        del y, s1, s2, want, yf
    x, wt, bias = up_args
    up_ms = cuda_ms(lambda: packed_up_kernel(x, wt, bias, f=64, tm=16, with_stats=True))
    up_plain_ms = cuda_ms(lambda: packed_up_plain(x, wt, bias, f=64, tm=16, with_stats=True))
    # The library route of the default config: cuDNN's transpose-conv on the
    # same input and weights (NCHW), then the Σy, Σy² pass its GroupNorm needs.
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_t = wt.flip(0, 1).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
    b_t = bias.to(torch.bfloat16)

    def library_up():
        yt = torch.nn.functional.conv_transpose2d(x_nchw, w_t, b_t, stride=2, padding=1)
        yf = yt.float()
        return yt, yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))

    lib_y = library_up()[0]
    lib_err = float((lib_y.permute(0, 2, 3, 1).reshape(128, 256, 128, 128).float()
                     - packed_up_kernel(x, wt, bias, f=64).float()).abs().max())
    del lib_y
    up_lib_ms = cuda_ms(library_up)
    up_conv_ms = cuda_ms(lambda: torch.nn.functional.conv_transpose2d(
        x_nchw, w_t, b_t, stride=2, padding=1))
    up_flops, up_bytes = packed_up_work(128, 128, 128, 192, 64)
    up_bound, up_by = bound(up_flops, up_bytes)
    print(f"packed_up B=128 H=W=128 cin=192 f=64: kernel {up_ms:.3f} ms "
          f"({up_flops / up_ms / 1e9:.1f} TFLOP/s), plain {up_plain_ms:.3f} ms, cuDNN "
          f"conv_transpose2d + Σy/Σy² {up_lib_ms:.3f} ms (conv alone {up_conv_ms:.3f} ms, "
          f"max|Δ| to the kernel {lib_err:.3e}); bound {up_bound:.4f} ms ({up_by}); "
          f"at cin=128 the kernel takes {up128_ms:.3f} ms")
    del x, wt, bias, up_args, x_nchw

    # -- 2d. GroupNorm + activation against its plain version -------------------
    gn_row = group_norm(dev)

    # -- 3. Main path: full-width Vocoder ---------------------------------------
    cfg = AdvocConfig()
    gen = AdvocGenerator(cfg)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    gen_cpu = copy.deepcopy(gen)
    voc = Vocoder(gen, device="cuda")
    batch = mels(128, 256, seed=1)
    utter = mels(1, 1024, seed=2)[0]

    # The default (split) mode: the batch is B1's case, 2·30 + 1 tensor-core
    # launches; the utterance B2's, 2·30 tensor-core launches and the f32
    # final synthesis, one fp32 gl_synth_ola. No fp32 loop kernel.
    gl_path = {"griffin_lim": 1, "griffin_lim_tc": 2 * 30 + 1 + 2 * 30}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    wav = voc(batch)
    wav_long = voc(utter)
    torch.cuda.synchronize()
    voc_launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # One generator call a Vocoder call: the GroupNorm pair at each of 11 levels.
    require(voc_launches == {**gl_path, "fused_melspec": 0, "packed_up": 0,
                             "group_norm_act": 2 * 2 * 11},
            f"kernel launches on the main path: {voc_launches}")
    for name, w, shape in (("batch", wav, (128, 256 * HOP)), ("utterance", wav_long, (1024 * HOP,))):
        require(tuple(w.shape) == shape, f"{name} shape {tuple(w.shape)}")
        require(bool(torch.isfinite(w).all()), f"{name} finite")
        require(float(w.abs().max()) < 1.0, f"{name} peak {float(w.abs().max())} < 1")
    l1_batch, l1_long = mel_l1(wav, batch), mel_l1(wav_long, utter)
    print(f"vocoder full width: launches {voc_launches}, batch 128×256 mel L1 {l1_batch:.5f}, "
          f"1024-frame utterance mel L1 {l1_long:.5f}, peak memory {peak_gb:.2f} GB")

    # gl_precision="highest" takes the fp32 kernels alone (2·30 + 1 launches).
    voc_hi = Vocoder(gen, device="cuda", gl_precision="highest")
    zero_counts()
    wav_hi = voc_hi(batch)
    torch.cuda.synchronize()
    hi_launches = counts()
    require(hi_launches == {"griffin_lim": 2 * 30 + 1, "griffin_lim_tc": 0,
                            "fused_melspec": 0, "packed_up": 0, "group_norm_act": 2 * 11},
            f"kernel launches at gl_precision='highest': {hi_launches}")
    l1_hi = mel_l1(wav_hi, batch)
    require(abs(l1_batch - l1_hi) < 2e-3, f"mel L1 default {l1_batch} vs highest {l1_hi}")
    print(f"vocoder gl_precision='highest': launches {hi_launches}, batch 128×256 mel L1 "
          f"{l1_hi:.5f} (default {l1_batch:.5f})")
    del wav_hi

    # Agreement with the JAX-twin path on a small input: the same generator on
    # the CPU with the matmul G-L scan. The kernel iterates on the uncropped
    # signal, so its mel L1 stays within tests/test_pallas_gl.py's 10% band.
    small = batch[:1].cpu()
    ref_l1 = mel_l1(Vocoder(gen_cpu, device="cpu", phase_impl="xla")(small), small)
    got_l1 = mel_l1(voc(small.to(dev)).cpu(), small)
    require(got_l1 < 1.1 * ref_l1 + 1e-3, f"mel L1 on card {got_l1} vs CPU scan {ref_l1}")
    print(f"vocoder 1×256 against the CPU matmul-scan reference: mel L1 {got_l1:.5f} "
          f"vs {ref_l1:.5f}")

    # Where the time goes, stage by stage on the batch.
    p = voc.params
    est = sp.r9y9_melspec_to_magspec(batch)
    est_norm = sp.normalize_db(sp.amp_to_db(est) - p.ref_level_db)
    with torch.inference_mode():
        mag = sp.db_to_amp(sp.denormalize_db(gen(est_norm)) + p.ref_level_db)
        stages = {
            "estimate_ms": cuda_ms(lambda: sp.normalize_db(
                sp.amp_to_db(sp.r9y9_melspec_to_magspec(batch)) - p.ref_level_db)),
            "unet_ms": cuda_ms(lambda: gen(est_norm)),
            "projection_ms": cuda_ms(lambda: sp.mel_consistency_project(mag, batch)),
            "griffin_lim_ms": gl_tc_ms,
        }
    call_ms = cuda_ms(lambda: voc(batch))
    call_hi_ms = cuda_ms(lambda: voc_hi(batch))
    long_ms = cuda_ms(lambda: voc(utter))
    times_long = gl_times(gl_mag_long)
    audio_s = 128 * 256 * HOP / SR
    print("stages B=128×256: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"vocoder call B=128×256: {call_ms:.2f} ms = {audio_s / (call_ms / 1e3):.1f}× real time; "
          f"1024-frame utterance {long_ms:.2f} ms = "
          f"{1024 * HOP / SR / (long_ms / 1e3):.1f}× real time; at gl_precision='highest' "
          f"the B=128 call takes {call_hi_ms:.2f} ms")
    gl_long_bound, _ = bound(gl_flops(1, 1024, 512, 30), gl_bytes(1, 1024, 512))
    print(f"griffin_lim B=1 T=1024 F=512 30 iters (B2's shape): fp32 kernel "
          f"{times_long['fp32_ms']:.2f} ms (repeat {times_long['fp32_ms_repeat']:.2f}), "
          f"tensor-core kernel {times_long['tc_ms']:.2f} ms (repeat "
          f"{times_long['tc_ms_repeat']:.2f}), plain fp32 {times_long['plain_ms']:.2f} ms, "
          f"plain split {times_long['plain_split_ms']:.2f} ms, bf16 matmul yardstick "
          f"{times_long['bf16_matmul_ms']:.3f} ms, fp32 matmul yardstick "
          f"{times_long['fp32_matmul_ms']:.3f} ms, bound {gl_long_bound:.4f} ms at bf16 "
          f"tensor cores, 3xTF32 ceiling {bound_3xtf32(1, 1024):.4f} ms")

    def trace(name: str, fn, kernel_names: tuple[str, ...]) -> None:
        """Device trace of one call: the busy share, and the kernels that take
        the time (kernels run on one stream, so their sum is the busy time)."""
        wall_ms, by_name = device_trace(fn)
        busy_ms = sum(ms for ms, _ in by_name.values())
        if busy_ms <= 0:
            print(f"device trace {name}: not measured (the profiler recorded no device time)")
            return
        ours = sum(ms for k, (ms, _) in by_name.items() if any(n in k for n in kernel_names))
        print(f"device trace {name}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, "
              f"busy share {busy_ms / wall_ms:.3f}, port kernels {ours:.2f} ms")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        # The ten that take the most time, then every port kernel below them.
        for rank, (k, (ms, n)) in enumerate(ranked):
            if rank < 10 or any(n_ in k for n_ in kernel_names):
                print(f"  {ms:8.2f} ms {n:4d}×  {k[:90]}")

    gl_names = ("gl_tc_kernel", "gl_tf32_kernel")
    trace("vocoder B=128×256", lambda: voc(batch), gl_names)

    # -- 4. Packed-tail generator against the default one, same weights ----------
    # tests/test_models.py's bf16 bound between the two tails: 4e-2 absolute,
    # mean |Δ| < 5e-3 (the two round the transpose-conv in other places).
    gen_pk = AdvocGenerator(dataclasses.replace(cfg, packed_tail=True))
    gen_pk.load_state_dict(gen.state_dict(), strict=True)
    gen_pk = gen_pk.to(dev).eval()
    zero_counts()
    with torch.inference_mode():
        out_pk, out_def = gen_pk(est_norm), gen(est_norm)
    torch.cuda.synchronize()
    d = (out_pk - out_def).abs()
    require(packed_up_kernel.launches == 1, f"B4 launches: {packed_up_kernel.launches}")
    require(float(d.max()) <= 4e-2 and float(d.mean()) < 5e-3,
            f"packed-tail vs default generator: max {float(d.max())}, mean {float(d.mean())}")
    print(f"packed-tail generator vs default B=128×256, same weights: max|Δ| "
          f"{float(d.max()):.3e}, mean|Δ| {float(d.mean()):.3e}")
    with torch.inference_mode():
        unet_pk_ms = cuda_ms(lambda: gen_pk(est_norm))
    del out_pk, out_def, d

    # -- 5. The slice's path: wav → fused featurizer → packed-tail Vocoder → wav
    voc_pk = Vocoder(gen_pk, device="cuda")
    wav_in = audio(128, 256 * HOP, seed=3)
    wav_in_long = audio(1, 1024 * HOP, seed=4)[0]

    def copy_synth(x: torch.Tensor) -> torch.Tensor:
        return voc_pk(sp.waveform_to_r9y9_melspec(x, impl="kernel"))

    zero_counts()
    out = copy_synth(wav_in)
    out_long = copy_synth(wav_in_long)
    torch.cuda.synchronize()
    slice_launches = counts()
    # The packed tail normalises its finest level itself: 10 GroupNorm pairs a call.
    require(slice_launches == {**gl_path, "fused_melspec": 2, "packed_up": 2,
                               "group_norm_act": 2 * 2 * 10},
            f"kernel launches on the slice's path: {slice_launches}")
    for name, w, shape in (("batch", out, (128, 256 * HOP)), ("utterance", out_long, (1024 * HOP,))):
        require(tuple(w.shape) == shape, f"slice {name} shape {tuple(w.shape)}")
        require(bool(torch.isfinite(w).all()), f"slice {name} finite")
        require(float(w.abs().max()) < 1.0, f"slice {name} peak {float(w.abs().max())} < 1")
    slice_l1 = []
    for x_in, w in ((wav_in, out), (wav_in_long, out_long)):
        mel = fused_melspec_kernel(x_in)
        l1_pk, l1_def = mel_l1(w, mel), mel_l1(voc(mel), mel)
        require(abs(l1_pk - l1_def) <= 2e-3,
                f"slice mel L1 {l1_pk} vs default-generator Vocoder {l1_def}")
        slice_l1.append((l1_pk, l1_def))
    print(f"slice wav→mel→wav: launches {slice_launches}; mel L1 batch 128×256 "
          f"{slice_l1[0][0]:.5f} (default generator {slice_l1[0][1]:.5f}), 1024-frame "
          f"utterance {slice_l1[1][0]:.5f} (default generator {slice_l1[1][1]:.5f})")
    slice_ms = cuda_ms(lambda: copy_synth(wav_in))
    slice_long_ms = cuda_ms(lambda: copy_synth(wav_in_long))
    print(f"U-Net B=128×256: default {stages['unet_ms']:.2f} ms, packed tail {unet_pk_ms:.2f} ms")
    print(f"slice call wav→wav B=128×256: {slice_ms:.2f} ms = "
          f"{audio_s / (slice_ms / 1e3):.1f}× real time; 1024-frame utterance "
          f"{slice_long_ms:.2f} ms = {1024 * HOP / SR / (slice_long_ms / 1e3):.1f}× real time")
    trace("slice wav→wav B=128×256", lambda: copy_synth(wav_in),
          gl_names + ("featurizer_kernel", "packed_up_kernel", "reduce_parts_kernel"))

    # -- 6. The serving path -----------------------------------------------------
    served = serving(dev, gen, voc, mels, mel_l1, zero_counts, counts)
    lws_phases(dev, gen, voc, mels, mel_l1, zero_counts, counts)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        trained = training(pathlib.Path(tmp), dev, mel_l1, zero_counts, counts)
        fam = families(pathlib.Path(tmp), dev, mel_l1, zero_counts, counts)
    par = parallel(dev, gen, voc, mels, mel_l1, zero_counts, counts, smi)
    rest = rest_of_package(dev, gen, voc, voc_pk, mels, mel_l1, zero_counts, counts, gl_mag,
                           gl_mag_long, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tool = tools(pathlib.Path(tmp), dev, zero_counts, counts, smi,
                     rest["modes"]["split"]["ms_split_synth"])
    bn = bench(smi, next(r["ms"] for r in tool["roofline"]["rows"]
                         if r["stage"].startswith("WHOLE")))

    # -- 7. Kernels line, then the result ---------------------------------------
    print(json.dumps({"kernels": [{
        "name": "griffin_lim",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "advoc_tpu/ops/pallas/griffin_lim.py:362",
        "replaces_all": [
            "advoc_tpu/ops/pallas/griffin_lim.py:362 griffin_lim_pallas",
            "advoc_tpu/ops/pallas/griffin_lim.py:482 griffin_lim_pallas_tiled",
        ],
        "precision": "highest",
        "design": "3xTF32 wgmma m64n128k8 (A = the f32 carries or y by TMA, split in "
                  "registers; B = TMA-fed big and small map tiles), each stage's products "
                  "summed into an f32 accumulator in registers",
        "launches": slice_launches["griffin_lim"],
        "launches_vocoder_path": voc_launches["griffin_lim"],
        "launches_vocoder_highest": hi_launches["griffin_lim"],
        "launches_vocode_cli": served["cli_launches"]["griffin_lim"],
        "launches_streaming": served["stream_launches"]["griffin_lim"],
        "launches_train_eval": trained["eval_launches"]["griffin_lim"],
        "launches_train_infer": trained["infer_launches"]["griffin_lim"],
        "launches_melspecgan_vocode": fam["pipeline"]["vocode"]["launches"]["griffin_lim"],
        "launches_melspecgan_advoc": fam["pipeline"]["advoc"]["launches"]["griffin_lim"],
        "launches_vocoder_mesh": par["vocoder_launches"]["griffin_lim"],
        "checks": "pass",
        "max_abs_err": max(main_errs["highest"]),
        "ms": gl_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_tc,
        "bound_by": "operations",
        "bound_ms_3xtf32": bound_3xtf32(128, 256),
        "bound_ms_fp32_cuda_cores": bound_fp32,
        "vocoder_highest_call_ms": call_hi_ms,
        "ms_b1_t1024": times_long["fp32_ms"],
        "plain_ms_b1_t1024": times_long["plain_ms"],
        "bound_ms_b1_t1024": gl_long_bound,
        "bound_ms_3xtf32_b1_t1024": bound_3xtf32(1, 1024),
        **{f"{k}_b8_t{t}": v for t, row in fp32_b8.items() for k, v in row.items()},
        "library_ms": times["fp32_matmul_ms"],
        "library": "one fp32 torch.matmul (allow_tf32 off) at the analysis GEMM's shape, "
                   "(B·T) × n_fft × 2F",
        "library_ms_b1_t1024": times_long["fp32_matmul_ms"],
    }, {
        "name": "griffin_lim_tc",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/griffin_lim_tc.cu",
        "replaces": "advoc_tpu/ops/pallas/griffin_lim.py:362",
        "replaces_all": [
            "advoc_tpu/ops/pallas/griffin_lim.py:362 griffin_lim_pallas",
            "advoc_tpu/ops/pallas/griffin_lim.py:482 griffin_lim_pallas_tiled",
        ],
        "precision": "default",
        "launches": slice_launches["griffin_lim_tc"],
        "launches_vocoder_path": voc_launches["griffin_lim_tc"],
        "launches_vocode_cli": served["cli_launches"]["griffin_lim_tc"],
        "launches_streaming": served["stream_launches"]["griffin_lim_tc"],
        "launches_train_eval": trained["eval_launches"]["griffin_lim_tc"],
        "launches_train_infer": trained["infer_launches"]["griffin_lim_tc"],
        "launches_melspecgan_vocode": fam["pipeline"]["vocode"]["launches"]["griffin_lim_tc"],
        "launches_melspecgan_advoc": fam["pipeline"]["advoc"]["launches"]["griffin_lim_tc"],
        "launches_vocoder_mesh": par["vocoder_launches"]["griffin_lim_tc"],
        "launches_stress_panel": rest["eval"]["launches"]["griffin_lim_tc"],
        "launches_exported_vocoder": rest["export_default"]["launches"]["griffin_lim_tc"],
        "launches_tools_run_corpus_aot_artifact": tool["aot_launches"]["griffin_lim_tc"],
        "launches_tools_stress_panel_trained": tool["stress"]["offline"]["launches"][
            "griffin_lim_tc"],
        "launches_tools_roofline": tool["roofline"]["launches"]["griffin_lim_tc"],
        "launches_tools_projection_sweep": tool["projection_sweep_torch"]["launches"][
            "griffin_lim_tc"],
        "launches_tools_stoi_analysis": tool["stoi_analysis_torch"]["launches"]["griffin_lim_tc"],
        "launches_bench_torch_per_call": bn["headline"]["gl_launches_per_call"]["griffin_lim_tc"],
        "ms_b8_t64": fam["pipeline"]["vocode"]["b1_ms"],
        "bound_ms_b8_t64": fam["pipeline"]["vocode"]["b1_bound_ms"],
        "ms_b8_t256": fam["pipeline"]["advoc"]["b1_ms"],
        "bound_ms_b8_t256": fam["pipeline"]["advoc"]["b1_bound_ms"],
        "checks": "pass",
        "max_abs_err": max(main_errs["default"]),
        "ms": gl_tc_ms,
        "plain_ms": times["plain_split_ms"],
        "bound_ms": bound_tc,
        "bound_by": "operations",
        "ms_b1_t1024": times_long["tc_ms"],
        "plain_ms_b1_t1024": times_long["plain_split_ms"],
        "bound_ms_b1_t1024": gl_long_bound,
        "library_ms": times["bf16_matmul_ms"],
        "library": "one bf16 torch.matmul at the analysis GEMM's shape, (B·T) × n_fft × 2F",
        "library_ms_b1_t1024": times_long["bf16_matmul_ms"],
    }, *({
        "name": f"griffin_lim_tc[{mode}]",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/griffin_lim_tc.cu",
        "replaces": "advoc_tpu/ops/pallas/griffin_lim.py:362",
        "replaces_all": [
            "advoc_tpu/ops/pallas/griffin_lim.py:362 griffin_lim_pallas",
            "advoc_tpu/ops/pallas/griffin_lim.py:482 griffin_lim_pallas_tiled",
        ],
        "loop_dtype": mode,
        "launches": row["launches"]["griffin_lim_tc"],
        "checks": "pass",
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "ms_split_synth_same_turn": row["ms_split_synth"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "operations",
        "ms_b1_t1024": row["ms_b1_t1024"],
        "plain_ms_b1_t1024": row["plain_ms_b1_t1024"],
        "bound_ms_b1_t1024": row["bound_ms_b1_t1024"],
        "mel_l1_gap_to_fp32": row["gap"],
        "library_ms": None,
    } for mode, row in rest["modes"].items()), {
        "name": "fused_melspec",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/featurizer.cu",
        "replaces": "advoc_tpu/ops/pallas/featurizer.py:123",
        "design": "3xTF32 wgmma (A = the audio window from registers, B = TMA-fed split "
                  "maps), mel fold as a second 3xTF32 wgmma on |X| from the accumulator",
        "launches": slice_launches["fused_melspec"],
        "launches_stress_panel": rest["eval"]["launches"]["fused_melspec"],
        "checks": "pass",
        "max_abs_err": feat_err,
        "ms": feat_ms,
        "plain_ms": feat_plain_ms,
        "bound_ms": feat_bound,
        "bound_by": feat_by,
        "bound_ms_3xtf32": feat_ceiling,
        "xla_ms": feat_xla_ms,
        "ms_b1_l262144": feat_long_ms,
        "plain_ms_b1_l262144": feat_long_plain_ms,
        "xla_ms_b1_l262144": feat_long_xla_ms,
        "bound_ms_b1_l262144": feat_long_bound,
        "library_ms": None,
    }, {
        "name": "packed_up",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/packed_up.cu",
        "replaces": "advoc_tpu/ops/pallas/packed_up.py:141",
        "design": "bf16 wgmma m64n128k16 on y^T (A = resident class weights, B = TMA boxes "
                  "of x, one per input row for both column taps), TMA store of y",
        "launches": slice_launches["packed_up"],
        "launches_exported_vocoder": rest["export_packed_tail"]["launches"]["packed_up"],
        "checks": "pass",
        "max_abs_err": up_err,
        "ms": up_ms,
        "plain_ms": up_plain_ms,
        "bound_ms": up_bound,
        "bound_by": up_by,
        "library_ms": up_lib_ms,
        "library": "F.conv_transpose2d (cuDNN) + Σy, Σy² pass",
        "library_conv_only_ms": up_conv_ms,
    }, {
        "name": "group_norm_act",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/group_norm.cu",
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package leaves GroupNorm to XLA",
        "design": "a statistics pass (16-byte loads in the convolution's layout, per-channel "
                  "f32 sums in registers, fixed-order partials per (unit, tile, group)) and a "
                  "normalise-activate pass (the plain formula op by op, bf16 out in x's layout)",
        "launches_vocoder_path": voc_launches["group_norm_act"],
        "launches_exported_vocoder": rest["export_default"]["launches"]["group_norm_act"],
        "checks": "pass",
        "ms": gn_row["ms"],
        "ms_up5": gn_row["levels"]["up5"]["ms"],
        "plain_ms": gn_row["plain_ms"],
        "bound_ms": gn_row["bound_ms"],
        "bound_ms_up5": gn_row["levels"]["up5"]["bound_ms"],
        "two_pass_ms": gn_row["two_pass_ms"],
        "bound_by": "bytes",
        "levels": gn_row["levels"],
        "library_ms": gn_row["library_ms"],
        "library": "F.group_norm (bf16 weights) + the activation, timed only",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
