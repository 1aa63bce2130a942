#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``advoc_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``advoc_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, then drives the
offline ``Vocoder`` at the full default width (random weights from a seed) on
B=128 × 256-frame mels and on one 1024-frame utterance, and checks that the
G-L kernel carried that path and that the waveform is right. Prints one line
per check, the card's name and power limit, a JSON line of kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``. Any failed phase
exits nonzero; without a CUDA device it exits 1 and prints no result.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SR, HOP = 22050, 256
FP32_TFLOPS = 67.0  # H100 SXM, CUDA cores (NVIDIA data sheet)
BF16_TC_TFLOPS = 989.0  # H100 SXM, dense bf16 tensor cores
HBM_TBPS = 3.35


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def gl_flops(b: int, t: int, f: int, n_iters: int) -> float:
    """Matmul FLOP of one fast-G-L call: synthesis 2·(2·T·F·n_fft) and
    analysis 4·2·(2·T·hop·F) per row and iteration, plus the final synthesis."""
    synth = 2 * (2 * t * f * 4 * HOP)
    anal = 4 * 2 * (2 * t * HOP * f)
    return b * (n_iters * (synth + anal) + synth)


def gl_bytes(b: int, t: int, f: int) -> float:
    """Each input read once (mag, four maps, norm), the output written once."""
    return 4 * (b * t * f + 4 * 4 * HOP * f + (t + 3) * HOP + b * t * HOP)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
    from advoc_tpu_torch.ops import spectral as sp
    from advoc_tpu_torch.ops.kernels import _build
    from advoc_tpu_torch.ops.kernels.griffin_lim import griffin_lim_kernel, griffin_lim_plain
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS, AudioParams

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
    for name in sources:
        _build.build(name)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s")

    def mels(b: int, t: int, seed: int) -> torch.Tensor:
        wav = torch.tensor(synthetic_speech(seed, b * t * HOP), device=dev)
        return sp.waveform_to_r9y9_melspec(wav)[: b * t].reshape(b, t, 80)

    def mel_l1(wav: torch.Tensor, mel: torch.Tensor) -> float:
        t = mel.shape[-2]
        return float((sp.waveform_to_r9y9_melspec(wav)[..., :t, :] - mel).abs().mean())

    # -- 2. Kernel against its plain version, on the card ----------------------
    # (0) no iteration, the synthesis alone: a linear map in fp32 with K = 2048,
    # atol 1e-5 × peak (an H100 run showed 6e-7 × peak at most).
    # (a) one iteration without momentum: the projection divides by the rebuilt
    # |u|, which is ill-conditioned where |u| is tiny. One fp32 iteration
    # differs from float64 by up to 2e-4 × peak on CPU, and kernel from plain
    # by up to 3.5e-4 × peak on an H100; atol 1e-3 × peak.
    # (m) two iterations, the second at momentum 0.99, so the momentum step of
    # the epilogue acts: fp32 differs from float64 by 3e-4 × peak on CPU;
    # atol 1e-3 × peak.
    # (b) 30 iterations at momentum 0.99 are chaotic, so only the re-extracted
    # mel L1 is compared, within 2e-3 (tests/test_pallas_gl.py's bound).
    checks = ((0, 0.0, 1e-5), (1, 0.0, 1e-3), (2, 0.99, 1e-3))

    def hold(mag, init=None, params=DEFAULT_PARAMS) -> list[float]:
        """Kernel against plain for each of ``checks``: max|Δ| / peak."""
        b, t, _ = mag.shape
        rel = []
        for n_iters, momentum, rtol in checks:
            yk = griffin_lim_kernel(mag, n_iters, momentum, init_phase=init, params=params)
            torch.cuda.synchronize()
            yp = griffin_lim_plain(mag, n_iters, momentum, init_phase=init, params=params)
            peak = float(yp.abs().max())
            err = float((yk - yp).abs().max())
            require(yk.shape == (b, t * params.hop_length) and err <= rtol * peak,
                    f"G-L {n_iters} iters B={b} T={t} hop={params.hop_length}: "
                    f"{err} > {rtol} × {peak}")
            rel.append(err / peak)
            if (b, t) == (128, 256):
                main_errs.append(err)
        return rel

    rng = np.random.default_rng(0)
    main_errs: list[float] = []
    cases = [(2, 256, False), (2, 1024, False), (2, 256, True), (1, 1024, False),
             (128, 256, False)]
    for b, t, with_init in cases:
        mel = mels(b, t, seed=t + b)
        mag = sp.r9y9_melspec_to_magspec(mel)[..., :512].contiguous()
        init = None
        if with_init:
            phi = torch.tensor(rng.uniform(0, 2 * np.pi, mag.shape), dtype=torch.float32,
                               device=dev)
            init = (torch.cos(phi), torch.sin(phi))
        errs = hold(mag, init)
        l1k = mel_l1(griffin_lim_kernel(mag, 30, 0.99, init_phase=init), mel)
        l1p = mel_l1(griffin_lim_plain(mag, 30, 0.99, init_phase=init), mel)
        require(abs(l1k - l1p) < 2e-3, f"G-L 30 iters B={b} T={t}: mel L1 {l1k} vs {l1p}")
        print(f"griffin_lim B={b} T={t} F=512 init_phase={with_init}: max|Δ|/peak "
              f"0-iter {errs[0]:.2e}, 1-iter {errs[1]:.2e}, 2-iter momentum {errs[2]:.2e}; "
              f"30-iter mel L1 kernel {l1k:.5f} plain {l1p:.5f}")
        if (b, t) == (128, 256):
            gl_mag = mag

    # Other AudioParams the kernel takes (n_fft = 4 · hop): hop 512 on the
    # float4 path with the Nyquist bin dropped, hop 250 on the masked scalar
    # path with a ragged F = 501.
    for hop, n_bins in ((512, 1024), (250, 501)):
        q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        wav = torch.tensor(synthetic_speech(hop, 2 * 128 * hop), device=dev).reshape(2, -1)
        mag = sp.waveform_to_magspec(wav, q)[:, :128, :n_bins].contiguous()
        errs = hold(mag, params=q)
        print(f"griffin_lim B=2 T=128 hop={hop} F={n_bins}: max|Δ|/peak "
              f"0-iter {errs[0]:.2e}, 1-iter {errs[1]:.2e}, 2-iter momentum {errs[2]:.2e}")

    gl_ms = cuda_ms(lambda: griffin_lim_kernel(gl_mag, 30, 0.99))
    plain_ms = cuda_ms(lambda: griffin_lim_plain(gl_mag, 30, 0.99))
    flops = gl_flops(128, 256, 512, 30)
    bytes_ms = 1e3 * gl_bytes(128, 256, 512) / (HBM_TBPS * 1e12)
    bound_tc = max(1e3 * flops / (BF16_TC_TFLOPS * 1e12), bytes_ms)
    bound_fp32 = max(1e3 * flops / (FP32_TFLOPS * 1e12), bytes_ms)
    print(f"griffin_lim B=128 T=256 F=512 30 iters: kernel {gl_ms:.2f} ms "
          f"({flops / gl_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
          f"{flops / 1e12:.3f} TFLOP; bound {bound_tc:.2f} ms at bf16 tensor cores, "
          f"fp32 CUDA-core ceiling {bound_fp32:.2f} ms")

    # -- 3. Main path: full-width Vocoder ---------------------------------------
    cfg = AdvocConfig()
    gen = AdvocGenerator(cfg)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    gen_cpu = copy.deepcopy(gen)
    voc = Vocoder(gen, device="cuda")
    batch = mels(128, 256, seed=1)
    utter = mels(1, 1024, seed=2)[0]

    griffin_lim_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    wav = voc(batch)
    wav_long = voc(utter)
    torch.cuda.synchronize()
    launches = griffin_lim_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == 2 * (2 * 30 + 1), f"G-L kernel launches on the main path: {launches}")
    for name, w, shape in (("batch", wav, (128, 256 * HOP)), ("utterance", wav_long, (1024 * HOP,))):
        require(tuple(w.shape) == shape, f"{name} shape {tuple(w.shape)}")
        require(bool(torch.isfinite(w).all()), f"{name} finite")
        require(float(w.abs().max()) < 1.0, f"{name} peak {float(w.abs().max())} < 1")
    l1_batch, l1_long = mel_l1(wav, batch), mel_l1(wav_long, utter)
    print(f"vocoder full width: launches {launches}, batch 128×256 mel L1 {l1_batch:.5f}, "
          f"1024-frame utterance mel L1 {l1_long:.5f}, peak memory {peak_gb:.2f} GB")

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
            "griffin_lim_ms": gl_ms,
        }
    call_ms = cuda_ms(lambda: voc(batch))
    long_ms = cuda_ms(lambda: voc(utter))
    audio_s = 128 * 256 * HOP / SR
    print("stages B=128×256: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"vocoder call B=128×256: {call_ms:.2f} ms = {audio_s / (call_ms / 1e3):.1f}× real time; "
          f"1024-frame utterance {long_ms:.2f} ms = "
          f"{1024 * HOP / SR / (long_ms / 1e3):.1f}× real time")

    # Device trace of one call: the busy share, and the kernels that take the
    # time (kernels run on one stream, so their sum is the busy time).
    wall_ms, by_name = device_trace(lambda: voc(batch))
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms > 0:
        gl_trace = sum(ms for name, (ms, _) in by_name.items()
                       if "synth_ola_kernel" in name or "analyze_project_kernel" in name)
        print(f"device trace B=128×256: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, "
              f"busy share {busy_ms / wall_ms:.3f}, G-L kernels {gl_trace:.2f} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, n) in top:
            print(f"  {ms:8.2f} ms {n:4d}×  {name[:90]}")
    else:
        print("device trace: not measured (the profiler recorded no device time)")

    # -- 4. Kernels line, then the result ---------------------------------------
    print(json.dumps({"kernels": [{
        "name": "griffin_lim",
        "route": "cuda",
        "source": "advoc_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "advoc_tpu/ops/pallas/griffin_lim.py:362",
        "replaces_all": [
            "advoc_tpu/ops/pallas/griffin_lim.py:362 griffin_lim_pallas",
            "advoc_tpu/ops/pallas/griffin_lim.py:482 griffin_lim_pallas_tiled",
        ],
        "launches": launches,
        "checks": "pass",
        "max_abs_err": max(main_errs),
        "ms": gl_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_tc,
        "bound_by": "operations",
        "bound_ms_fp32_cuda_cores": bound_fp32,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
