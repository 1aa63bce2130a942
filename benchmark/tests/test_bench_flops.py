"""The yardstick's counts against FlopCounterMode over the port's own
modules at small shapes on the CPU, and at bench.py's config 2."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import flops


def counted(fn, *args) -> float:
    with torch.no_grad(), FlopCounterMode(display=False) as c:
        fn(*args)
    return float(c.get_total_flops())


@pytest.mark.parametrize("overrides", [dict(width=8), dict(width=8, fast_head=True, n_frames=64),
                                       dict(width=8, depth=4, head_kernel=3)])
def test_unet_count(overrides):
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator

    cfg = AdvocConfig(dtype="float32", **overrides)
    g = AdvocGenerator(cfg).eval()
    x = torch.rand(2, 64, cfg.n_freq)
    assert flops.unet_flops(dataclasses.asdict(cfg), 2, 64) == counted(g, x)


def test_gl_and_stage_counts():
    from advoc_tpu_torch.ops import spectral

    mag = torch.rand(2, 16, 513)
    mel = torch.rand(2, 16, 80)
    assert flops.gl_flops(2, 16, 513, 1024, 3) == counted(
        lambda m: spectral.griffin_lim(m, n_iters=3, momentum=0.99, fft_impl="matmul"), mag)
    v = {"chunk_frames": 16, "overlap_frames": 4, "gl_iters": 0, "mel_projection": 1.0}
    per = flops.vocode_flops({"freq_pack": 2, "depth": 1, "width": 1, "n_freq": 513,
                              "fast_head": False, "head_kernel": 1}, v,
                             {"n_fft": 1024, "n_mels": 80}, 2, 16)
    assert per["estimate"] == counted(spectral.r9y9_melspec_to_magspec, mel)
    assert per["projection"] == counted(spectral.mel_consistency_project, mag, mel)


def test_config_2():
    """bench.py's config 2 (AdvocConfig(), 128 × 256 frames, G-L ×30): the
    7.922 TFLOP of bench_torch.py, with G-L's 4200.1 GFLOP in it."""
    from advoc_tpu_torch.models.advoc import AdvocConfig

    v = {"chunk_frames": 256, "overlap_frames": 32, "gl_iters": 30, "mel_projection": 1.0}
    per = flops.vocode_flops(dataclasses.asdict(AdvocConfig()), v, {"n_fft": 1024, "n_mels": 80},
                             128, 256)
    assert round(per["gl"] / 1e9, 1) == 4200.1
    assert round(sum(per.values()) / 1e12, 3) == 7.922


def test_peaks_and_bound():
    pk = flops.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops_per_s"] == 989e12 and pk["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("cpu") is None
    assert flops.bound_s(989e12, 1.0, pk) == 1.0
    assert flops.bound_s(1.0, 3.35e12, pk) == 1.0
