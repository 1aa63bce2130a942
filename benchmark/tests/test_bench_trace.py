"""The reduction of a trace and the per-layer readers, on made-up records."""

from __future__ import annotations

import common


def test_summarize():
    ops = [("k1", 0, 10), ("k2", 5, 20), ("Memcpy DtoH", 30, 40), ("k1", 50, 60)]
    spans = [("window", 0, 100, 0), ("call", 0, 45, 0), ("unet", 2, 8, 0), ("gl", 25, 45, 0)]
    r = common.summarize(ops, spans, 0, 100)
    assert r["busy_s"] == 40e-6 and r["window_s"] == 100e-6
    assert dict(r["idle_gaps"]) == {"window": 40e-6, "call": 10e-6, "gl": 10e-6}
    assert r["device_ops"][0] == ["k1", 20e-6]


def test_readers():
    trace = {"busy_s": 0.9, "window_s": 1.0, "device_kind": "NVIDIA H100 80GB HBM3"}
    cfg = {"model": {"freq_pack": 2, "depth": 6, "width": 64, "n_freq": 513,
                     "fast_head": False, "head_kernel": 1},
           "vocoder": {"chunk_frames": 256, "overlap_frames": 32, "gl_iters": 30,
                       "mel_projection": 1.0}}
    run = {"config": cfg, "trace": trace, "calls": [(128, 256, 80)] * 10, "window_s": 1.0,
           "audio": {"n_fft": 1024, "n_mels": 80, "hop_length": 256},
           "unet_ms": [50.0, 48.0], "gl_ms": [16.0] * 10}
    assert abs(common.metric_reader("vocode_mfu")(run) - 100 * 7.9222e13 / 989e12) < 1e-3
    assert common.metric_reader("unet_ms")(run) == 49.0
    assert abs(common.metric_reader("gl_roofline")(run) - 100 * 4.2001e12 / 989e12 / 0.016) < 1e-2
    assert abs(common.metric_reader("device_idle.vocode")(run) - 10.0) < 1e-9
    assert common.metric_reader("device_idle.lj")(run) == common.metric_reader("device_idle")(run)
    assert common.metric_reader("unet_ms.lj")(run) == 49.0
    assert common.metric_reader("device_idle")({"config": cfg}) is None
