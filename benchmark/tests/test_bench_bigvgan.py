"""The BigVGAN cell on the CPU at a size a test run holds: ``correct`` true
for the program, false for the float8 control and for each fault planted
where the answer is made; the weight rule; the counts; the readers of the
program's ranges. On a card, the control again at the cell's own size."""

from __future__ import annotations

import sys
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bigvgan_flops
import common
import control_bigvgan as cb
import run as bench
from reference import bigvgan as rb

CELL = "bigvgan-22khz-80band.ljspeech-b8"
PUBLISHED = common.load("configs", "bigvgan-22khz-80band")["model"]


@pytest.fixture
def small(monkeypatch):
    """The cell cut to width 64 (32 … 1 channels: the published levels,
    rates, kernels and dilations, hop 256) and 6 utterances of 0.3–0.7 s
    in 64-frame buckets, 4 rows a call: two calls of one bucket, the second
    padded with two silent rows; the program's code paths."""
    load = common.load

    def cut(kind, name):
        d = load(kind, name)
        if kind == "configs":
            d["model"].update(upsample_initial_channel=64)
        if kind == "workloads":
            d["traffic"].update(utterances=6, batch=4, chunk_frames=64, min_s=0.3, max_s=0.7)
        return d

    monkeypatch.setattr(common, "load", cut)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def once(kind: str, device: str = "cpu", seconds: float = 1.0, seed: int = 2**40 + 17):
    return bench.execute(CELL, seed, seconds, False, device, make=cb.maker(kind),
                         t0=time.monotonic())


def test_program_correct(small):
    res = once("program")
    assert res["correct"] and res["attempted"] >= 2, res["checks"]
    assert res["checks"]["bad_rows"]["value"] == 0
    assert 0 < res["checks"]["wave_gap"]["value"] < res["checks"]["wave_gap"]["limit"]
    assert set(res["metrics"]) == {"vocode_xrt", "setup_s"}


@pytest.mark.parametrize("kind", ("control",) + cb.FAULTS)
def test_control_and_faults_fail(small, kind):
    """The float8 control fails by ``wave_gap``; so does every planted
    fault (``stale_mel`` answers with the other call's audio: one
    bucket here, so the same shape)."""
    res = once(kind)
    assert not res["correct"] and res["checks"]["wave_gap"]["value"] > \
        res["checks"]["wave_gap"]["limit"], res["checks"]


def test_calls_and_silence():
    """The mix's calls: the advoc.ljspeech-b8 grouping (66 calls of 8 rows
    in four buckets), log-mels (80, T) at BigVGAN's settings, silence ln
    1e-5 past each row's true length."""
    drv = bench.driver("bigvgan")
    wl = common.load("workloads", CELL)
    t = dict(wl["traffic"], utterances=40)
    a = drv.audio_of(common.load("configs", "bigvgan-22khz-80band"))
    calls = drv.mel_calls(t, 5, "cpu", a)
    assert all(c["mel"].shape[:2] == (8, 80) and c["mel"].shape[2] % 256 == 0 for c in calls)
    c = max(calls, key=lambda c: len(c["frames"]))
    f = c["frames"][0]
    assert (c["mel"][0, :, f:] == torch.tensor(1e-5).log().item()).all()
    assert c["mel"][0, :, :f].std() > 1.0
    import traffic
    import numpy as np

    frames = np.ceil(traffic.lj_durations(512, wl["traffic"], 0) * 22050 / 256)
    buckets = np.unique(-(-frames // 256) * 256, return_counts=True)
    assert buckets[0].tolist() == [256, 512, 768, 1024]
    assert buckets[1].tolist() == [11, 236, 187, 78]
    assert int(sum(-(-n // 8) for n in buckets[1])) == 66


@pytest.mark.parametrize("seed", [0, 2**40 + 1])
def test_weight_rule(seed):
    """At the published widths the rescaled weights give a speech log-mel a
    waveform of rms 0.25–0.45 (a trained vocoder's speech; tanh near its
    linear range)."""
    drv = bench.driver("bigvgan")
    cfg = common.load("configs", "bigvgan-22khz-80band")
    sd = drv.make_weights(cfg, seed, "cpu")
    a = drv.audio_of(cfg)
    calls = drv.mel_calls({"kind": "bucketed", "batch": 1, "chunk_frames": 12, "utterances": 1,
                           "log_mean": 0.0, "log_sigma": 0.0, "min_s": 0.13, "max_s": 0.13,
                           "mix_seed": 0}, seed, "cpu", a)
    with torch.no_grad():
        y = rb.generate(torch.as_tensor(calls[0]["mel"]), sd, PUBLISHED)
    rms = float(y.pow(2).mean().sqrt())
    assert 0.25 <= rms <= 0.45, rms


def test_counts():
    """1.80 GFLOP and 2.46 MB (bf16: one read, one write of 614,400
    activation elements) a frame at the published configuration, 97% of the
    FLOP in the AMP blocks; the convolution counts against FlopCounterMode
    over the port's generator at width 64 with the activations taken out."""
    per = bigvgan_flops.conv_flops(PUBLISHED, 1)
    assert round(sum(per) / 1e9, 2) == 1.80
    amp = sum(f for f, c in zip(per, bigvgan_flops.convs(PUBLISHED, 1)) if c[2] == c[3])
    assert round(amp / sum(per), 2) == 0.97
    assert round(bigvgan_flops.act_bytes(PUBLISHED, 1, 1) / 1e6, 2) == 2.46
    assert len(bigvgan_flops.activations(PUBLISHED, 1)) == 109
    from advoc_tpu_torch.models.bigvgan import BigVGANConfig, BigVGANGenerator
    from advoc_tpu_torch.models.bigvgan import model as bm

    model = {**PUBLISHED, "upsample_initial_channel": 64, "dtype": "float32"}
    g = BigVGANGenerator(BigVGANConfig(**model)).eval()
    act = bm.aa_snake_beta
    bm.aa_snake_beta = lambda x, *_: x
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as c:
            g(torch.zeros(3, 80, 5))
    finally:
        bm.aa_snake_beta = act
    assert c.get_total_flops() == 3 * sum(bigvgan_flops.conv_flops(model, 5))
    pk = bigvgan_flops.peaks("NVIDIA H100 80GB HBM3")
    calls = [(8, 1024)]
    bound = bigvgan_flops.conv_bound_s(PUBLISHED, calls, pk)
    assert 8 * 1024 * sum(per) / pk["bf16_flops_per_s"] < bound < 1.3 * 8 * 1024 * sum(per) / \
        pk["bf16_flops_per_s"]
    assert bigvgan_flops.act_bound_s(PUBLISHED, calls, pk) == pytest.approx(
        8 * 1024 * 2.4576e6 / 3.35e12)


def _fake_profiling(monkeypatch, device_ms):
    mod = types.ModuleType("advoc_tpu_torch.utils.profiling")
    mod.device_ms = device_ms
    monkeypatch.setitem(sys.modules, "advoc_tpu_torch.utils.profiling", mod)


def _run(events=()):
    return {"config": {"model": PUBLISHED}, "calls": [(8, 512), (8, 1024)],
            "events": list(events), "trace": {"device_kind": "NVIDIA H100 80GB HBM3"}}


@pytest.mark.parametrize("metric", ["bigvgan_ms", "aa_act_roofline", "bigvgan_conv_roofline"])
def test_readers_without_ranges(monkeypatch, metric):
    """None, never an exception: no events, no ``advoc.bigvgan`` range, a
    program whose ``device_ms`` takes no ``per``, none loaded."""
    read = common.metric_reader(metric)
    assert read({"config": {}}) is None
    import advoc_tpu_torch.utils.profiling  # noqa: F401  (the program's own device_ms)

    assert read(_run()) is None
    _fake_profiling(monkeypatch, lambda events: {"advoc.vocode": 1.0})
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "advoc_tpu_torch.utils.profiling")
    assert read(_run()) is None


def test_readers_on_ranges(monkeypatch):
    ms = {"advoc.bigvgan": 150.0, "advoc.aa_act": 100.0, "advoc.conv": 40.0}
    seen = []
    _fake_profiling(monkeypatch, lambda events, per="vocode": seen.append(per) or ms)
    run = _run()
    pk = bigvgan_flops.peaks("H100")
    assert common.metric_reader("bigvgan_ms")(run) == 150.0
    act = common.metric_reader("aa_act_roofline")(run)
    assert act == pytest.approx(100 * bigvgan_flops.act_bound_s(PUBLISHED, run["calls"], pk)
                                / (2 * 0.1))
    conv = common.metric_reader("bigvgan_conv_roofline")(run)
    assert conv == pytest.approx(100 * bigvgan_flops.conv_bound_s(PUBLISHED, run["calls"], pk)
                                 / (2 * 0.04))
    assert seen == ["bigvgan"]  # one pass over the events for the three readers
    del ms["advoc.aa_act"]
    assert common.metric_reader("aa_act_roofline")(run) is None


@pytest.mark.cuda
def test_control_fails_on_card(card):
    assert not once("control", "cuda", seconds=2.0)["correct"]
