"""The WaveGAN generation cell on the CPU at a size a test run holds:
``correct`` true for the program, false for the float8 control and for
each fault planted where the answer is made; the weight rule; the counts;
the readers of the program's ranges. On a card, the control again at the
cell's own size."""

from __future__ import annotations

import sys
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import control_generate as cg
import run as bench
import wavegan_flops
from reference import wavegan as rw

CELL = "wavegan-65536.gen-b256"
PUBLISHED = common.load("configs", "wavegan-65536")["model"]


@pytest.fixture
def small(monkeypatch):
    """The cell cut to width 4 and 2 latents a call, 2 in the pool: the
    published slice, kernel and levels, the program's code paths."""
    load = common.load

    def cut(kind, name):
        d = load(kind, name)
        if kind == "configs":
            d["model"].update(width=4)
        if kind == "workloads":
            d["traffic"].update(batch=2, pool=2)
        return d

    monkeypatch.setattr(common, "load", cut)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def once(kind: str, device: str = "cpu", seconds: float = 1.0, seed: int = 2**40 + 17):
    return bench.execute(CELL, seed, seconds, False, device, make=cg.maker(kind),
                         t0=time.monotonic())


def test_program_correct(small):
    res = once("program")
    assert res["correct"] and res["attempted"] > 2, res["checks"]
    assert res["checks"]["bad_rows"]["value"] == 0
    assert set(res["metrics"]) == {"vocode_xrt", "setup_s"}


@pytest.mark.parametrize("kind", ("control",) + cg.FAULTS)
def test_control_and_faults_fail(small, kind):
    """The float8 control fails by ``wave_gap`` (measured ≈ 0.12 here
    against the program's ≈ 0.006); so does every planted fault."""
    res = once(kind)
    assert not res["correct"] and res["checks"]["wave_gap"]["value"] > \
        res["checks"]["wave_gap"]["limit"], res["checks"]


@pytest.mark.parametrize("seed", [0, 2**40 + 1])
def test_weight_rule(seed):
    """At the published widths the rescaled weights give unit-normal
    latents a pre-tanh rms in 0.3–0.5 (a trained generator's audio), and
    the output is the signal's, not the biases'."""
    drv = bench.driver("generate")
    cfg = common.load("configs", "wavegan-65536")
    sd = drv.make_weights(cfg, seed, "cpu")
    z = torch.from_numpy(drv.latent_pool({"pool": 1, "batch": 2}, PUBLISHED["latent_dim"],
                                         seed)[0])
    with torch.no_grad():
        x = rw.pre_tanh(z, sd, PUBLISHED)
        bias_only = rw.pre_tanh(z, {k: v if k.endswith("bias") else torch.zeros_like(v)
                                    for k, v in sd.items()}, PUBLISHED)
    rms = float(x.pow(2).mean().sqrt())
    assert 0.3 <= rms <= 0.5 and float(bias_only.pow(2).mean().sqrt()) < 0.1 * rms


def test_counts():
    """8.44 GFLOP a clip at the published configuration (five levels of
    1.68 G, the last 0.05 G), and the counts against FlopCounterMode over
    the port's generator at width 4 (the projection counted apart)."""
    per = wavegan_flops.level_flops(PUBLISHED)
    assert round(sum(per) / 1e9, 2) == 8.44 and round(per[0] / 1e9, 2) == 1.68
    assert round(per[-1] / 1e9, 2) == 0.05
    from advoc_tpu_torch.models.wavegan import WaveGANConfig, WaveGANGenerator

    model = {**PUBLISHED, "width": 4, "dtype": "float32"}
    g = WaveGANGenerator(WaveGANConfig(**model)).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as c:
        g(torch.zeros(3, model["latent_dim"]))
    assert c.get_total_flops() == 3 * (sum(wavegan_flops.level_flops(model))
                                       + wavegan_flops.project_flops(model))
    pk = wavegan_flops.peaks("NVIDIA H100 80GB HBM3")
    bound = wavegan_flops.upconv_bound_s(PUBLISHED, 256, pk)
    assert 256 * sum(per) / pk["bf16_flops_per_s"] < bound < 2.4e-3


def _fake_profiling(monkeypatch, device_ms):
    mod = types.ModuleType("advoc_tpu_torch.utils.profiling")
    mod.device_ms = device_ms
    monkeypatch.setitem(sys.modules, "advoc_tpu_torch.utils.profiling", mod)


def _run(events=()):
    return {"config": {"model": PUBLISHED}, "batch": 256, "events": list(events),
            "trace": {"device_kind": "NVIDIA H100 80GB HBM3"}}


@pytest.mark.parametrize("metric", ["wavegan_ms", "upconv_roofline"])
def test_readers_without_ranges(monkeypatch, metric):
    """None, never an exception: no events, no ``advoc.wavegan`` range, a
    program whose ``device_ms`` takes no ``per`` (the parent's), none
    loaded."""
    read = common.metric_reader(metric)
    assert read({"config": {}}) is None
    import advoc_tpu_torch.utils.profiling  # noqa: F401  (the program's own device_ms)

    assert read(_run()) is None
    _fake_profiling(monkeypatch, lambda events: {"advoc.vocode": 1.0})
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "advoc_tpu_torch.utils.profiling")
    assert read(_run()) is None


def test_readers_on_ranges(monkeypatch):
    ms = {"advoc.wavegan": 12.0, "advoc.project": 0.1, "advoc.conv": 11.0}
    ms.update({f"advoc.up{i}": 1.0 + i for i in range(6)})  # 21 ms of levels
    seen = []
    _fake_profiling(monkeypatch, lambda events, per="vocode": seen.append(per) or ms)
    run = _run()
    assert common.metric_reader("wavegan_ms")(run) == 12.0
    roof = common.metric_reader("upconv_roofline")(run)
    want = 100 * wavegan_flops.upconv_bound_s(PUBLISHED, 256, wavegan_flops.peaks("H100")) / 21e-3
    assert roof == pytest.approx(want) and seen == ["wavegan", "wavegan"]
    del ms["advoc.up5"]
    assert common.metric_reader("upconv_roofline")(run) is None


@pytest.mark.cuda
def test_control_fails_on_card(card):
    assert not once("control", "cuda", seconds=2.0)["correct"]
