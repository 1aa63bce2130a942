"""``bench_torch.py`` on the CPU, at a tiny size: its graph against the JAX
package's, its FLOP count, its result line and its refusal without a card.

The graph's size lives in ``bench_torch``'s module constants, which these
tests shrink (B=2 chunks of 64 frames, a width-8 depth-4 float32 generator,
2 G-L iterations, few trials). One intra-op thread: the suite's workers
share the cores.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.models.advoc import AdvocConfig as JConfig, AdvocGenerator as JGenerator
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as JP
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict
from advoc_tpu_torch.models.wavegan import WaveGANConfig
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.utils.roofline import cost_of, gl_flops

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch as bt  # noqa: E402

TINY = dict(n_frames=64, width=8, depth=4, disc_width=8, dtype="float32")
B, T, ITERS = 2, 64, 2
# Two G-L iterations from a zero phase, two float32 programs: tests/
# test_torch_vocoder.py's bound (bins where the rebuilt |u| ≈ 0 have an
# ill-conditioned phase), 1e-3 × the waveform's peak.
RTOL_2_ITERS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """bench_torch's sizes cut to the tiny run."""
    for name, value in dict(
        B=B, CONFIG=lambda: AdvocConfig(**TINY), GL_ITERS=ITERS, N_TRIALS=2, K=1,
        STREAM_CONFIG=lambda: AdvocConfig(**TINY), STREAM_GL_ITERS=ITERS, HEURISTIC_B=B,
        TRAIN_B=B, LONG_S=1, STREAMS=(1, 2), WAVEGAN_B=2,
        WAVEGAN_CONFIG=lambda: WaveGANConfig(slice_len=1024, latent_dim=16, width=8,
                                             dtype="float32"),
    ).items():
        monkeypatch.setattr(bt, name, value)
    monkeypatch.delenv("ADVOC_BENCH_FULL", raising=False)


@pytest.fixture(scope="module")
def converted():
    """(flax generator, its params, the port's generator with the same
    weights). The flax tree's shapes come from ``eval_shape`` (no compile)
    and its values from a seed: kernels normal over √fan-in, GroupNorm
    scales 1, biases 0."""
    jg = JGenerator(JConfig(**TINY))
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, T, JConfig().n_freq)))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, s):
        if len(s.shape) > 1:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return np.full(s.shape, path[-1].key == "scale", np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tg = AdvocGenerator(AdvocConfig(**TINY))
    tg.load_state_dict(flax_to_torch_state_dict(params, AdvocConfig(**TINY)))
    return jg, params, tg.eval()


@pytest.fixture(scope="module")
def mel():
    return bt.headline_mel(B, T, "cpu")


def test_headline_graph_matches_jax(converted, mel):
    """bench.py's config-2 graph from the JAX package's public functions
    (estimate, dB normalize, ``AdvocGenerator.apply``, denormalize, the
    projection, fast G-L) against ``bench_torch.VocodeGraph`` on the same
    mel and converted weights, both with the fp32 matmul G-L at "highest":
    within 1e-3 × the peak."""
    jg, params, tg = converted

    @jax.jit
    def jax_graph(mel):
        est = jsp.r9y9_melspec_to_magspec(mel, JP)
        est_norm = jsp.normalize_db(jsp.amp_to_db(est, JP) - JP.ref_level_db, JP)
        repaired = jg.apply({"params": params}, est_norm)
        mag = jsp.db_to_amp(jsp.denormalize_db(repaired, JP) + JP.ref_level_db)
        mag = jsp.mel_consistency_project(mag, mel, JP)
        return jsp.griffin_lim(mag, T * JP.hop_length, n_iters=ITERS, momentum=0.99,
                               params=JP, precision=jax.lax.Precision.HIGHEST,
                               fft_impl="matmul")

    want = np.asarray(jax_graph(jnp.asarray(mel.numpy())))
    got = bt.VocodeGraph(tg, ITERS, impl="matmul", precision="highest")(mel).numpy()
    assert got.shape == want.shape == (B, T * P.hop_length)
    np.testing.assert_allclose(got, want, atol=RTOL_2_ITERS * np.abs(want).max())


def test_flop_count_is_the_same_whatever_runs_gl(converted, mel):
    """The mfu's count reads the same for the kernel form (its plain
    version here) at "default" and the matmul form at "highest", and equals the
    U-Net's FlopCounterMode count plus the hand count of the matmul G-L on
    n_freq bins (no split synthesis) plus the estimate's and the
    projection's products."""
    graph = bt.VocodeGraph(converted[2], ITERS)
    assert graph.impl == "kernel"
    counts = {bt.graph_flops(dataclasses.replace(graph, impl=impl, precision=prec), mel)
              for impl, prec in (("kernel", "default"), ("matmul", "highest"))}
    assert len(counts) == 1
    with torch.inference_mode():
        est_norm = graph.featurize(mel)
        repaired = graph.unet(est_norm)
    unet = cost_of(graph.unet, est_norm)["flops"]
    small = cost_of(graph.featurize, mel)["flops"] + cost_of(graph.to_mag, repaired, mel)["flops"]
    assert unet > 0 and small > 0
    assert counts == {unet + gl_flops(B, T, P.n_freq, ITERS, P.hop_length) + small}


def test_main_on_the_cpu_prints_the_result_line(tiny, capsys):
    """``main(["--device", "cpu"])``: the last stdout line is the JSON result
    with every key of the contract, the device "cpu", no mfu (no device
    metric from a CPU run) and no ``vs_baseline``."""
    ret = bt.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == ret
    assert {"metric", "value", "unit", "mfu", "ms_median", "ms_p25", "ms_p75", "n_trials",
            "device", "power_limit_w"} <= set(line)
    assert "vs_baseline" not in line and "extended" not in line
    assert line["metric"] == "vocoding_realtime_factor" and line["unit"] == "x_realtime"
    assert line["device"] == "cpu" and line["mfu"] is None and line["power_limit_w"] is None
    assert line["n_trials"] == 2 and line["ms_p25"] <= line["ms_median"] <= line["ms_p75"]
    assert line["streaming_small"]["n_trials"] == 10
    audio_s = B * T * P.hop_length / P.sample_rate
    assert line["value"] == pytest.approx(audio_s / (line["ms_median"] / 1e3))
    assert line["gl_launches_per_call"] == {"griffin_lim": 0, "griffin_lim_tc": 0}
    assert abs(line["mel_l1"]["kernel"] - line["mel_l1"]["matmul"]) <= bt.GL_FORMS_MEL_L1
    assert err.splitlines()[0].startswith("[bench] device: cpu")


def test_extended_panel_on_the_cpu(tiny, capsys, monkeypatch):
    """``ADVOC_BENCH_FULL`` adds configs 1, 3, 6, 7 (1 and 2 streams) and 5,
    each a median of its trials."""
    monkeypatch.setenv("ADVOC_BENCH_FULL", "1")
    ext = bt.main(["--device", "cpu"])["extended"]
    err = capsys.readouterr().err
    assert set(ext) == {"cfg1_heuristic", "cfg3_train_step", "cfg6_long_form", "cfg7_streams_1",
                        "cfg7_streams_2", "cfg5_wavegan"}
    for row in ext.values():
        assert row["n_trials"] == 2 and 0 < row["ms_median"] < float("inf")
    assert ext["cfg6_long_form"]["frames"] == 87
    # WaveGAN's count is the transposed convolutions' own work (2·L_in·Cin·Cout·k
    # a level, from 16 frames at c0 = 32), not the zero-stuffed forward form's.
    chans, k = (32, 16, 8, 1), 24
    per_z = 16 * 16 * 32 + sum(16 * 4**i * chans[i] * chans[i + 1] * k for i in range(3))
    assert ext["cfg5_wavegan"]["flops"] == 2 * 2 * per_z
    assert ext["cfg5_wavegan"]["mfu"] > 0
    for tag in ("cfg1", "cfg3", "cfg6", "cfg7", "cfg5"):
        assert f"[bench:{tag}]" in err


def test_without_a_card_it_exits_nonzero():
    """No ``--device cpu`` and no card: a non-zero exit naming the missing
    card, and no result line."""
    env = {k: v for k, v in os.environ.items() if k != "ADVOC_BENCH_FULL"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert proc.stdout == ""
