"""The port's scripts (``scripts/*_torch.py``) against their JAX counterparts
on the CPU, at the sizes tests/test_cli.py uses.

Each script is loaded from its file under a module name of its own
(``port_<name>`` and ``jax_<name>``), never by its bare name from
``scripts/`` on ``sys.path``, so neither set can shadow the other in
``sys.modules``. Both run on the same inputs made from a seed; the port's
with ``--device cpu`` (``--cpu`` where the JAX script has that flag).
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY = "width=8,depth=4,n_frames=64,disc_width=8,dtype=float32"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite's workers
    share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def script(name: str, side: str):
    """``scripts/<name>.py`` loaded as the module ``<side>_<name>``."""
    spec = importlib.util.spec_from_file_location(f"{side}_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str):
    return script(f"{name}_torch", "port")


def jax_script(name: str):
    return script(name, "jax")


def result_line(out: str, tag: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


def close(got: float, want: float, atol: float = 1e-3, rtol: float = 0.02) -> bool:
    return abs(got - want) <= max(atol, rtol * abs(want))


# -- prepare_dataset and corpus_rehearsal ---------------------------------------


def test_rehearsal_corpus_is_bit_equal(tmp_path):
    """make_corpus: the same seed writes the same LJ-shaped WAVs, byte for
    byte, in both packages."""
    port("corpus_rehearsal").make_corpus(tmp_path / "port", 4, 22050, seed=3)
    jax_script("corpus_rehearsal").make_corpus(tmp_path / "jax", 4, 22050, seed=3)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.wav")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("copy", [False, True])
def test_prepare_dataset_splits_as_jax(tmp_path, monkeypatch, copy):
    """The same corpus and seed give the same train/eval lists, line for
    line, and the same rewritten WAVs (a 16 kHz file resampled; with
    --copy every file); a file under --min_seconds is skipped by both."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech

    corpus = tmp_path / "corpus"
    port("corpus_rehearsal").make_corpus(corpus, 7, 22050, seed=0)
    audioio.save_as_wav(synthetic_speech(9, 16000), corpus / "sr16k.wav", 16000)
    audioio.save_as_wav(synthetic_speech(10, 2000), corpus / "short.wav", 22050)
    flags = ["--in_dir", str(corpus), "--eval_fraction", "0.25", "--seed", "5"]
    flags += ["--copy"] if copy else []
    port("prepare_dataset").main(flags + ["--out_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["prepare_dataset.py", *flags,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_script("prepare_dataset").main()
    for lst in ("train_files.txt", "eval_files.txt"):
        got = (tmp_path / "port" / lst).read_text().replace(str(tmp_path / "port"), "OUT")
        want = (tmp_path / "jax" / lst).read_text().replace(str(tmp_path / "jax"), "OUT")
        assert got == want, lst
    rewritten = sorted(p.name for p in (tmp_path / "jax" / "wavs").glob("*.wav"))
    assert rewritten == sorted(p.name for p in (tmp_path / "port" / "wavs").glob("*.wav"))
    assert "sr16k.wav" in rewritten and len(rewritten) == (8 if copy else 1)
    for n in rewritten:
        assert ((tmp_path / "port" / "wavs" / n).read_bytes()
                == (tmp_path / "jax" / "wavs" / n).read_bytes()), n
    lines = (tmp_path / "port" / "train_files.txt").read_text().splitlines()
    lines += (tmp_path / "port" / "eval_files.txt").read_text().splitlines()
    assert len(lines) == 8 and not any("short" in ln for ln in lines)


# -- stress_eval ----------------------------------------------------------------


def _panel_table(out: str) -> dict:
    rows = {}
    for ln in out.splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if len(cells) == 5 and cells[0] not in ("class", "---"):
            rows[cells[0]] = [float(c) for c in cells[1:]]
    return rows


@pytest.mark.parametrize("extra", [
    [],
    ["--streaming", "lws_block", "--chunk_frames", "16", "--lws_look_ahead", "1",
     "--lws_sweeps", "1"],
], ids=["offline", "streaming_lws_block"])
def test_stress_eval_panel_as_jax(capsys, monkeypatch, extra):
    """The heuristic panel at test_cli.py's size: every cell of the table
    within 1e-3 (or 2%) of JAX's; the description line the same. XLA on
    the CPU runs the Vocoder's DEFAULT-precision G-L in fp32, where the
    port's CPU default rounds the operands to bf16 as a TPU does, so the
    port's Vocoder runs at "highest" here, JAX's CPU arithmetic. The
    silence class's LSD is the dB of each package's rounding noise (its
    output is ~1e-7 of full scale against a 1e-5 floor): held finite."""
    import functools

    import advoc_tpu_torch.infer as infer

    monkeypatch.setattr(infer, "Vocoder", functools.partial(infer.Vocoder,
                                                            gl_precision="highest"))
    argv = ["--n_frames", "64", "--gl_iters", "2"] + extra
    port("stress_eval").main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    jax_script("stress_eval").main(argv)
    want_out = capsys.readouterr().out
    got, want = _panel_table(got_out), _panel_table(want_out)
    assert set(got) == set(want) == {"silence", "clipping", "noise", "chirp", "tone", "dc"}
    for kind in want:
        for col, g, w in zip(("spec_l1", "lsd_db", "snr_db", "mel_l1"), got[kind], want[kind]):
            if (kind, col) == ("silence", "lsd_db"):
                assert np.isfinite(g) and g > 0, g
                continue
            assert close(g, w), (kind, col, g, w)
    head = [ln for ln in got_out.splitlines() if ln.startswith("Stress panel")]
    assert head == [ln for ln in want_out.splitlines() if ln.startswith("Stress panel")]


def test_stress_eval_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port("stress_eval").main(["--n_frames", "64", "--gl_iters", "2"])


# -- stream_serve and vocode_client ----------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--engine", "gl", "--gl_iters", "2"],
    ["--engine", "lws_online", "--n_streams", "2", "--lws_sweeps", "1", "--lws_look_ahead", "1"],
], ids=["gl", "lws_online"])
def test_stream_serve_as_jax(capsys, extra):
    """test_cli.py's runs: the JAX test's assertions hold for the port, and
    stream 0's re-extracted mel L1 is within 1e-3 of JAX's (the STOI of the
    same stream within 1e-2)."""
    argv = ["--chunk_frames", "16", "--pushes", "4", "--fidelity"] + extra
    port("stream_serve").main(argv + ["--device", "cpu"])
    got = result_line(capsys.readouterr().out, "STREAM_SERVE_RESULT")
    jax_script("stream_serve").main(argv)
    want = result_line(capsys.readouterr().out, "STREAM_SERVE_RESULT")
    assert set(got) == set(want)
    for k in ("engine", "n_streams", "chunk_frames", "pushes"):
        assert got[k] == want[k]
    assert got["p50_ms"] > 0 and got["mel_l1"] < 0.2
    assert got["ms_per_stream"] == pytest.approx(got["p50_ms"] / got["n_streams"], abs=1e-3)
    assert abs(got["mel_l1"] - want["mel_l1"]) <= 1e-3, (got, want)
    assert abs(got["stoi"] - want["stoi"]) <= 1e-2, (got, want)


def test_vocode_client_through_the_port_server(tmp_path, capsys):
    """The port's client against the port's server (start_in_thread): the
    JAX test's assertions, the output exactly the input's frames × hop
    samples; the JAX client against the same server (one protocol) writes
    the same number of samples, and its mel L1 is within 1e-3 of the
    port's."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.infer import StreamingVocoder
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.serve import start_in_thread

    sv = StreamingVocoder(params=P, chunk_frames=16, n_streams=2, gl_iters=4,
                          emit_dtype="int16", device="cpu")
    handle = start_in_thread(sv)
    try:
        host, p = handle.address
        argv = ["--host", host, "--port", str(p), "--seconds", "1.0", "--fidelity"]
        port("vocode_client").main(argv + ["--output", str(tmp_path / "port.wav"),
                                           "--device", "cpu"])
        got = result_line(capsys.readouterr().out, "VOCODE_CLIENT_RESULT")
        jax_script("vocode_client").main(argv + ["--output", str(tmp_path / "jax.wav")])
        want = result_line(capsys.readouterr().out, "VOCODE_CLIENT_RESULT")
    finally:
        handle.stop()
    assert set(got) == set(want)
    assert got["mel_l1"] < 0.2 and abs(got["seconds_out"] - 1.0) < 0.1
    n_frames = 1 + P.sample_rate // P.hop_length  # the STFT path's frames of 1.0 s
    wav = audioio.decode_audio(tmp_path / "port.wav", P.sample_rate)
    assert wav.shape[0] == n_frames * P.hop_length
    assert abs(wav.shape[0] / P.sample_rate - 1.0) < 0.05
    assert audioio.decode_audio(tmp_path / "jax.wav", P.sample_rate).shape == wav.shape
    assert (got["chunks"], got["engine"]) == (want["chunks"], want["engine"])
    assert abs(got["mel_l1"] - want["mel_l1"]) <= 1e-3, (got, want)


# -- phase_timing and roofline ----------------------------------------------------


def test_phase_timing_as_jax(capsys):
    """One 32-frame utterance, 2 G-L iterations, 1 LWS sweep: the same six
    rows, each row's mel L1 within 1e-3 of JAX's and its time finite."""
    argv = ["--batch", "1", "--frames", "32", "--gl_iters", "2", "--lws_sweeps", "1"]
    got = port("phase_timing").main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jax_script("phase_timing").main(argv)
    want = result_line(capsys.readouterr().out, "PHASE_TIMING_RESULT")
    assert [r["method"] for r in got["rows"]] == [r["method"] for r in want["rows"]]
    assert len(got["rows"]) == 6
    for g, w in zip(got["rows"], want["rows"]):
        assert abs(g["mel_l1"] - w["mel_l1"]) <= 1e-3, (g, w)
        assert np.isfinite(g["device_ms"]) and g["mel_l1_rows"] == [pytest.approx(g["mel_l1"])]


# The JAX script's row name → the port's: B1 (shipped) is the port's
# counterpart of the Pallas kernel's row, which the JAX script prints on a
# TPU only.
ROOFLINE_ROWS = {
    "featurize+pinv estimate": "featurize+pinv estimate",
    "U-Net forward": "U-Net forward",
    "db→amp + mel projection": "db→amp + mel projection",
    "fast-GL ×2 (XLA matmul)": "fast-GL ×2 (matmul form)",
    "fast-GL ×2 (Pallas VMEM, shipped)": "fast-GL ×2 (B1 kernel, shipped)",
    "WHOLE fused vocoder (shipped)": "WHOLE fused vocoder (shipped)",
}


def test_roofline_rows_as_jax(capsys, monkeypatch):
    """``--cpu --batch 2 --skip_train``: every JAX row has its counterpart,
    the U-Net's FLOPs are within 5% of XLA's count, and B1's row takes the
    hand count (held to XLA's count of the matmul scan in
    test_torch_tools.py). Both slope timers are stubbed, the port's to one
    call of the function it times: a CPU time says nothing of the card's,
    and test_torch_tools.py times a chain."""
    from advoc_tpu.utils import roofline as jroof
    from advoc_tpu_torch.utils import roofline as rl

    def one_call(fn, *args, **kw):
        fn(*args)
        return 1e-3

    monkeypatch.setattr(rl, "slope_time", one_call)
    monkeypatch.setattr(jroof, "slope_time", lambda *a, **k: 1e-3)
    argv = ["--cpu", "--batch", "2", "--skip_train", "--gl_iters", "2"]
    got = port("roofline").main(argv)
    capsys.readouterr()
    jax_script("roofline").main(argv)
    want = result_line(capsys.readouterr().out, "ROOFLINE_RESULT")
    rows = {r["stage"]: r for r in got["rows"]}
    for r in want["rows"]:
        assert ROOFLINE_ROWS[r["stage"]] in rows, r["stage"]
    assert set(rows) == set(ROOFLINE_ROWS.values())
    jrows = {r["stage"]: r for r in want["rows"]}
    g, w = rows["U-Net forward"]["flops"], jrows["U-Net forward"]["flops"]
    assert abs(g / w - 1) < 0.05, (g, w)
    b1 = rows["fast-GL ×2 (B1 kernel, shipped)"]
    assert b1["flops"] == rl.gl_flops(2, 256, 512, 2, split_synth=True)
    assert b1["bytes"] == rl.gl_bytes(2, 256, 512)
    assert all(np.isfinite(r["ms"]) and r["mfu"] <= 1 and r["bw_frac"] <= 1
               for r in got["rows"])


# -- the research harnesses -------------------------------------------------------


@pytest.fixture(scope="module")
def converted_run(tmp_path_factory):
    """A tiny JAX run (random weights from make_states, saved at step 1 with
    its config.json) and its port conversion by scripts/ckpt_to_torch.py."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from advoc_tpu.models.advoc import model as jmodel
    from advoc_tpu.train import gan as jgan
    from advoc_tpu.train.checkpoint import CheckpointManager
    from advoc_tpu.train.harness import check_run_config

    root = tmp_path_factory.mktemp("converted_run")
    jc = jmodel.AdvocConfig(n_frames=64, width=8, depth=4, disc_width=8, dtype="float32")
    g, d = jmodel.AdvocGenerator(jc), jmodel.PatchDiscriminator(jc)
    est0 = jnp.zeros((1, 64, 513))
    gs, ds = jax.jit(lambda: jgan.make_states(g, d, (est0,), (est0, est0), seed=0))()
    check_run_config(str(root / "jax"), dataclasses.asdict(jc))
    mgr = CheckpointManager(root / "jax")
    mgr.save(1, {"g": gs, "d": ds}, force=True)
    mgr.close()
    out = script("ckpt_to_torch", "port").main(["--train_dir", str(root / "jax"),
                                                 "--out", str(root / "port")])
    return root / "jax", out


HARNESS = ["--n_frames", "64", "--gl_iters", "2", "--n_utts", "2"]


def test_projection_sweep_as_jax(converted_run, capsys):
    """The same grid through the same (converted) generator and the fp32
    matmul G-L: each row's mel L1 and dB L1 within 1e-3 of JAX's, STOI
    within 5e-3; the same best and shipped rows."""
    jax_dir, port_dir = converted_run
    grid = ["--strengths", "0.0,1.0", "--max_gains", "4.0", "--n_iters", "1,2"]
    got = port("projection_sweep").main(["--train_dir", str(port_dir), "--device", "cpu"]
                                        + HARNESS + grid)
    capsys.readouterr()
    jax_script("projection_sweep").main(["--train_dir", str(jax_dir), "--model_overrides",
                                         TINY] + HARNESS + grid)
    want = result_line(capsys.readouterr().out, "PROJECTION_SWEEP_RESULT")
    assert (got["ckpt_step"], got["n_utts"]) == (want["ckpt_step"], want["n_utts"]) == (1, 2)
    assert len(got["rows"]) == len(want["rows"]) == 3
    for g, w in zip(got["rows"], want["rows"]):
        assert [g[k] for k in ("strength", "max_gain", "n_iters")] == \
               [w[k] for k in ("strength", "max_gain", "n_iters")]
        assert abs(g["mel_l1"] - w["mel_l1"]) <= 1e-3, (g, w)
        assert abs(g["db_l1_vs_true"] - w["db_l1_vs_true"]) <= 1e-3, (g, w)
        assert abs(g["stoi"] - w["stoi"]) <= 5e-3, (g, w)
    assert got["shipped"]["n_iters"] == want["shipped"]["n_iters"] == 1


def test_stoi_analysis_as_jax(converted_run, capsys):
    """The six variants (G-L and oracle phase): STOI within 5e-3, mel L1 and
    band-envelope correlation within 1e-3 of JAX's."""
    jax_dir, port_dir = converted_run
    got = port("stoi_analysis").main(["--train_dir", str(port_dir), "--device", "cpu"]
                                     + HARNESS)
    capsys.readouterr()
    jax_script("stoi_analysis").main(["--train_dir", str(jax_dir), "--model_overrides", TINY]
                                     + HARNESS)
    want = result_line(capsys.readouterr().out, "STOI_ANALYSIS_RESULT")
    assert set(got) == set(want)
    variants = [k for k in want if isinstance(want[k], dict)]
    assert len(variants) == 6
    for v in variants:
        assert abs(got[v]["stoi"] - want[v]["stoi"]) <= 5e-3, (v, got[v], want[v])
        assert abs(got[v]["mel_l1"] - want[v]["mel_l1"]) <= 1e-3, (v, got[v], want[v])
        assert abs(got[v]["env_corr_mean"] - want[v]["env_corr_mean"]) <= 1e-3, v


def _result_keys(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return dict(kv.split("=", 1) for kv in re.findall(r"(\w+=\S+)", line))


def test_quality_ab_as_jax(tmp_path, capsys):
    """2 steps at tiny overrides: the RESULT line's keys are JAX's, its eval
    metrics finite, and the 8 fixture WAVs bit-equal to JAX's."""
    argv = ["--overrides", TINY, "--steps", "2", "--batch_size", "2"]
    port("quality_ab").main(argv + ["--fixture_dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    got = _result_keys(capsys.readouterr().out)
    jax_script("quality_ab").main(argv + ["--fixture_dir", str(tmp_path / "jax")])
    want = _result_keys(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got["steps"] == want["steps"] == "2" and got["wire"] == "int16"
    for k in ("eval_l1_heuristic", "eval_l1_repaired"):
        assert np.isfinite(float(got[k]))
    # The heuristic's L1 takes no trained weight: the two packages agree.
    assert abs(float(got["eval_l1_heuristic"]) - float(want["eval_l1_heuristic"])) <= 1e-3
    for i in range(8):
        assert ((tmp_path / "port" / f"s{i}.wav").read_bytes()
                == (tmp_path / "jax" / f"s{i}.wav").read_bytes()), i
