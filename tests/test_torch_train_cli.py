"""The port's advoc train/eval/infer CLI and ``--train_dir`` in its
vocode and serve CLIs, on the CPU (``--device cpu``, the JAX CLI tests'
tiny model), and one run against the JAX CLI."""

import dataclasses
import importlib.util
import json
import pathlib
import wave

import jax
import numpy as np
import pytest
import torch

from advoc_tpu_torch.infer import Vocoder, vocode_cli
from advoc_tpu_torch.models.advoc import AdvocConfig
from advoc_tpu_torch.models.advoc import train_evaluate as cli
from advoc_tpu_torch.train.checkpoint import CheckpointManager, load_train_generator

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = "width=8,depth=4,n_frames=64,disc_width=8,dtype=float32"
TINY_CFG = AdvocConfig(width=8, depth=4, n_frames=64, disc_width=8, dtype="float32")
LR = 2e-4


def _args(train_dir, *extra):
    return ["--train_dir", str(train_dir), "--device", "cpu", "--batch_size", "2",
            "--model_overrides", TINY, "--log_every", "1", "--gl_iters", "2", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """4 steps with the corpus staged (the CPU is the device here)."""
    d = tmp_path_factory.mktemp("run")
    gs, ds, step = cli.main(["--mode", "train", *_args(d, "--max_steps", "4", "--ckpt_every", "2",
                                                      "--data_placement", "hbm")])
    assert step == 4 and gs.step == ds.step == 4
    return d


def _read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


class TestTrainEvaluate:
    def test_train_checkpoints_and_records_its_config(self, run):
        mgr = CheckpointManager(run)
        assert mgr.all_steps() == [2, 4]
        mgr.close()
        assert json.loads((run / "config.json").read_text()) == dataclasses.asdict(TINY_CFG)
        assert len(list((run / "synthetic_data").glob("*.wav"))) == 8

    def test_resume_on_the_wire_continues_the_count(self, tmp_path, capsys):
        cli.main(["--mode", "train", *_args(tmp_path, "--max_steps", "2", "--ckpt_every", "2",
                                            "--data_placement", "wire")])
        _, _, step = cli.main(["--mode", "train", *_args(tmp_path, "--max_steps", "4",
                                                         "--ckpt_every", "2", "--h2d_dtype",
                                                         "float32", "--data_placement", "wire")])
        out = capsys.readouterr().out
        assert step == 4 and "resumed from step 2" in out and "[train] step 3 (" in out

    def test_eval_once(self, run, capsys):
        assert cli.main(["--mode", "eval", "--eval_once", *_args(run)]) == 4
        assert "[eval] ckpt 4: eval_l1_heuristic=" in capsys.readouterr().out
        assert list((run / "tb_eval").glob("events*"))

    def test_infer_writes_wavs(self, run, tmp_path):
        mels = np.random.default_rng(0).uniform(0, 1, (2, 70, 80)).astype(np.float32)
        np.save(tmp_path / "m.npy", mels)
        paths = cli.main(["--mode", "infer", "--infer_input", str(tmp_path / "m.npy"),
                          "--infer_dir", str(tmp_path / "o"), *_args(run)])
        assert [p.name for p in paths] == ["vocoded_0.wav", "vocoded_1.wav"]
        gen, step = load_train_generator(run)
        assert step == 4
        voc = Vocoder(gen, chunk_frames=64, gl_iters=2, device="cpu")
        for p, m in zip(paths, mels):  # one mel a call, as the CLI
            w = voc(m).numpy()
            got = _read_wav(p)
            assert got.shape == (70 * 256,) and np.isfinite(got).all()
            np.testing.assert_array_equal(got * 32767.0, np.round(np.clip(w, -1, 1) * 32767.0))
        (default,) = cli.main(["--mode", "infer", *_args(run)])  # a synthetic 4 s fixture
        assert default == run / "infer" / "vocoded_0.wav" and _read_wav(default).size == 345 * 256

    def test_vocode_cli_and_serve_take_the_train_dir(self, run, tmp_path):
        """Both CLIs restore the latest checkpoint's generator, its config
        from the run's config.json."""
        from advoc_tpu_torch.serve.cli import main as serve_main

        mel = np.random.default_rng(1).uniform(0, 1, (90, 80)).astype(np.float32)
        np.save(tmp_path / "m.npy", mel)
        vocode_cli.main(["--input", str(tmp_path / "m.npy"), "--out_dir", str(tmp_path / "o"),
                         "--train_dir", str(run), "--device", "cpu", "--gl_iters", "2"])
        gen, _ = load_train_generator(run)
        assert gen.cfg == TINY_CFG
        want = Vocoder(gen, chunk_frames=64, gl_iters=2, device="cpu")(mel).numpy()
        np.testing.assert_array_equal(_read_wav(tmp_path / "o" / "m_0.wav") * 32767.0,
                                      np.round(np.clip(want, -1, 1) * 32767.0))
        res = serve_main(["--selftest", "1", "--pushes", "2", "--n_slots", "1", "--chunk_frames",
                          "16", "--gl_iters", "2", "--device", "cpu", "--train_dir", str(run)])
        assert res["n_clients"] == 1 and res["ticks"] >= 2

    def test_debug_nans_turns_on_anomaly_detection(self, tmp_path):
        try:
            cli.main(["--mode", "train", *_args(tmp_path, "--max_steps", "1", "--debug_nans")])
            assert torch.is_anomaly_enabled()
        finally:
            torch.autograd.set_detect_anomaly(False)

    def test_placement_budget(self, tmp_path, capsys):
        with pytest.raises(ValueError, match="budget"):
            cli.main(["--mode", "train", *_args(tmp_path, "--max_steps", "1", "--data_placement",
                                                "hbm", "--hbm_budget_mb", "0")])
        cli.main(["--mode", "train", *_args(tmp_path, "--max_steps", "1", "--hbm_budget_mb", "0")])
        assert "data_placement auto → wire" in capsys.readouterr().out

    @pytest.mark.parametrize("extra", [["--n_devices", "2"], []])
    def test_what_it_refuses(self, tmp_path, monkeypatch, extra):
        """Data parallelism is not ported; without --device cpu it needs a card."""
        if extra:
            with pytest.raises(NotImplementedError, match="queue A item 4"):
                cli.main(["--mode", "train", *_args(tmp_path, *extra)])
            monkeypatch.setenv("WORLD_SIZE", "2")
            with pytest.raises(NotImplementedError, match="DDP"):
                cli.main(["--mode", "infer", *_args(tmp_path)])
            return
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--mode", "train", "--train_dir", str(tmp_path)])


def test_a_jax_cli_run_resumed_by_both_clis(tmp_path):
    """The JAX CLI trains 2 steps (the corpus staged); scripts/ckpt_to_torch.py
    converts the run; the JAX CLI and the port's each resume it to step 4.
    Both restart the crop stream from the seed, so they see the same
    batches (the loaders' equality is tests/test_torch_loader.py's), and
    their step-4 parameters agree within 2 steps' worth of ±2·lr updates
    everywhere and within 1e-5 on ≥ 95% of the elements (measured 97.6%):
    JAX's float32 gradient of the decoder is itself up to 2e-2 of a
    tensor's largest off its float64 gradient (tests/test_torch_train.py),
    which moves Adam's later updates where gradients are small."""
    from advoc_tpu.models.advoc import train_evaluate as jcli
    from advoc_tpu_torch.models.advoc import flax_to_torch_state_dict

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    common = ["--batch_size", "2", "--model_overrides", TINY, "--log_every", "1",
              "--data_placement", "hbm"]
    jcli.main(["--mode", "train", "--train_dir", str(jdir), "--max_steps", "2", "--ckpt_every",
               "2", "--n_devices", "1", *common])
    spec = importlib.util.spec_from_file_location("ckpt_to_torch",
                                                  ROOT / "scripts" / "ckpt_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(["--train_dir", str(jdir), "--out", str(tdir)])
    (tdir / "synthetic_data").symlink_to(jdir / "synthetic_data")
    jcli.main(["--mode", "train", "--train_dir", str(jdir), "--max_steps", "4", "--ckpt_every",
               "2", "--n_devices", "1", *common])
    _, _, step = cli.main(["--mode", "train", "--train_dir", str(tdir), "--max_steps", "4",
                           "--ckpt_every", "2", "--device", "cpu", *common])
    assert step == 4

    from advoc_tpu.train.checkpoint import CheckpointManager as JaxManager

    jm = JaxManager(jdir)
    jparams = jax.tree.map(np.asarray, jm.restore(4)["g"]["params"])
    jm.close()
    want = flax_to_torch_state_dict(jparams, TINY_CFG)
    got = load_train_generator(tdir)[0].state_dict()
    d = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert float(d.max()) <= 4 * LR, float(d.max())
    assert float((d <= 1e-5).float().mean()) >= 0.95, float((d <= 1e-5).float().mean())
