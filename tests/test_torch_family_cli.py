"""The port's WaveGAN (and ``--conditional``) and MelSpecGAN CLIs on the
CPU (``--device cpu``, the JAX CLI tests' tiny models): train → eval
``--eval_once`` → infer, melspecgan's ``--vocode`` heuristic and through a
port advoc run (``--advoc_ckpt``), what the CLIs refuse, the harness's
``eval_takes_bundle`` (MelSpecGAN's eval), and a JAX WaveGAN run converted
by ``scripts/ckpt_to_torch.py --family wavegan`` continuing in the port."""

import dataclasses
import importlib.util
import json
import pathlib
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader as jloader
from advoc_tpu.models.wavegan import model as jwave
from advoc_tpu.train import gan as jgan
from advoc_tpu.train import harness as jharness
from advoc_tpu_torch.infer import Vocoder
from advoc_tpu_torch.models import wavegan
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
from advoc_tpu_torch.models.convert import flax_to_state_dict
from advoc_tpu_torch.models.melspecgan import (
    MelSpecGANConfig,
    MelSpecGANDiscriminator,
    MelSpecGANGenerator,
)
from advoc_tpu_torch.models.melspecgan import train_evaluate as mcli
from advoc_tpu_torch.models.wavegan import train_evaluate as wcli
from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.train import gan, harness
from advoc_tpu_torch.train.checkpoint import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAVE = "slice_len=1024,latent_dim=16,width=8,n_critic=2,dtype=float32"
COND = "n_frames=16,width=8,dtype=float32"
MSG = "latent_dim=16,width=8,n_critic=2,dtype=float32"
ADVOC = dict(width=8, depth=4, n_frames=64, disc_width=8, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, where torch's default (one thread a core in every worker)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(train_dir, overrides, *extra):
    return ["--train_dir", str(train_dir), "--device", "cpu", "--batch_size", "2",
            "--model_overrides", overrides, "--log_every", "1", *extra]


def _read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


def _pcm(x: torch.Tensor) -> np.ndarray:
    """What save_as_wav writes, read back as _read_wav reads it."""
    return np.round(np.clip(x.numpy(), -1, 1) * 32767.0) / 32767.0


def _z(n, dim, seed):
    return torch.randn((n, dim), generator=torch.Generator().manual_seed(seed))


def _restored_g(cli, *argv):
    """The generator of the CLI's latest checkpoint (eval mode)."""
    args = cli.build_parser().parse_args(["--mode", "infer", *argv])
    cfg = cli.make_config(args)
    extra = (args.conditional,) if cli is wcli else ()
    g, _, gs, ds = cli._models_and_states(cfg, 0, "cpu", *extra)
    mgr = CheckpointManager(args.train_dir)
    mgr.restore(template={"g": gs, "d": ds})
    mgr.close()
    return g.eval()


class TestWaveGANCLI:
    def test_train_eval_infer(self, tmp_path, capsys):
        """2 steps (n_critic 2 D updates each) with a checkpoint, resumed to
        3; eval scores the checkpoint; infer writes G(z) for z from the
        seed's generator."""
        gs, ds, step = wcli.main(["--mode", "train", *_args(tmp_path, WAVE, "--max_steps", "2",
                                                            "--ckpt_every", "2")])
        assert step == 2 and gs.step == 2 and ds.step == 4
        cfg = json.loads((tmp_path / "config.json").read_text())
        assert cfg == dataclasses.asdict(wavegan.WaveGANConfig(
            slice_len=1024, latent_dim=16, width=8, n_critic=2, dtype="float32"))
        _, _, step = wcli.main(["--mode", "train", *_args(tmp_path, WAVE, "--max_steps", "3",
                                                          "--h2d_dtype", "float32")])
        out = capsys.readouterr().out
        assert step == 3 and "resumed from step 2" in out and "[train] step 3 (" in out
        assert wcli.main(["--mode", "eval", "--eval_once", *_args(tmp_path, WAVE)]) == 3
        assert "[eval] ckpt 3: eval_gen_peak=" in capsys.readouterr().out
        paths = wcli.main(["--mode", "infer", "--n_samples", "2", "--seed", "4",
                           *_args(tmp_path, WAVE)])
        assert [p.name for p in paths] == ["generated_0.wav", "generated_1.wav"]
        with torch.no_grad():
            want = _restored_g(wcli, *_args(tmp_path, WAVE))(_z(2, 16, 4))
        for p, w in zip(paths, want):
            np.testing.assert_array_equal(_read_wav(p), _pcm(w))

    def test_conditional_train_eval_infer(self, tmp_path, capsys):
        """--conditional: 22.05 kHz batches, the mel-L1 metrics logged, eval's
        eval_mel_l1, and infer of a 40-frame .npy cut to two 16-frame chunks
        through the restored G."""
        args = lambda *a: _args(tmp_path, COND, "--conditional", *a)  # noqa: E731
        gs, ds, step = wcli.main(["--mode", "train", *args("--max_steps", "2", "--ckpt_every",
                                                           "2", "--d_lr", "1e-4")])
        assert step == gs.step == ds.step == 2
        assert ds.opt.param_groups[0]["lr"] == 1e-4 and gs.opt.param_groups[0]["lr"] == 2e-4
        assert "g_mel_l1=" in capsys.readouterr().out
        assert wcli.main(["--mode", "eval", "--eval_once", *args()]) == 2
        assert "[eval] ckpt 2: eval_mel_l1=" in capsys.readouterr().out
        mel = np.random.default_rng(0).uniform(0, 1, (40, 80)).astype(np.float32)
        np.save(tmp_path / "m.npy", mel)
        (path,) = wcli.main(["--mode", "infer", "--infer_input", str(tmp_path / "m.npy"),
                             *args()])
        with torch.no_grad():
            want = _restored_g(wcli, *args())(torch.tensor(mel[:32]).reshape(2, 16, 80))
        want = want.reshape(-1)
        assert path.name == "neural_vocoded_0.wav"
        np.testing.assert_array_equal(_read_wav(path), _pcm(want))

    @pytest.mark.parametrize("cli", [wcli, mcli], ids=["wavegan", "melspecgan"])
    def test_what_it_refuses(self, tmp_path, monkeypatch, cli):
        """An --n_devices that does not divide the batch raises before any
        rank starts (the data-parallel runs themselves are
        tests/test_torch_parallel_dp.py's); infer runs as one process under
        a launcher's WORLD_SIZE, as the JAX CLIs do; without --device cpu
        the CLI needs a card."""
        with pytest.raises(ValueError, match="divisible"):
            cli.main(["--mode", "train", "--n_devices", "3", *_args(tmp_path, MSG)])
        monkeypatch.setenv("WORLD_SIZE", "2")
        cli.main(["--mode", "infer", *_args(tmp_path, MSG)])
        assert any((tmp_path / "infer").iterdir())
        monkeypatch.delenv("WORLD_SIZE")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--mode", "train", "--train_dir", str(tmp_path)])


@pytest.fixture(scope="module")
def advoc_run(tmp_path_factory):
    """A port advoc train_dir: a checkpoint at step 3 of a tiny generator and
    the recorded config, as the advoc CLI writes them."""
    d = tmp_path_factory.mktemp("advoc_run")
    cfg = AdvocConfig(**ADVOC)
    gs, ds = gan.make_states(AdvocGenerator(cfg), PatchDiscriminator(cfg), seed=1)
    harness.check_run_config(str(d), dataclasses.asdict(cfg))
    mgr = CheckpointManager(d)
    mgr.save(3, {"g": gs, "d": ds}, wait=True)
    mgr.close()
    return d, gs.model


class TestMelSpecGANCLI:
    def test_train_eval_infer_vocode(self, tmp_path, advoc_run, capsys):
        """2 steps, eval's moment panel and D margin, infer's mels.npy from
        the restored G, vocoded by the heuristic Vocoder (64-frame chunks) and
        by the advoc run's generator: the wavs are those Vocoders' output on
        the sampled mels, and the printed per-sample mel L1s theirs."""
        gs, ds, step = mcli.main(["--mode", "train", *_args(tmp_path, MSG, "--max_steps", "2",
                                                            "--ckpt_every", "2")])
        assert step == gs.step == 2 and ds.step == 4
        assert mcli.main(["--mode", "eval", "--eval_once", *_args(tmp_path, MSG)]) == 2
        out = capsys.readouterr().out
        assert "eval_d_margin=" in out and "eval_diversity_gap=" in out
        assert list((tmp_path / "tb_eval").glob("events*"))
        run, advoc_g = advoc_run
        for extra, want_voc, desc in (
                ([], Vocoder(chunk_frames=64, gl_iters=2, device="cpu"), "heuristic"),
                (["--advoc_ckpt", str(run)], Vocoder(advoc_g, chunk_frames=64, gl_iters=2,
                                                     device="cpu"), "advoc step 3")):
            res = mcli.main(["--mode", "infer", "--vocode", "--n_samples", "2", "--gl_iters", "2",
                             "--infer_dir", str(tmp_path / desc[:5]), *extra,
                             *_args(tmp_path, MSG)])
            assert f"vocoder: {desc};" in capsys.readouterr().out
            mels = np.load(res["mels"])
            assert mels.shape == (2, 64, 80) and 0 <= mels.min() and mels.max() <= 1
            want = want_voc(torch.tensor(mels))
            for p, w in zip(res["wavs"], want):
                np.testing.assert_array_equal(_read_wav(p), _pcm(w))
            re = spectral.waveform_to_r9y9_melspec(want)[:, :64].numpy()
            np.testing.assert_allclose(res["mel_l1"], np.abs(re - mels).mean(axis=(1, 2)),
                                       rtol=1e-5)
        with torch.no_grad():
            want = _restored_g(mcli, *_args(tmp_path, MSG))(_z(2, 16, 0))
        np.testing.assert_array_equal(mels, want.numpy())

    def test_missing_advoc_ckpt_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            mcli.main(["--mode", "infer", "--vocode", "--n_samples", "1", "--advoc_ckpt",
                       str(tmp_path / "none"), *_args(tmp_path, MSG)])


def _jax_draws(jc, key, b: int) -> dict:
    """The z, ε and shifts JAX's WaveGAN step takes from ``key``, in the
    port step's layout (tests/test_torch_wavegan.py holds the step on them)."""
    r = jc.phase_shuffle

    def shifts(k):
        return np.stack([jax.random.randint(jax.random.fold_in(k, i), (b,), -r, r + 1)
                         for i in range(jc.n_up - 1)])

    rngs = jax.random.split(key, jc.n_critic + 1)
    z, eps, sh = [], [], []
    for k in rngs[:-1]:
        z_rng, gp_rng, ps_rng = jax.random.split(k, 3)
        z.append(jax.random.normal(z_rng, (b, jc.latent_dim)))
        eps.append(jax.random.uniform(gp_rng, (b, 1)))
        sh.append(shifts(ps_rng))
    z_rng, ps_rng = jax.random.split(rngs[-1])
    z.append(jax.random.normal(z_rng, (b, jc.latent_dim)))
    sh.append(shifts(ps_rng))
    return {k: torch.tensor(np.stack([np.asarray(x) for x in v]))
            for k, v in (("z", z), ("eps", eps), ("shifts", sh))}


def test_a_jax_wavegan_run_continues_in_the_port(tmp_path, capsys):
    """The JAX harness trains WaveGAN 2 steps; ``ckpt_to_torch.py --family
    wavegan`` converts the run: parameters and Adam moments arrive exactly
    (at the CLI's Adam, (1e-4, 0.5, 0.9)); the port's third step on JAX's
    draws matches JAX's third step at rtol 1e-4; the port CLI resumes the
    run at step 2."""
    jc = jwave.WaveGANConfig(slice_len=1024, latent_dim=16, width=8, n_critic=2,
                             dtype="float32")
    g, d = jwave.WaveGANGenerator(jc), jwave.WaveGANDiscriminator(jc)
    tx = jgan.adam(1e-4, 0.5, 0.9)
    gs, ds = jax.jit(lambda: jgan.make_states(g, d, (jnp.zeros((1, 16)),),
                                              (jnp.zeros((1, 1024)),), seed=0, g_tx=tx,
                                              d_tx=tx))()
    jstep = jax.jit(jgan.make_wavegan_train_step(g, d, jc))
    batches = [np.stack([[jloader.synthetic_speech(4 * k + 2 * c + i, 1024) for i in range(2)]
                         for c in range(2)]) for k in range(3)]
    gs, ds, _ = jharness.train_loop(jstep, gs, ds, iter(batches[:2]), str(tmp_path / "jax"),
                                    max_steps=2, ckpt_every=2, log_every=100, nan_check_every=0,
                                    config=dataclasses.asdict(jc))
    spec = importlib.util.spec_from_file_location("ckpt_to_torch",
                                                  ROOT / "scripts" / "ckpt_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.main(["--family", "wavegan", "--train_dir", str(tmp_path / "jax"), "--out",
                       str(tmp_path / "port")])

    cfg = wavegan.WaveGANConfig(**dataclasses.asdict(jc))
    tg, td = wavegan.WaveGANGenerator(cfg), wavegan.WaveGANDiscriminator(cfg)
    tgs, tds = gan.make_states(tg, td, seed=5, g_tx=gan.adam(1e-4, 0.5, 0.9),
                               d_tx=gan.adam(1e-4, 0.5, 0.9))
    mgr = CheckpointManager(out)
    mgr.restore(template={"g": tgs, "d": tds})
    mgr.close()
    assert tgs.step == 2 and tds.step == 4
    for state, tstate in ((gs, tgs), (ds, tds)):
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params), tstate.model)
        torch.testing.assert_close(dict(tstate.model.state_dict()), want, rtol=0, atol=0)
        nu = flax_to_state_dict(jax.tree.map(np.asarray, state.opt_state[0].nu), tstate.model)
        opt = tstate.opt.state_dict()
        assert opt["param_groups"][0]["betas"] == (0.5, 0.9)
        for (name, _), st in zip(tstate.model.named_parameters(), opt["state"].values()):
            torch.testing.assert_close(st["exp_avg_sq"], nu[name], rtol=0, atol=0)
            assert float(st["step"]) == int(state.step)

    key = jax.random.PRNGKey(3)
    _, _, jm = jstep(gs, ds, jnp.asarray(batches[2]), key)
    draws = _jax_draws(jc, key, 2)
    _, _, tm = gan.make_wavegan_train_step(tg, td, cfg)(tgs, tds, torch.tensor(batches[2]),
                                                        draws=draws)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)

    _, _, step = wcli.main(["--mode", "train", "--max_steps", "3",
                            *_args(out, "slice_len=1024,latent_dim=16,width=8,n_critic=2,"
                                   "dtype=float32")])
    assert step == 3 and "resumed from step 2" in capsys.readouterr().out


def test_eval_loop_passes_the_bundle(tmp_path):
    """eval_takes_bundle: eval_fn gets the restored {"g", "d"} states (the
    checkpoint's D weights and step), image_fn still the generator."""
    cfg = MelSpecGANConfig(latent_dim=16, width=16, n_critic=2, dtype="float32")

    def states():
        return gan.make_states(MelSpecGANGenerator(cfg), MelSpecGANDiscriminator(cfg), seed=0)

    gs, ds = gan.make_states(MelSpecGANGenerator(cfg), MelSpecGANDiscriminator(cfg), seed=7)
    ds.step = 3
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"g": gs, "d": ds}, wait=True)
    mgr.close()
    seen = {}

    @torch.no_grad()
    def eval_fn(bundle, batch):
        seen["bundle"] = bundle
        return {"eval_d_real": bundle["d"].model(batch).mean()}

    def image_fn(generator):
        seen["image"] = generator
        return []

    step = harness.eval_loop(eval_fn, states, lambda: iter([torch.rand(2, 64, 80)]),
                             str(tmp_path), once=True, image_fn=image_fn, eval_takes_bundle=True)
    assert step == 3 and sorted(seen["bundle"]) == ["d", "g"]
    assert seen["bundle"]["d"].step == 3
    torch.testing.assert_close(seen["bundle"]["d"].model.state_dict(), ds.model.state_dict())
    assert seen["image"] is seen["bundle"]["g"].model
