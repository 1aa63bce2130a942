"""The port's training harness and checkpoints, after tests/test_harness.py,
and a JAX training run converted by scripts/ckpt_to_torch.py continuing in
the port (on the CPU)."""

import dataclasses
import importlib.util
import json
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader as jloader
from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.train import gan as jgan
from advoc_tpu.train import harness as jharness
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
from advoc_tpu_torch.train import gan, harness
from advoc_tpu_torch.train.checkpoint import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stub_states(seed=0):
    states = []
    for i in range(2):
        m = torch.nn.Linear(4, 4)
        with torch.no_grad():
            m.weight.copy_(torch.randn(4, 4, generator=torch.Generator().manual_seed(seed + i)))
            m.bias.zero_()
        states.append(gan.TrainState(m, gan.adam()(m.parameters())))
    return tuple(states)


def _ok_step(gstate, dstate, batch, generator):
    return gstate, dstate, {"loss": torch.tensor(1.0)}


def _nan_step(gstate, dstate, batch, generator):
    return gstate, dstate, {"loss": torch.tensor(float("nan"))}


def _batches(n):
    for _ in range(n):
        yield np.zeros((2, 4), np.float32)


def _latest(path):
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    mgr.close()
    return step


class TestTrainLoop:
    def test_runs_and_checkpoints(self, tmp_path):
        g, d = _stub_states()
        _, _, step = harness.train_loop(_ok_step, g, d, _batches(5), str(tmp_path), max_steps=5,
                                        ckpt_every=2, log_every=100, nan_check_every=0)
        assert step == 5
        assert _latest(tmp_path) == 5  # the final save

    def test_resume_continues_counting(self, tmp_path):
        g, d = _stub_states()
        harness.train_loop(_ok_step, g, d, _batches(3), str(tmp_path), max_steps=3,
                           ckpt_every=2, log_every=100, nan_check_every=0)
        g, d = _stub_states()
        _, _, step = harness.train_loop(_ok_step, g, d, _batches(10), str(tmp_path), max_steps=6,
                                        ckpt_every=2, log_every=100, nan_check_every=0)
        assert step == 6  # resumed at 3, stopped at 6

    def test_resume_restores_the_weights(self, tmp_path):
        """The states come back as saved: parameters, Adam moments, count."""
        def learning_step(gstate, dstate, batch, generator):
            x = torch.tensor(batch)
            for s in (gstate, dstate):
                loss = (s.model(x) ** 2).mean()
                s.apply_gradients(torch.autograd.grad(loss, s.params))
            return gstate, dstate, {"loss": loss.detach()}

        g, d = _stub_states()
        g, d, _ = harness.train_loop(learning_step, g, d, (np.ones((2, 4), np.float32) for _ in range(3)),
                                     str(tmp_path), max_steps=3, ckpt_every=10, log_every=100,
                                     nan_check_every=0)
        g2, d2 = _stub_states(seed=9)
        bundle, start = CheckpointManager(tmp_path).restore_or_init({"g": g2, "d": d2})
        assert start == 3 and bundle["g"] is g2 and g2.step == d2.step == 3
        torch.testing.assert_close(g2.model.state_dict(), g.model.state_dict(), rtol=0, atol=0)
        torch.testing.assert_close(g2.opt.state_dict()["state"], g.opt.state_dict()["state"],
                                   rtol=0, atol=0)

    def test_nan_guard_raises_and_saves(self, tmp_path):
        g, d = _stub_states()
        with pytest.raises(FloatingPointError, match="non-finite"):
            harness.train_loop(_nan_step, g, d, _batches(5), str(tmp_path), max_steps=5,
                               ckpt_every=100, log_every=100, nan_check_every=1)
        assert _latest(tmp_path) == 1  # the diverged checkpoint

    def test_explosion_guard_trips_on_finite_divergence(self, tmp_path):
        g, d = _stub_states()
        calls = {"n": 0}

        def exploding_step(gstate, dstate, batch, generator):
            calls["n"] += 1
            return gstate, dstate, {"d_loss": torch.tensor(0.01 if calls["n"] < 4 else 300.0)}

        with pytest.raises(FloatingPointError, match="explosion"):
            harness.train_loop(exploding_step, g, d, _batches(10), str(tmp_path), max_steps=10,
                               ckpt_every=100, log_every=100, nan_check_every=1)
        assert _latest(tmp_path) == 4

    def test_explosion_guard_tolerates_high_warmup_and_nonloss(self, tmp_path):
        g, d = _stub_states()
        calls = {"n": 0}

        def decaying_step(gstate, dstate, batch, generator):
            calls["n"] += 1
            return gstate, dstate, {
                "g_loss": torch.tensor(100.0 / calls["n"]),
                "d_loss": torch.tensor(0.001 * calls["n"]),
                "grad_norm": torch.tensor(1e6),
            }

        _, _, step = harness.train_loop(decaying_step, g, d, _batches(6), str(tmp_path),
                                        max_steps=6, ckpt_every=100, log_every=100,
                                        nan_check_every=1)
        assert step == 6

    def test_explosion_guard_disabled(self, tmp_path):
        g, d = _stub_states()
        calls = {"n": 0}

        def exploding_step(gstate, dstate, batch, generator):
            calls["n"] += 1
            return gstate, dstate, {"d_loss": torch.tensor(0.01 if calls["n"] < 3 else 1e9)}

        _, _, step = harness.train_loop(exploding_step, g, d, _batches(5), str(tmp_path / "off"),
                                        max_steps=5, ckpt_every=100, log_every=100,
                                        nan_check_every=1, explode_ratio=0.0)
        assert step == 5

    def test_log_lines_match_jax(self, tmp_path, capsys):
        g, d = _stub_states()
        harness.train_loop(_ok_step, g, d, _batches(2), str(tmp_path), max_steps=2,
                           ckpt_every=2, log_every=1, nan_check_every=0)
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train]")]
        assert lines[0].startswith("[train] step 1 (") and lines[0].endswith(" loss=1.0000")
        assert lines[-1] == "[train] checkpoint @ 2"


class TestRunConfig:
    def test_records_and_accepts_same_config(self, tmp_path):
        cfg = {"width": 64, "freq_pack": 2}
        harness.check_run_config(str(tmp_path), cfg)
        assert (tmp_path / "config.json").exists()
        harness.check_run_config(str(tmp_path), dict(cfg))

    def test_mismatch_raises_clear_error(self, tmp_path):
        harness.check_run_config(str(tmp_path), {"freq_pack": 1, "head_kernel": 4})
        with pytest.raises(ValueError, match="freq_pack"):
            harness.check_run_config(str(tmp_path), {"freq_pack": 2, "head_kernel": 4})

    def test_new_keys_are_backward_compatible(self, tmp_path):
        harness.check_run_config(str(tmp_path), {"width": 64})
        harness.check_run_config(str(tmp_path), {"width": 64, "new_knob": 7})

    def test_train_loop_records_config(self, tmp_path):
        g, d = _stub_states()
        harness.train_loop(_ok_step, g, d, _batches(2), str(tmp_path), max_steps=2,
                           ckpt_every=10, log_every=100, nan_check_every=0, config={"width": 64})
        assert json.loads((tmp_path / "config.json").read_text()) == {"width": 64}


class TestCheckpointManager:
    def test_async_save_restore_roundtrip(self, tmp_path):
        g, d = _stub_states()
        mgr = CheckpointManager(tmp_path, use_async=True)
        assert mgr.save(3, {"g": g, "d": d})
        mgr.wait_until_finished()
        assert mgr.latest_step() == 3
        g2, d2 = _stub_states(seed=5)
        out = mgr.restore(3, template={"g": g2, "d": d2})
        assert out["g"] is g2
        torch.testing.assert_close(g2.model.state_dict(), g.model.state_dict(), rtol=0, atol=0)
        raw = mgr.restore(3)
        assert raw["g"]["step"] == 0 and torch.is_tensor(raw["d"]["params"]["weight"])
        mgr.close()

    def test_close_finalizes_inflight_save(self, tmp_path):
        g, d = _stub_states()
        mgr = CheckpointManager(tmp_path, use_async=True)
        mgr.save(7, {"g": g, "d": d})
        mgr.close()
        assert _latest(tmp_path) == 7

    def test_keep_k_and_atomic_steps(self, tmp_path):
        g, d = _stub_states()
        mgr = CheckpointManager(tmp_path, max_to_keep=2)
        for s in range(2, 7, 2):
            mgr.save(s, {"g": g, "d": d})
        assert not mgr.save(6, {"g": g, "d": d})  # already saved
        mgr.wait_until_finished()
        assert mgr.all_steps() == [4, 6]
        # An unfinished write (no file yet, or a temporary directory) is no step.
        (tmp_path / "8").mkdir()
        (tmp_path / ".tmp-9-1").mkdir()
        assert mgr.latest_step() == 6
        mgr.close()
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            CheckpointManager(tmp_path / "empty").restore()

    @staticmethod
    def _saves_as_jax(tmp_path, calls, **kw):
        """The same (step, force) saves on JAX's manager and the port's:
        the same answers, the same steps kept."""
        from advoc_tpu.train.checkpoint import CheckpointManager as JaxManager

        g, d = _stub_states()
        jmgr = JaxManager(tmp_path / "jax", max_to_keep=10, use_async=False, **kw)
        mgr = CheckpointManager(tmp_path / "port", max_to_keep=10, use_async=False, **kw)
        for step, force in calls:
            want = jmgr.save(step, {"w": jnp.full((2,), step)}, force=force)
            assert mgr.save(step, {"g": g, "d": d}, force=force) == want, (step, force)
        jmgr.close()
        assert mgr.all_steps() == sorted(int(p.name) for p in (tmp_path / "jax").iterdir()
                                         if p.name.isdigit())
        mgr.close()
        return mgr.all_steps()

    def test_save_interval_steps_as_jax(self, tmp_path):
        steps = self._saves_as_jax(tmp_path, [(s, False) for s in (1, 2, 3, 4, 2, 5, 6, 9)],
                                   save_interval_steps=2)
        assert steps == [1, 2, 4, 6]  # the first, then multiples of 2 past the latest

    def test_save_force_as_jax(self, tmp_path):
        calls = [(1, False), (2, False), (3, True), (5, False), (4, False), (4, True), (6, False)]
        steps = self._saves_as_jax(tmp_path, calls, save_interval_steps=3)
        assert steps == [1, 3, 4, 6]  # forced past the cadence, never over a saved step

    def test_optimizer_keeps_its_implementation_flags(self, tmp_path):
        """A state saved from a fused (card) optimizer loads into the CPU's."""
        g, d = _stub_states()
        sd = {"g": g.state_dict(), "d": d.state_dict()}
        for s in sd.values():
            s["opt"]["param_groups"][0]["fused"] = True
        g2, d2 = _stub_states()
        g2.load_state_dict(sd["g"])
        assert not g2.opt.param_groups[0]["fused"]


class TestEvalLoop:
    def _two_ckpts(self, tmp_path):
        g, d = _stub_states()
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"g": g, "d": d}, wait=True)
        mgr.save(2, {"g": g, "d": d}, wait=True)
        mgr.close()

    def test_eval_once_averages_and_writes_summaries(self, tmp_path):
        self._two_ckpts(tmp_path)
        calls = []

        def eval_fn(generator, batch):
            assert isinstance(generator, torch.nn.Linear)
            calls.append(batch.shape)
            return {"l1": torch.tensor(float(len(calls)))}

        seen = harness.eval_loop(
            eval_fn, _stub_states, lambda: _batches(3), str(tmp_path), once=True,
            audio_fn=lambda g: [("wav", np.zeros(100, np.float32), 22050)],
            image_fn=lambda g: [("img", np.zeros((8, 8), np.float32))])
        assert seen == 2 and len(calls) == 3
        from tensorboard.backend.event_processing import event_accumulator

        acc = event_accumulator.EventAccumulator(str(tmp_path / "tb_eval"))
        acc.Reload()
        tags = acc.Tags()
        assert "l1" in tags["scalars"] and "img" in tags["images"] and "wav" in tags["audio"], tags
        assert abs(acc.Scalars("l1")[0].value - 2.0) < 1e-6  # (1 + 2 + 3) / 3

    def test_poll_times_out_without_new_ckpts(self, tmp_path):
        self._two_ckpts(tmp_path)
        seen = harness.eval_loop(lambda g, b: {"m": torch.tensor(0.0)}, _stub_states,
                                 lambda: _batches(1), str(tmp_path), once=False, timeout_s=0.0)
        assert seen == 2


class TestCrossProcessPoll:
    def test_poll_sees_ckpts_written_after_construction(self, tmp_path):
        g, d = _stub_states()
        poller = CheckpointManager(tmp_path)
        assert poller.latest_step() is None
        writer = CheckpointManager(tmp_path)
        writer.save(3, {"g": g, "d": d}, wait=True)
        writer.close()
        assert list(poller.poll(last_seen=None, interval_s=0.01, timeout_s=0.0)) == [3]
        poller.close()

    def test_eval_loop_started_before_first_ckpt(self, tmp_path):
        g, d = _stub_states()
        seen = []

        def eval_fn(generator, batch):
            seen.append(1)
            return {"m": torch.tensor(1.0)}

        t = threading.Thread(target=lambda: harness.eval_loop(
            eval_fn, _stub_states, lambda: _batches(1), str(tmp_path), once=False,
            timeout_s=8.0))
        t.start()
        time.sleep(1.0)
        writer = CheckpointManager(tmp_path)
        writer.save(7, {"g": g, "d": d}, wait=True)
        writer.close()
        t.join(timeout=90)
        assert not t.is_alive() and seen, (t.is_alive(), seen)


def _ckpt_script():
    spec = importlib.util.spec_from_file_location("ckpt_to_torch",
                                                  ROOT / "scripts" / "ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_run_converted_continues_in_the_port(tmp_path):
    """A JAX train_loop of 2 steps at the JAX tests' size, converted by
    scripts/ckpt_to_torch.py: the parameters and Adam states arrive exactly,
    and the port's third step matches JAX's third step on the same batch
    within 1e-4 relative (each package featurizing; measured ≤ 3e-5)."""
    size = dict(n_frames=64, width=8, depth=4, disc_width=8, dtype="float32")
    jc = jmodel.AdvocConfig(**size)
    g, d = jmodel.AdvocGenerator(jc), jmodel.PatchDiscriminator(jc)
    est0 = jnp.zeros((1, 64, 513))
    gs, ds = jax.jit(lambda: jgan.make_states(g, d, (est0,), (est0, est0), seed=0))()
    jstep = jax.jit(jgan.make_advoc_train_step(g, d, jc, P))
    batches = [np.stack([jloader.synthetic_speech(3 * k + i, 64 * 256) for i in range(2)])
               for k in range(3)]
    gs, ds, _ = jharness.train_loop(jstep, gs, ds, iter(batches[:2]), str(tmp_path / "jax"),
                                    max_steps=2, ckpt_every=2, log_every=100, nan_check_every=0,
                                    config=dataclasses.asdict(jc))
    out = _ckpt_script().main(["--train_dir", str(tmp_path / "jax"), "--out", str(tmp_path / "port")])

    cfg = AdvocConfig(**size)
    tg, td = AdvocGenerator(cfg), PatchDiscriminator(cfg)
    tgs, tds = gan.make_states(tg, td, seed=5)
    mgr = CheckpointManager(out)
    mgr.restore(template={"g": tgs, "d": tds})
    mgr.close()
    assert tgs.step == tds.step == 2
    assert json.loads((out / "config.json").read_text()) == dataclasses.asdict(jc)
    from advoc_tpu_torch.models.advoc import flax_to_torch_state_dict

    want = flax_to_torch_state_dict(jax.tree.map(np.asarray, gs.params), cfg)
    torch.testing.assert_close(dict(tg.state_dict()), want, rtol=0, atol=0)
    mu = flax_to_torch_state_dict(jax.tree.map(np.asarray, gs.opt_state[0].mu), cfg)
    for (name, _), st in zip(tg.named_parameters(), tgs.opt.state_dict()["state"].values()):
        torch.testing.assert_close(st["exp_avg"], mu[name], rtol=0, atol=0)
        assert float(st["step"]) == 2

    _, _, jm = jstep(gs, ds, jnp.asarray(batches[2]), jax.random.PRNGKey(0))
    tgs, tds, tm = gan.make_advoc_train_step(tg, td, cfg)(tgs, tds, torch.tensor(batches[2]))
    assert tgs.step == 3
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_metrics_helpers_match_jax():
    """to_host reads a dict of scalars back as floats (one stacked copy);
    StepTimer leaves its warmup ticks out, as the JAX package's."""
    from advoc_tpu.train import metrics as jmetrics
    from advoc_tpu_torch.train import metrics

    m = {"b": torch.tensor(2.5), "a": 1, "c": torch.tensor([0.25])}
    assert metrics.to_host(m) == jmetrics.to_host({k: jnp.asarray(v) for k, v in
                                                   {"b": 2.5, "a": 1, "c": 0.25}.items()})
    timers = (metrics.StepTimer(warmup=2), jmetrics.StepTimer(warmup=2))
    ticks = [[t.tick() for _ in range(4)] for t in timers]
    assert [[v is None for v in row] for row in ticks] == [[True, True, False, False]] * 2
    assert all(v > 0 for v in ticks[0][2:])
