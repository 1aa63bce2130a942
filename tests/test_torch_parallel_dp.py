"""Data-parallel training of the port on the CPU: gloo ranks in one process
group, against the JAX package's ``jit_data_parallel`` on 2 of its CPU
devices and against the port's single-process step on the same global
batch and draws.

The step cases run in one spawn of two ranks for the whole module
(:func:`ranks`, the ranks' side in ``tests/torch_dp_cases.py``): advoc
with the corpus staged (each rank gathers its crops of the global starts)
and on the wire (each rank decodes its rows of the global batch), WaveGAN
(critics' batches split on axis 1, wgan-gp), the conditional WaveGAN
(wgan-gp) and MelSpecGAN (axis 1). Weights are the JAX tests' (converted),
the WaveGAN families take JAX's own draws of the global batch. Tolerances
are JAX's own DP gate (tests/test_train.py): metrics rtol 2e-4, atol 1e-5;
parameters after one Adam step atol 2.5·lr (where a gradient is ≈ 0 the
order of summation flips the ±lr·sign(g) first update); and, since that
bound holds for any gradient, each model's whole update within a relative
norm of the one-process step's (1e-2) and of JAX's (0.1). Then
``mp_check.run_check(2)``, and the advoc CLI's ``--n_devices 2`` runs: a
fresh one (one writer, one log line a window) and a converted JAX run
resumed on both ranks.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_melspecgan as tms
import test_torch_train as tt
import test_torch_wavegan as tw
import torch_dp_cases
from advoc_tpu.data import loader as jloader
from advoc_tpu.models.melspecgan import model as jmsg
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.parallel import data_mesh as jax_mesh
from advoc_tpu.train import gan as jgan
from advoc_tpu_torch.data import loader
from advoc_tpu_torch.models.advoc import AdvocConfig
from advoc_tpu_torch.models.advoc import train_evaluate as cli
from advoc_tpu_torch.models.convert import flax_to_state_dict
from advoc_tpu_torch.parallel import data_mesh, distributed, mp_check
from advoc_tpu_torch.train import harness
from advoc_tpu_torch.train.checkpoint import CheckpointManager
from advoc_tpu_torch.utils import ensure_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 4  # the global batch: 2 rows a rank
TINY = "width=8,depth=4,n_frames=64,disc_width=8,dtype=float32"
CASES = ["advoc_hbm", "advoc_wire", "wavegan", "cond_wavegan", "melspecgan"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads here (the suite runs six workers), one a rank."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _copy(model) -> dict:
    """The model's starting weights, apart from its parameters."""
    return {k: v.clone() for k, v in model.state_dict().items()}


def _melspecgan_jax():
    jc = jmsg.MelSpecGANConfig(**tms.SIZE)
    g, d = jmsg.MelSpecGANGenerator(jc), jmsg.MelSpecGANDiscriminator(jc)
    z0, m0 = jnp.zeros((1, jc.latent_dim)), jnp.zeros((1, jc.n_frames, jc.n_mels))
    gs, ds = (jgan.TrainState.create(apply_fn=m.apply, params=tw._flax_params(m, (x,), seed),
                                     tx=jgan.adam(*tms.ADAM))
              for seed, (m, x) in enumerate(((g, z0), (d, m0))))
    step = jax.jit(jgan.make_melspecgan_train_step(g, d, jc, P))
    return types.SimpleNamespace(cfg=jc, g=g, d=d, gs=gs, ds=ds, step=step)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per case: the JAX side, the port's single-process side, the global
    batch JAX's step takes, its key and batch axis, and the case dict the
    ranks run."""
    fps = ensure_dataset(None, str(tmp_path_factory.mktemp("corpus")))
    slice_len = 64 * P.hop_length
    it = jloader.decode_extract_and_batch(fps, batch_size=B, slice_len=slice_len, seed=0,
                                          out_dtype="int16")
    advoc_batch = next(it)
    it.close()
    out = {}
    j = tt._jax_side()
    t = tt._port_side(j)
    for placement in ("hbm", "wire"):
        case = dict(family="advoc", cfg=dataclasses.asdict(t.cfg), adam=((tt.LR, 0.5, 0.999),) * 2,
                    g=_copy(t.g), d=_copy(t.d), batch=None, draws=None,
                    batch_axis=0, placement=placement, fps=fps, slice_len=slice_len,
                    batch_size=B, seed=0)
        out[f"advoc_{placement}"] = types.SimpleNamespace(
            j=j, t=t, batch=advoc_batch, key=jax.random.PRNGKey(0), axis=0, lr=tt.LR, case=case)
    rng = np.random.default_rng(3)
    for name, j, batch, axis, lr in (
            ("wavegan", tw._jax_side(cond=False), rng.uniform(-0.5, 0.5, (2, B, 1024)), 1, 1e-4),
            ("cond_wavegan", tw._jax_side(cond=True, gan_type="wgan-gp"),
             tw._wav(B, 16 * P.hop_length, seed=5), 0, 2e-4),
            ("melspecgan", _melspecgan_jax(), tms._wav(2, B), 1, 1e-4)):
        port = (tms._port_side(j) if name == "melspecgan" else tw._port_side(j))
        key = jax.random.PRNGKey(1)
        draws = (tms._jax_draws(j, key, B) if name == "melspecgan"
                 else tw._t(tw._jax_draws(j, key, B)))
        adam = (tms.ADAM,) * 2 if name == "melspecgan" else (j.adam,) * 2
        case = dict(family=name, cfg=dataclasses.asdict(port.cfg), adam=adam,
                    g=_copy(port.g), d=_copy(port.d),
                    batch=np.asarray(batch, np.float32),
                    draws={k: v.numpy() for k, v in draws.items()}, batch_axis=axis)
        out[name] = types.SimpleNamespace(j=j, t=port, batch=np.asarray(batch, np.float32),
                                          key=key, axis=axis, lr=lr, case=case, draws=draws)
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case in each of two gloo ranks: one spawn for the module. While
    the ranks run, each case's reference steps: the port's one process on
    the whole batch, and JAX's data-parallel step on 2 of its devices."""
    path = tmp_path_factory.mktemp("dp") / "cases.pt"
    torch.save({name: s.case for name, s in setup.items()}, path)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(distributed.launch, torch_dp_cases.run,
                              data_mesh(devices=["cpu"] * 2), (str(path),), threads=1,
                              timeout_s=600)
        for s in setup.values():
            gs, ds, step = torch_dp_cases.build(s.case)
            kw = {} if s.case["draws"] is None else {"draws": s.draws}
            s.one = torch_dp_cases.result(*step(gs, ds, torch.tensor(s.batch), None, **kw))
            dp = jgan.jit_data_parallel(s.j.step, jax_mesh(2), batch_axis=s.axis, donate=False)
            s.jax = dp(s.j.gs, s.j.ds, jnp.asarray(s.batch), s.key)
        return spawned.result()


def _update_err(p1: dict, ref1: dict, p0: dict) -> float:
    """‖Δp − Δp_ref‖ / ‖Δp_ref‖ of a model's update Δ = p₁ − p₀, every
    parameter flattened into one vector."""
    d, d_ref = (np.concatenate([(p[k] - p0[k]).ravel() for k in p0]) for p in (p1, ref1))
    return float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref))


def _port_params(s, jgs, jds) -> dict:
    """JAX's updated parameters in the port's state-dict layout."""
    if s.case["family"] == "advoc":
        from advoc_tpu_torch.models.advoc import (flax_disc_to_torch_state_dict,
                                                  flax_to_torch_state_dict)
        return {"g": flax_to_torch_state_dict(_np(jgs.params), s.t.cfg),
                "d": flax_disc_to_torch_state_dict(_np(jds.params), s.t.cfg)}
    return {"g": flax_to_state_dict(_np(jgs.params), s.t.g),
            "d": flax_to_state_dict(_np(jds.params), s.t.d)}


@pytest.mark.parametrize("name", CASES)
def test_dp_step_matches_jax_and_one_process(setup, ranks, name):
    s = setup[name]
    got = [r[name] for r in ranks]
    # The ranks apply the same averaged gradients to the same weights.
    for part in ("g", "d"):
        for k in got[0][part]:
            np.testing.assert_array_equal(got[0][part][k], got[1][part][k], err_msg=k)
    assert got[0]["metrics"] == got[1]["metrics"]

    # The port's single-process step on the whole batch, with the same
    # draws, and JAX's data-parallel step on 2 of its CPU devices.
    one, (jgs, jds, jm) = s.one, s.jax
    assert got[0]["steps"] == one["steps"]
    want = _port_params(s, jgs, jds)
    assert sorted(got[0]["metrics"]) == sorted(jm)
    for k, v in got[0]["metrics"].items():
        np.testing.assert_allclose(v, one["metrics"][k], rtol=2e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(v, float(jm[k]), rtol=2e-4, atol=1e-5, err_msg=k)
    for part in ("g", "d"):
        for k, v in got[0][part].items():
            np.testing.assert_allclose(v, one[part][k], rtol=0, atol=2.5 * s.lr, err_msg=k)
            np.testing.assert_allclose(v, want[part][k].numpy(), rtol=0, atol=2.5 * s.lr,
                                       err_msg=k)
        # Each update is within ±lr whatever the gradient, so also hold the
        # updates themselves, ≈ −lr·sign(g) each, over the whole model: a
        # flipped update is 2 off, a lost one 1. Only where g ≈ 0 (a bias
        # that GroupNorm cancels) may the order of summation flip one; the
        # port's one-process step is 3.3e-3 off at most, JAX's 5.3e-2 (as
        # far as the two packages' one-process steps are apart).
        p0 = {k: v.numpy() for k, v in s.case[part].items()}
        jax_part = {k: v.numpy() for k, v in want[part].items()}
        for ref, rtol in ((one[part], 1e-2), (jax_part, 0.1)):
            err = _update_err(got[0][part], ref, p0)
            assert err <= rtol, (part, err)


def test_wire_rows_and_rank_rows(setup, monkeypatch):
    """A rank's rows of the wire's batches are the global batch's rows
    (the same crops drawn on every rank), for one stacked batch and for
    the critics' (n_critic·B, …) batches."""
    fps, sl = setup["advoc_wire"].case["fps"], 2048
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    assert harness.rank_rows(4) == [2, 3]
    assert harness.rank_rows(4, n_stacked=2) == [2, 3, 6, 7]
    whole = loader.decode_extract_and_batch(fps, batch_size=8, slice_len=sl, seed=4)
    part = loader.decode_extract_and_batch(fps, batch_size=8, slice_len=sl, seed=4,
                                           rows=harness.rank_rows(4, n_stacked=2))
    for _ in range(2):
        np.testing.assert_array_equal(next(part), next(whole)[[2, 3, 6, 7]])
    whole.close()
    part.close()
    with pytest.raises(ValueError, match="rows"):
        loader.decode_extract_and_batch(fps, batch_size=2, slice_len=sl, rows=[2])


def test_mp_check_reports_a_match():
    report = mp_check.run_check(num_processes=2)
    assert report["match"], report
    assert report["backend"] == "gloo" and report["devices"] == ["cpu", "cpu"]


def test_only_rank_zero_writes(tmp_path, monkeypatch, capsys):
    """A rank other than 0 runs the loop, checks the config rank 0 recorded
    and writes nothing: no checkpoint, summary or log line."""
    (tmp_path / "config.json").write_text(json.dumps({"a": 1}))
    monkeypatch.setattr(distributed, "is_main", lambda: False)
    cfg = AdvocConfig(width=8, depth=4, n_frames=64, disc_width=8, dtype="float32")
    gs, ds = tt.tgan.make_states(tt.AdvocGenerator(cfg), tt.PatchDiscriminator(cfg), seed=0)
    fake = lambda g, d, batch, gen: (g, d, {"d_loss": torch.tensor(1.0)})  # noqa: E731
    _, _, step = harness.train_loop(fake, gs, ds, iter(range(3)), str(tmp_path), max_steps=3,
                                    ckpt_every=1, log_every=1, summary_every=1, config={"a": 1})
    assert step == 3 and [p.name for p in tmp_path.iterdir()] == ["config.json"]
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="mismatch"):
        harness.train_loop(fake, gs, ds, iter(range(3)), str(tmp_path), config={"a": 2})


def _cli_args(train_dir, *extra):
    return ["--mode", "train", "--train_dir", str(train_dir), "--device", "cpu", "--batch_size",
            "4", "--model_overrides", TINY, "--log_every", "1", "--n_devices", "2", *extra]


def test_cli_trains_on_two_ranks(tmp_path, capfd):
    """--n_devices 2 on the CPU: two gloo ranks, one log line a window and
    one checkpoint, written by rank 0 (the resume is the next test's)."""
    assert cli.main(_cli_args(tmp_path, "--max_steps", "2", "--ckpt_every", "2")) == [(2, 2, 2)] * 2
    out = capfd.readouterr().out
    assert [out.count(f"[train] step {i} ") for i in (1, 2)] == [1, 1]
    assert out.count("2 data-parallel ranks") == out.count("checkpoint @ 2") == 1
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [2]
    mgr.close()
    assert json.loads((tmp_path / "config.json").read_text())["width"] == 8


def test_a_converted_jax_run_continues_data_parallel(setup, tmp_path, capfd):
    """The JAX states (tests/test_torch_train.py's tiny advoc run, counted
    at step 2) converted by scripts/ckpt_to_torch.py's converter into a
    port train_dir beside the JAX config.json, then resumed by two ranks
    on the wire: each rank restores step 2 (its states count 2 updates
    before the third), the resume is logged once, and rank 0 saves step 3.
    The script's orbax restore is tests/test_torch_harness.py's."""
    spec = importlib.util.spec_from_file_location("ckpt_to_torch",
                                                  ROOT / "scripts" / "ckpt_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    s = setup["advoc_wire"]
    state = script.convert_train_state(s.j.gs.replace(step=2), s.j.ds.replace(step=2), s.t.g, s.t.d)
    (tmp_path / "config.json").write_text(json.dumps(dataclasses.asdict(s.j.cfg)))
    mgr = CheckpointManager(tmp_path, use_async=False)
    mgr.save(2, state)
    mgr.close()
    argv = _cli_args(tmp_path, "--max_steps", "3", "--data_placement", "wire")
    assert cli.main(argv) == [(3, 3, 3)] * 2
    out = capfd.readouterr().out
    assert out.count("resumed from step 2") == 1 and out.count("[train] step 3 ") == 1
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [2, 3]
    mgr.close()


def test_initialize_joins_a_launchers_group(monkeypatch):
    """A single process joins nothing; processes started as torchrun starts
    them (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/MASTER_PORT in the
    environment) join one gloo group on the CPU."""
    import os
    import socket
    import subprocess
    import sys

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("import torch, torch.distributed as dist\n"
            "from advoc_tpu_torch.parallel import distributed\n"
            "assert distributed.initialize(device='cpu')\n"
            "x = torch.tensor([float(distributed.rank() + 1)])\n"
            "dist.all_reduce(x)\n"
            "print(distributed.rank(), distributed.world_size(), int(x), flush=True)\n"
            "dist.destroy_process_group()\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}) for r in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["0", "2", "3"], ["1", "2", "3"]]
