"""``scripts/run_corpus_torch.py`` and ``scripts/corpus_rehearsal_torch.py``
end to end on the CPU with no JAX anywhere.

Each runs as a child whose PYTHONPATH is led by a stub ``jax`` package
whose import raises, so the script and every stage it starts (each a child
of its own) prove that they import no JAX: an import would fail the stage
and the run. The tiny variant of tests/test_cli.py's runbook test.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY = "width=8,depth=4,n_frames=64,disc_width=8,dtype=float32"


@pytest.fixture
def no_jax_env(tmp_path):
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("no JAX in the port\'s tools")\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(stub.parent), str(ROOT)])
    env["OMP_NUM_THREADS"] = "2"  # the suite's workers share the cores
    check = subprocess.run([sys.executable, "-c", "import jax"], env=env, capture_output=True,
                           text=True)
    assert check.returncode != 0 and "no JAX" in check.stderr
    return env


def test_run_corpus_end_to_end_without_jax(tmp_path, no_jax_env):
    """Every stage runs (the build stage skipped with its reason under
    --cpu), the concurrent eval drains, the serve selftest reports, and the
    result line says ok."""
    cmd = [sys.executable, str(ROOT / "scripts" / "run_corpus_torch.py"),
           "--corpus_dir", str(tmp_path / "corpus"), "--run_dir", str(tmp_path / "run"),
           "--synthetic", "6", "--cpu", "--model_overrides", TINY,
           "--max_steps", "2", "--ckpt_every", "2", "--batch_size", "2",
           "--eval_fraction", "0.25", "--eval_timeout_s", "15",
           "--gl_iters", "2", "--serve_clients", "1"]
    proc = subprocess.run(cmd, env=no_jax_env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    m = re.search(r"RUN_CORPUS_RESULT (\{.*\})", proc.stdout)
    assert m, proc.stdout[-2000:]
    r = json.loads(m.group(1))
    assert r["ok"] and r["device"] == "cpu"
    assert set(r["stages_s"]) == {"synthesize", "prep", "train", "eval_drain", "bundle",
                                  "panel", "aot", "serve"}
    assert "--cpu" in r["build"]["skipped"]
    assert r["serve"]["n_clients"] == 1 and r["serve"]["pushes"] == 6
    assert "eval_last" in r and any("| dc |" in ln for ln in r["panel_tail"])
    logs = tmp_path / "run" / "logs"
    for name in ("prep", "train", "eval", "bundle", "panel", "aot", "serve"):
        assert (logs / f"{name}.log").is_file(), name
    assert (tmp_path / "run" / "bundle" / "g_state.pt").is_file()
    assert (tmp_path / "run" / "aot" / "manifest.json").is_file()


def test_corpus_rehearsal_without_jax(tmp_path, no_jax_env):
    """The rehearsal's own workflow: corpus, prep, train, the report."""
    cmd = [sys.executable, str(ROOT / "scripts" / "corpus_rehearsal_torch.py"),
           "--corpus_dir", str(tmp_path / "corpus"), "--train_dir", str(tmp_path / "train"),
           "--n_files", "4", "--max_steps", "2", "--ckpt_every", "2", "--batch_size", "2",
           "--skip_eval", "--device", "cpu", "--model_overrides", TINY]
    proc = subprocess.run(cmd, env=no_jax_env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout[proc.stdout.index("[rehearsal] {") + len("[rehearsal] "):])
    assert report["n_files"] == 4 and report["checkpoints"] == [2]
    assert report["eval_last"] is None and report["checkpoint_mb"] > 0


def test_run_corpus_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = importlib.util.spec_from_file_location("port_run_corpus_torch",
                                                  ROOT / "scripts" / "run_corpus_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--corpus_dir", str(tmp_path / "c"), "--run_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
