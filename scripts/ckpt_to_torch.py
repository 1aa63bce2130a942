#!/usr/bin/env python3
"""Convert a JAX training run (orbax checkpoints) into a PyTorch port run.

    python scripts/ckpt_to_torch.py --train_dir runs/advoc --out runs/advoc_torch

Runs where JAX is installed. It reads the run's recorded ``config.json``
(written by ``advoc_tpu.train.harness``), restores the JAX generator and
discriminator ``TrainState``\\ s of ``--step`` (default: the latest) on the
CPU, converts their parameters (``flax_to_torch_state_dict``,
``flax_disc_to_torch_state_dict``) and Adam states (``optax_adam_to_torch``,
at ``--lr``, the learning rate the run was built with: optax keeps it out of
the state), and writes them with the port's ``CheckpointManager`` at the
same step beside a copy of ``config.json``. The port's
``python -m advoc_tpu_torch.models.advoc.train_evaluate --train_dir <out>``
then resumes the run.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def convert_train_state(gstate, dstate, cfg, lr: float = 2e-4, b1: float = 0.5,
                        b2: float = 0.999) -> dict:
    """``{"g": ..., "d": ...}`` port ``TrainState`` state dicts from flax
    ``TrainState``\\ s built on ``optax.adam(lr, b1, b2)`` (``cfg`` the port's
    ``AdvocConfig`` of the run)."""
    import jax
    import numpy as np

    from advoc_tpu_torch.models.advoc import (
        AdvocGenerator,
        PatchDiscriminator,
        flax_disc_to_torch_state_dict,
        flax_to_torch_state_dict,
        optax_adam_to_torch,
    )

    out = {}
    for key, state, module, convert in (
        ("g", gstate, AdvocGenerator(cfg), flax_to_torch_state_dict),
        ("d", dstate, PatchDiscriminator(cfg), flax_disc_to_torch_state_dict),
    ):
        # optax.adam is chain(scale_by_adam, scale_by_learning_rate): the
        # moments are in the ScaleByAdamState.
        adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                    if hasattr(s, "mu"))
        as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        out[key] = {
            "params": convert(as_np(state.params), cfg),
            "opt": optax_adam_to_torch(as_np(adam.mu), as_np(adam.nu), int(adam.count), module,
                                       lr=lr, b1=b1, b2=b2),
            "step": int(state.step),
        }
    return out


def main(argv=None) -> pathlib.Path:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_dir", required=True, help="JAX training run (orbax checkpoints)")
    p.add_argument("--out", required=True, help="port training run to write")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--lr", type=float, default=2e-4, help="the run's Adam learning rate")
    args = p.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp

    from advoc_tpu.models.advoc import model as jmodel
    from advoc_tpu.train import gan as jgan
    from advoc_tpu.train.checkpoint import CheckpointManager as JaxManager
    from advoc_tpu_torch.models.advoc.model import AdvocConfig
    from advoc_tpu_torch.train.checkpoint import CheckpointManager

    src, dst = pathlib.Path(args.train_dir), pathlib.Path(args.out)
    recorded = json.loads((src / "config.json").read_text())
    jcfg = jmodel.AdvocConfig(**recorded)
    est0 = jnp.zeros((1, jcfg.n_frames, jcfg.n_freq))
    cond0 = jnp.zeros((1, jcfg.n_frames, 80)) if jcfg.condition_on == "mel" else est0
    gstate, dstate = jgan.make_states(
        jmodel.AdvocGenerator(jcfg), jmodel.PatchDiscriminator(jcfg), (est0,), (cond0, est0),
        g_tx=jgan.adam(args.lr), d_tx=jgan.adam(args.lr))
    jmgr = JaxManager(src)
    step = args.step if args.step is not None else jmgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {src}")
    bundle = jmgr.restore(step, template={"g": gstate, "d": dstate})
    jmgr.close()

    state = convert_train_state(bundle["g"], bundle["d"], AdvocConfig(**recorded), lr=args.lr)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src / "config.json", dst / "config.json")
    mgr = CheckpointManager(dst, use_async=False)
    if not mgr.save(step, state):
        raise FileExistsError(f"{dst} already holds step {step}")
    mgr.close()
    print(f"[ckpt_to_torch] {src} step {step} → {dst}", flush=True)
    return dst


if __name__ == "__main__":
    main()
