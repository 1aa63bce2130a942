#!/usr/bin/env python3
"""Convert a JAX training run (orbax checkpoints) into a PyTorch port run.

    python scripts/ckpt_to_torch.py --train_dir runs/advoc --out runs/advoc_torch
    python scripts/ckpt_to_torch.py --family wavegan --train_dir runs/wavegan \\
        --out runs/wavegan_torch

Runs where JAX is installed. ``--family`` (advoc, wavegan, cond_wavegan or
melspecgan; default advoc) names the model family of the run. It reads the
run's recorded ``config.json`` (written by ``advoc_tpu.train.harness``),
restores the JAX generator and discriminator ``TrainState``\\ s of ``--step``
(default: the latest) on the CPU, converts their parameters
(``state_dict_from_flax``) and Adam states (``optax_adam_to_torch``, at the
learning rates and betas the family's CLI builds its optimizers with:
optax keeps them out of the state; ``--lr`` and ``--d_lr`` override the
learning rates), and writes them with the port's ``CheckpointManager`` at
the same step beside a copy of ``config.json``. The family's port CLI,
``python -m advoc_tpu_torch.models.<family>.train_evaluate --train_dir
<out>`` (``models.wavegan`` with ``--conditional`` for cond_wavegan), then
resumes the run.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# The Adam (lr, b1, b2) of each family's G and D, as its CLI builds them.
ADAM = {
    "advoc": ((2e-4, 0.5, 0.999), (2e-4, 0.5, 0.999)),
    "wavegan": ((1e-4, 0.5, 0.9), (1e-4, 0.5, 0.9)),
    "cond_wavegan": ((2e-4, 0.5, 0.999), (2e-4, 0.5, 0.999)),
    "melspecgan": ((1e-4, 0.5, 0.9), (1e-4, 0.5, 0.9)),
}


def convert_train_state(gstate, dstate, g_module, d_module, g_adam=ADAM["advoc"][0],
                        d_adam=ADAM["advoc"][1]) -> dict:
    """``{"g": ..., "d": ...}`` port ``TrainState`` state dicts from flax
    ``TrainState``\\ s built on ``optax.adam(lr, b1, b2)`` with ``g_adam`` and
    ``d_adam``, for the port's ``g_module`` and ``d_module`` of the run."""
    import jax
    import numpy as np

    from advoc_tpu_torch.models.convert import optax_adam_to_torch, state_dict_from_flax

    out = {}
    for key, state, module, (lr, b1, b2) in (("g", gstate, g_module, g_adam),
                                             ("d", dstate, d_module, d_adam)):
        # optax.adam is chain(scale_by_adam, scale_by_learning_rate): the
        # moments are in the ScaleByAdamState.
        adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                    if hasattr(s, "mu"))
        as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        out[key] = {
            "params": state_dict_from_flax(as_np(state.params), module),
            "opt": optax_adam_to_torch(as_np(adam.mu), as_np(adam.nu), int(adam.count), module,
                                       lr=lr, b1=b1, b2=b2),
            "step": int(state.step),
        }
    return out


def _family(name: str, recorded: dict):
    """(JAX G, JAX D, their init inputs, port G, port D) of a run."""
    import jax.numpy as jnp

    if name == "advoc":
        from advoc_tpu.models.advoc import model as jm
        from advoc_tpu_torch.models import advoc as tm

        jc, tc = jm.AdvocConfig(**recorded), tm.AdvocConfig(**recorded)
        est0 = jnp.zeros((1, jc.n_frames, jc.n_freq))
        cond0 = jnp.zeros((1, jc.n_frames, 80)) if jc.condition_on == "mel" else est0
        return (jm.AdvocGenerator(jc), jm.PatchDiscriminator(jc), (est0,), (cond0, est0),
                tm.AdvocGenerator(tc), tm.PatchDiscriminator(tc))
    if name == "wavegan":
        from advoc_tpu.models.wavegan import model as jm
        from advoc_tpu_torch.models import wavegan as tm

        jc, tc = jm.WaveGANConfig(**recorded), tm.WaveGANConfig(**recorded)
        return (jm.WaveGANGenerator(jc), jm.WaveGANDiscriminator(jc),
                (jnp.zeros((1, jc.latent_dim)),), (jnp.zeros((1, jc.slice_len)),),
                tm.WaveGANGenerator(tc), tm.WaveGANDiscriminator(tc))
    if name == "cond_wavegan":
        from advoc_tpu.models.wavegan import conditional as jm
        from advoc_tpu_torch.models import wavegan as tm

        jc, tc = jm.CondWaveGANConfig(**recorded), tm.CondWaveGANConfig(**recorded)
        m0, w0 = jnp.zeros((1, jc.n_frames, jc.n_mels)), jnp.zeros((1, jc.slice_len))
        return (jm.CondWaveGANGenerator(jc), jm.CondWaveGANDiscriminator(jc), (m0,), (w0, m0),
                tm.CondWaveGANGenerator(tc), tm.CondWaveGANDiscriminator(tc))
    from advoc_tpu.models.melspecgan import model as jm
    from advoc_tpu_torch.models import melspecgan as tm

    jc, tc = jm.MelSpecGANConfig(**recorded), tm.MelSpecGANConfig(**recorded)
    return (jm.MelSpecGANGenerator(jc), jm.MelSpecGANDiscriminator(jc),
            (jnp.zeros((1, jc.latent_dim)),), (jnp.zeros((1, jc.n_frames, jc.n_mels)),),
            tm.MelSpecGANGenerator(tc), tm.MelSpecGANDiscriminator(tc))


def main(argv=None) -> pathlib.Path:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_dir", required=True, help="JAX training run (orbax checkpoints)")
    p.add_argument("--out", required=True, help="port training run to write")
    p.add_argument("--family", choices=sorted(ADAM), default="advoc",
                   help="the run's model family (default advoc)")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--lr", type=float, default=None,
                   help="the run's Adam learning rate (default: the family CLI's)")
    p.add_argument("--d_lr", type=float, default=None,
                   help="the discriminator's, where it differs (cond_wavegan --d_lr)")
    args = p.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from advoc_tpu.train import gan as jgan
    from advoc_tpu.train.checkpoint import CheckpointManager as JaxManager
    from advoc_tpu_torch.train.checkpoint import CheckpointManager

    src, dst = pathlib.Path(args.train_dir), pathlib.Path(args.out)
    recorded = json.loads((src / "config.json").read_text())
    jg, jd, g_init, d_init, tg, td = _family(args.family, recorded)
    (g_lr, b1, b2), (d_lr, d_b1, d_b2) = ADAM[args.family]
    g_lr = args.lr or g_lr
    d_lr = args.d_lr or args.lr or d_lr
    # The restore's template: only its structure counts, so it is built
    # under jit (eager flax init of both models takes tens of seconds).
    gstate, dstate = jax.jit(lambda: jgan.make_states(
        jg, jd, g_init, d_init, g_tx=jgan.adam(g_lr, b1, b2),
        d_tx=jgan.adam(d_lr, d_b1, d_b2)))()
    jmgr = JaxManager(src)
    step = args.step if args.step is not None else jmgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {src}")
    bundle = jmgr.restore(step, template={"g": gstate, "d": dstate})
    jmgr.close()

    state = convert_train_state(bundle["g"], bundle["d"], tg, td, (g_lr, b1, b2),
                                (d_lr, d_b1, d_b2))
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src / "config.json", dst / "config.json")
    mgr = CheckpointManager(dst, use_async=False)
    if not mgr.save(step, state):
        raise FileExistsError(f"{dst} already holds step {step}")
    mgr.close()
    print(f"[ckpt_to_torch] {args.family} {src} step {step} → {dst}", flush=True)
    return dst


if __name__ == "__main__":
    main()
