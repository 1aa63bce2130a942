#!/usr/bin/env python3
"""Convert a JAX inference bundle (orbax) into a PyTorch port bundle.

    python scripts/bundle_to_torch.py --bundle runs/advoc/bundle \\
        --out runs/advoc/bundle_torch

Runs where JAX is installed: it restores the flax generator parameters
with ``advoc_tpu.train.checkpoint.load_inference_bundle`` on the CPU,
converts them with ``advoc_tpu_torch.models.advoc.flax_to_torch_state_dict``
and writes ``advoc_tpu_torch.train.checkpoint.export_inference_bundle``'s
layout (``g_state.pt`` and the same ``config.json``). The generator's
config comes from ``--model_size`` and ``--model_overrides``, which
default to the bundle config's ``model_size`` and ``overrides`` keys (the
keys the JAX corpus runbook writes), else "full" and none
(``advoc_tpu_torch.train.checkpoint.generator_config``, the rule the
port's CLIs load the result by).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> pathlib.Path:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bundle", required=True, help="JAX inference bundle dir")
    p.add_argument("--out", required=True, help="port bundle dir to write")
    p.add_argument("--model_size", choices=["full", "small"], default=None)
    p.add_argument("--model_overrides", default=None)
    args = p.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    from advoc_tpu.train.checkpoint import load_inference_bundle as load_jax_bundle
    from advoc_tpu_torch.models.advoc import AdvocGenerator, flax_to_torch_state_dict
    from advoc_tpu_torch.train.checkpoint import export_inference_bundle, generator_config

    config = json.loads((pathlib.Path(args.bundle) / "config.json").read_text())
    cfg = generator_config(config, args.model_size, args.model_overrides)
    params, _ = load_jax_bundle(args.bundle)
    state = flax_to_torch_state_dict(jax.tree.map(np.asarray, params), cfg)
    AdvocGenerator(cfg).load_state_dict(state, strict=True)
    export_inference_bundle(args.out, state, config)
    print(f"[bundle_to_torch] {args.bundle} → {args.out} (width {cfg.width}, depth "
          f"{cfg.depth}, {len(state)} tensors)", flush=True)
    return pathlib.Path(args.out)


if __name__ == "__main__":
    main()
