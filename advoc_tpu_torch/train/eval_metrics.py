"""Evaluation metrics of the port.

So far the distribution panel of MelSpecGAN's eval
(``advoc_tpu.train.eval_metrics.melspec_moment_panel``); STOI, the stress
panel and ``vocoder_eval`` are not ported yet (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def melspec_moment_panel(real: Tensor, fake: Tensor) -> dict[str, Tensor]:
    """Distribution metrics of generated mel spectrograms against a real
    batch, both (B, T, M) normalized mels; 0-d tensors:

    * ``eval_band_{mean,std}_l1``: per-band first and second moments (over
      batch and time), L1 against real: the spectral envelope;
    * ``eval_diversity_gap``: |across-sample std (per time × band, averaged),
      fake − real|: a collapsed generator has none;
    * ``eval_{mean,std}_gap``: the global moments.

    Standard deviations are the population's (numpy's and JAX's ``std``).
    """
    rm, fm = real.mean(dim=(0, 1)), fake.mean(dim=(0, 1))
    rs, fs = real.std(dim=(0, 1), correction=0), fake.std(dim=(0, 1), correction=0)
    div_r = real.std(dim=0, correction=0).mean()
    div_f = fake.std(dim=0, correction=0).mean()
    return {
        "eval_mean_gap": torch.abs(fake.mean() - real.mean()),
        "eval_std_gap": torch.abs(fake.std(correction=0) - real.std(correction=0)),
        "eval_band_mean_l1": torch.mean(torch.abs(fm - rm)),
        "eval_band_std_l1": torch.mean(torch.abs(fs - rs)),
        "eval_diversity_gap": torch.abs(div_f - div_r),
    }
