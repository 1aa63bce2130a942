"""The ranks' side of tests/test_torch_parallel_dp.py: every data-parallel
case of one file, run by each spawned rank (``distributed.launch`` pickles
:func:`run` by this module's name; it imports torch and the port only).

A case is a dict: ``family`` (advoc, wavegan, cond_wavegan, melspecgan),
``cfg`` (the config's fields), ``adam`` ((lr, b1, b2) of G and of D),
``g``/``d`` (state dicts), ``batch`` (the global batch, numpy), ``draws``
(the global batch's, numpy, or None), ``batch_axis``, and for advoc
``placement`` ("hbm" or "wire") with ``fps`` and ``seed``: the rank then
gathers its crops from the staged corpus or decodes its rows of the wire's
first batch, in place of ``batch``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from advoc_tpu_torch.data import loader
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, PatchDiscriminator
from advoc_tpu_torch.models.melspecgan import (
    MelSpecGANConfig,
    MelSpecGANDiscriminator,
    MelSpecGANGenerator,
)
from advoc_tpu_torch.models.wavegan import (
    CondWaveGANConfig,
    CondWaveGANDiscriminator,
    CondWaveGANGenerator,
    WaveGANConfig,
    WaveGANDiscriminator,
    WaveGANGenerator,
)
from advoc_tpu_torch.train import gan, harness

FAMILIES = {
    "advoc": (AdvocConfig, AdvocGenerator, PatchDiscriminator, gan.make_advoc_train_step),
    "wavegan": (WaveGANConfig, WaveGANGenerator, WaveGANDiscriminator,
                gan.make_wavegan_train_step),
    "cond_wavegan": (CondWaveGANConfig, CondWaveGANGenerator, CondWaveGANDiscriminator,
                     gan.make_cond_wavegan_train_step),
    "melspecgan": (MelSpecGANConfig, MelSpecGANGenerator, MelSpecGANDiscriminator,
                   gan.make_melspecgan_train_step),
}


def build(case: dict, group=None):
    """The case's port models and states (``group``: averaging over it)
    and its step maker's step."""
    cls_cfg, cls_g, cls_d, make_step = FAMILIES[case["family"]]
    cfg = cls_cfg(**case["cfg"])
    g, d = cls_g(cfg), cls_d(cfg)
    (g_adam, d_adam) = case["adam"]
    gs, ds = gan.make_states(g, d, seed=0, g_tx=gan.adam(*g_adam), d_tx=gan.adam(*d_adam),
                             group=group)
    g.load_state_dict(case["g"])
    d.load_state_dict(case["d"])
    return gs, ds, make_step(g, d, cfg)


def result(gs, ds, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": {k: v.detach().numpy().copy() for k, v in gs.model.state_dict().items()},
            "d": {k: v.detach().numpy().copy() for k, v in ds.model.state_dict().items()},
            "steps": (gs.step, ds.step)}


def run_case(case: dict) -> dict:
    group = dist.group.WORLD
    gs, ds, step = build(case, group)
    draws = case["draws"]
    kw = {} if draws is None else {"draws": {k: torch.tensor(v) for k, v in draws.items()}}
    placement = case.get("placement")
    if placement == "hbm":
        corpus = loader.DeviceCorpus(case["fps"], case["slice_len"], device="cpu")
        batch = next(corpus.starts(case["batch_size"], seed=case["seed"]))
        step = gan.data_parallel(loader.hbm_data_step(step, corpus))
    elif placement == "wire":
        it = loader.decode_extract_and_batch(
            case["fps"], batch_size=case["batch_size"], slice_len=case["slice_len"],
            seed=case["seed"], out_dtype="int16", rows=harness.rank_rows(case["batch_size"]))
        batch = torch.tensor(next(it))
        it.close()
        step = gan.data_parallel(step, batch_axis=None)
    else:
        batch = torch.tensor(case["batch"])
        step = gan.data_parallel(step, batch_axis=case["batch_axis"])
    return result(*step(gs, ds, batch, None, **kw))


def run(path: str) -> dict:
    """Every case of the file at ``path`` (``torch.save``'d), in this rank."""
    cases = torch.load(path, weights_only=False)
    return {name: run_case(case) for name, case in cases.items()}
