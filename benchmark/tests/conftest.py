"""Shared set-up of the benchmark's own tests (CPU; ``cuda``-marked tests
decide inside a fixture whether a card is there)."""

from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def tiny(monkeypatch):
    """The cells' files cut to a size the CPU runs in seconds (widths of the
    generator and rows only: the code paths are the cells')."""
    import common

    load = common.load

    def small(kind, name):
        d = load(kind, name)
        if kind == "configs":
            d["model"].update(width=8)
        if kind == "workloads":
            t = d["traffic"]
            if t["kind"] == "fixed_batch":
                t.update(batch=2, pool=2)
            else:
                t.update(utterances=10, batch=2)
        return d

    monkeypatch.setattr(common, "load", small)
    import torch

    torch.set_num_threads(2)
    return small
