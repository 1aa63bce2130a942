"""BENCHMARK.json and the files it names: each loads by name, the contract's
shapes hold, and nothing under benchmark/ imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re

import pytest
from conftest import BENCH

import common

ENTRY = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_names():
    assert set(ENTRY) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert ENTRY["paths"] == ["benchmark"] and 1 <= ENTRY["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in ENTRY[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in ENTRY["end_to_end"] + ENTRY["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in ENTRY["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(ENTRY)) < 64 * 1024


@pytest.mark.parametrize("w", ENTRY["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    wl = common.load("workloads", w["name"])
    cfg = common.load("configs", w["config"])
    assert (wl["config"], wl["chips"]) == (w["config"], w["chips"])
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
    assert {"model", "audio"} <= set(cfg)
    e2e = [m["name"] for m in ENTRY["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]]) for m in ENTRY["per_layer"])
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("path", sorted((BENCH / "workloads").glob("*.json")), ids=lambda p: p.stem)
def test_every_workload_file_runs_by_name(path):
    """Every workload file is a cell of BENCHMARK.json and resolves to a
    driver, a configuration and limits."""
    import run as bench

    entry, wl, cfg = bench.cell(path.stem)
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists() and cfg["model"]
    assert wl["limits"] and NAME.match(path.stem)


def test_unlisted_cell_refused():
    import run as bench

    with pytest.raises(SystemExit):
        bench.cell("advoc.no-such-cell")


@pytest.mark.parametrize("m", ENTRY["end_to_end"], ids=lambda m: m["name"])
def test_split_metric_names_its_quantity(m):
    """A metric ``<quantity>.<cells>`` is the driver's ``<quantity>`` in the
    cells it lists, and no cell reports two metrics of one quantity."""
    q = common.quantity(m["name"])
    assert q in {"vocode_xrt", "setup_s"}
    for w in m.get("workloads", [x["name"] for x in ENTRY["workloads"]]):
        same = [x["name"] for x in ENTRY["end_to_end"] if common.quantity(x["name"]) == q
                and w in x.get("workloads", [w])]
        assert same == [m["name"]]


@pytest.mark.parametrize("c", ENTRY["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = BENCH.parent / c["file"]
    assert path.exists() and c["file"].startswith("benchmark/")
    assert json.loads(path.read_text())["source"]


@pytest.mark.parametrize("m", ENTRY["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    read = common.metric_reader(m["name"])
    assert read({"config": {}}) is None  # nothing to read: nothing returned
    assert m["moves"] in [e["name"] for e in ENTRY["end_to_end"]]
    cells = {w["name"] for w in ENTRY["workloads"]}
    assert set(m["workloads"]) <= cells


def imports_of(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax(path):
    assert not imports_of(path) & {"jax", "jaxlib", "flax", "advoc_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not imports_of(path) & {"advoc_tpu_torch", "advoc_tpu", "jax"}
    assert imports_of(path) <= {"__future__", "dataclasses", "functools", "types", "numpy",
                                "torch"}
