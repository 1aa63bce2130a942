"""Config plumbing: the ``--model_overrides`` flag on a frozen dataclass,
and the data directory of the training CLI.

The port's copy of ``advoc_tpu.utils.config`` (``apply_overrides``,
``find_wavs``, ``ensure_dataset``). The JAX module's
``enable_compilation_cache`` is XLA's and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import TypeVar

T = TypeVar("T")


def apply_overrides(cfg: T, overrides: str | None) -> T:
    """Apply 'key=value,key2=value2' to a frozen dataclass config.

    Values are parsed with the field's type (bool accepts true/false/1/0).
    Unknown keys raise: a typo must not serve the wrong model silently.
    """
    if not overrides:
        return cfg
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for item in overrides.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, val = item.split("=", 1)
        key = key.strip()
        if key not in fields:
            raise ValueError(f"unknown config field {key!r}; valid: {sorted(fields)}")
        ftype = fields[key].type
        if ftype in (bool, "bool"):
            updates[key] = val.strip().lower() in ("1", "true", "yes")
        elif ftype in (int, "int"):
            updates[key] = int(val)
        elif ftype in (float, "float"):
            updates[key] = float(val)
        else:
            updates[key] = val.strip()
    return dataclasses.replace(cfg, **updates)


def find_wavs(data_dir: str | None, min_count: int = 1) -> list[str]:
    """The .wav files under ``data_dir`` (recursively), sorted; or the paths
    listed one per line in ``data_dir`` when it is a ``*.txt`` file (the
    output of scripts/prepare_dataset.py). ``min_count`` is accepted for the
    JAX signature and, as there, changes nothing: fewer files are returned
    as they are."""
    if data_dir is None:
        return []
    root = pathlib.Path(data_dir)
    if not root.exists():
        return []
    if root.is_file() and root.suffix == ".txt":
        return [ln.strip() for ln in root.read_text().splitlines() if ln.strip()]
    return sorted(str(p) for p in root.rglob("*.wav"))


def ensure_dataset(data_dir: str | None, tmp_dir: str, n_files: int = 8,
                   seconds: float = 4.0, sample_rate: int = 22050) -> list[str]:
    """The wavs of ``data_dir``; where it has none, a synthetic fixture set
    (``synthetic_speech`` of seeds 0..n_files−1, written to ``tmp_dir``), so
    every CLI runs end to end without a dataset."""
    fps = find_wavs(data_dir)
    if fps:
        return fps
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech

    out = pathlib.Path(tmp_dir)
    out.mkdir(parents=True, exist_ok=True)
    fps = []
    for i in range(n_files):
        p = out / f"synthetic_{i}.wav"
        if not p.exists():
            audioio.save_as_wav(synthetic_speech(i, int(seconds * sample_rate), sample_rate),
                                p, sample_rate)
        fps.append(str(p))
    print(f"[data] no wavs in {data_dir!r}; using {n_files} synthetic fixtures in {tmp_dir}",
          flush=True)
    return fps
