"""Config plumbing: the ``--model_overrides`` flag on a frozen dataclass.

The port's copy of ``advoc_tpu.utils.config.apply_overrides``. The JAX
module's ``enable_compilation_cache`` is XLA's and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
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
