"""AOT export: the fused Vocoder as self-contained artifacts.

The port of ``advoc_tpu.infer.export``. :func:`export_vocoder` runs
``torch.export`` on the Vocoder's whole fused call (heuristic estimate →
U-Net repair in crossfaded chunks → mel-consistency projection → phase
recovery → waveform, ``Vocoder._run``) at each production shape, with the
generator's weights inside the artifact, and saves one ``.pt2`` file per
(batch, t_frames) beside a ``manifest.json`` with the JAX package's keys.
:class:`ExportedVocoder` serves such a directory with no model code: it
pads a call up to the tightest exported shape, runs the loaded program and
crops the waveform, the Vocoder's contract.

Portability (asserted in ``tests/test_torch_export.py``):

* An artifact runs on the device it was traced on (its constants and
  weights live there): ``platforms`` records ``"cuda"`` or ``"cpu"``, and
  loading it elsewhere raises.
* The port's hand-written kernels are recorded as the registered operators
  of :mod:`advoc_tpu_torch.ops.kernels.registered` (``advoc::griffin_lim``
  under ``phase_impl="auto"`` on the card or ``"kernel"``,
  ``advoc::packed_up`` under ``packed_tail`` on the card, and
  ``advoc::group_norm_act`` at each normalised U-Net level on the card).
  Such an artifact needs that module at load time and runs only where the
  operator has an implementation, so :func:`export_vocoder` refuses it
  unless ``allow_custom_calls=True``, as the JAX package refuses a Mosaic
  custom call. Without ``allow_custom_calls`` the U-Net's levels are traced
  as the plain GroupNorm's aten ops, so a ``phase_impl="xla"`` artifact is
  plain aten, on the card as on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
from typing import Sequence

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _artifact_name(batch: int, t_frames: int) -> str:
    return f"voc_b{batch}_t{t_frames}.pt2"


class _Fused(torch.nn.Module):
    """``Vocoder._run`` at one shape; the generator is a submodule, so its
    weights are the exported program's parameters."""

    def __init__(self, voc):
        super().__init__()
        self.generator = voc.generator
        self._run = voc._run

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self._run(mel, self.generator)


def export_vocoder(
    voc,
    shapes: Sequence[tuple[int, int]],
    out_dir: str | pathlib.Path,
    platforms: Sequence[str] | None = None,
    allow_custom_calls: bool = False,
) -> dict:
    """Export ``voc`` (an :class:`~advoc_tpu_torch.infer.Vocoder`) for each
    (batch, t_frames) into ``out_dir``; returns the manifest (also written
    to ``out_dir/manifest.json``).

    ``t_frames`` must be bucket-aligned (``voc.bucket(t) == t``).
    ``platforms`` may only name the Vocoder's own device type (a program
    runs where it was traced). An artifact that records a port kernel
    (module docstring) raises unless ``allow_custom_calls``.
    """
    from advoc_tpu_torch.ops.kernels import group_norm, registered

    if voc.mesh is not None:
        raise ValueError("export a Vocoder without a mesh (one device per artifact)")
    here = voc.device.type
    if platforms is not None and list(platforms) != [here]:
        raise ValueError(
            f"an artifact runs on the device it was traced on: this Vocoder's is {here!r}, "
            f"not {list(platforms)}; build the Vocoder there")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    p = voc.params
    fused = _Fused(voc)
    entries = []
    for batch, t_frames in shapes:
        if voc.bucket(t_frames) != t_frames:
            raise ValueError(
                f"t_frames={t_frames} is not bucket-aligned "
                f"(chunk_frames={voc.chunk}; nearest {voc.bucket(t_frames)})"
            )
        mel = torch.zeros((batch, t_frames, p.n_mels), device=voc.device)
        with torch.no_grad():
            fused(mel)  # builds the device constants, which the trace then records as constants
            with (contextlib.nullcontext() if allow_custom_calls
                  else group_norm.plain_when_traced()):
                program = torch.export.export(fused, (mel,))
        kernels = registered.recorded(program.graph_module)
        if kernels and not allow_custom_calls:
            raise ValueError(
                f"this Vocoder's artifact records the port's kernels {sorted(set(kernels))}: "
                "it needs advoc_tpu_torch.ops.kernels.registered at load time and runs only "
                "where those operators have an implementation. Pass allow_custom_calls=True "
                "to accept, or build the Vocoder with phase_impl='xla' (and no packed tail) "
                "for a plain-aten artifact"
            )
        name = _artifact_name(batch, t_frames)
        torch.export.save(program, out / name)
        entries.append({"batch": batch, "t_frames": t_frames, "file": name,
                        "platforms": [here]})
    manifest = {
        "format": 1,
        "sample_rate": p.sample_rate,
        "n_mels": p.n_mels,
        "hop_length": p.hop_length,
        "chunk_frames": voc.chunk,
        "phase_method": voc.phase_method,
        "gl_iters": voc.gl_iters,
        "artifacts": entries,
    }
    (out / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    return manifest


class ExportedVocoder:
    """Serve a directory written by :func:`export_vocoder`.

    The Vocoder's contract: (T, M) or (B, T, M) mels in (numpy or tensor),
    float32 waveforms (…, T·hop) out on ``device``, cropped to the true
    length; a call is padded up to the tightest exported T, then the
    tightest exported B. ``device`` defaults to "cuda" and raises without a
    card, as the port's other entry points. Needs torch, numpy and the
    port's registered kernels only: no model code runs at load or call time.
    """

    def __init__(self, path: str | pathlib.Path, device=None):
        from advoc_tpu_torch.ops.kernels import registered  # noqa: F401  (the advoc:: ops)

        self.path = pathlib.Path(path)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExportedVocoder runs on the card by default and no CUDA device is present; "
                "pass device='cpu' for an artifact exported on the CPU")
        m = json.loads((self.path / _MANIFEST).read_text())
        self.manifest = m
        self.sample_rate = m["sample_rate"]
        self.n_mels = m["n_mels"]
        self.hop_length = m["hop_length"]
        self._entries = sorted(m["artifacts"], key=lambda e: (e["t_frames"], e["batch"]))
        self._cache: dict[tuple[int, int], torch.nn.Module] = {}

    def shapes(self) -> list[tuple[int, int]]:
        return [(e["batch"], e["t_frames"]) for e in self._entries]

    def _pick(self, b: int, t: int) -> tuple[int, int]:
        fits = [(e["batch"], e["t_frames"]) for e in self._entries
                if e["batch"] >= b and e["t_frames"] >= t]
        if not fits:
            raise ValueError(
                f"no exported artifact fits batch={b}, t_frames={t}; available: {self.shapes()}"
            )
        # Least waste: the tightest T first (the work scales with T), then B.
        return min(fits, key=lambda bt: (bt[1], bt[0]))

    def _load(self, key: tuple[int, int]) -> torch.nn.Module:
        if key not in self._cache:
            entry = next(e for e in self._entries if (e["batch"], e["t_frames"]) == key)
            if self.device.type not in entry["platforms"]:
                raise RuntimeError(
                    f"artifact {entry['file']} was exported for {entry['platforms']}, "
                    f"this ExportedVocoder runs on {self.device.type!r}"
                )
            self._cache[key] = torch.export.load(self.path / entry["file"]).module()
        return self._cache[key]

    def __call__(self, mel) -> torch.Tensor:
        if not torch.is_tensor(mel):
            mel = torch.tensor(np.asarray(mel, np.float32))
        mel = mel.to(self.device, torch.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        b, t = mel.shape[0], mel.shape[1]
        eb, et = self._pick(b, t)
        if (eb, et) != (b, t):  # silence-level mel (0.0 is the dB floor), as the Vocoder pads
            mel = torch.nn.functional.pad(mel, (0, 0, 0, et - t, 0, eb - b))
        with torch.no_grad():
            wav = self._load((eb, et))(mel)[:b, : t * self.hop_length]
        return wav[0] if squeeze else wav
