#!/usr/bin/env python3
"""Where the fp32 (3xTF32) G-L kernels' time goes, on one CUDA card.

    python scripts/gl_fp32_ablation.py [--b 128] [--t 256]

Builds ``advoc_tpu_torch/csrc/griffin_lim.cu`` as it is and in three
ablated forms, made by replacing source lines (their results are wrong; they
are timed only):

* ``no_split``: the A fragments read from shared memory but not split
  (big = the f32 bits, small = other bits in as many registers): the
  split's ``cvt.rna`` work gone, the register pressure kept;
* ``products_only``: no A reads and no split (the fragment comes from
  registers): the three products, the TMA ring and the epilogues;
* ``one_pass``: ``products_only`` with one product a k8 step instead of
  three: the TMA ring and the epilogues with a third of the products.

Each is timed in turns (full, ablations, ablations reversed, full) on the
same magnitudes, 30 iterations at momentum 0.99, and its synthesis and
analysis launches are summed from a ``torch.profiler`` trace. Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from advoc_tpu_torch.data.synthetic import synthetic_speech  # noqa: E402
from advoc_tpu_torch.ops import spectral as sp  # noqa: E402
from advoc_tpu_torch.ops.kernels import _build  # noqa: E402
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl  # noqa: E402

READ = "const float v = *reinterpret_cast<const float*>(tile + r * 128 + chunk * 16 + t * 4);"
SPLIT = "tf32_split(v, big[kk][e], small[kk][e]);"
PRODUCTS = """      wgmma_tf32_128(d, as[kk], sw128_desc(b_big + kk * 32), !fresh || kk > 0);
      wgmma_tf32_128(d, ab[kk], sw128_desc(b_small + kk * 32));
      wgmma_tf32_128(d, ab[kk], sw128_desc(b_big + kk * 32));"""
NO_READ = "const float v = __int_as_float(r * 3 + chunk + t);"
NO_SPLIT = "big[kk][e] = __float_as_uint(v); small[kk][e] = big[kk][e] ^ 7u;"
ONE_PASS = "      wgmma_tf32_128(d, ab[kk], sw128_desc(b_big + kk * 32), !fresh || kk > 0);"
ABLATIONS = {
    "no_split": ((SPLIT, NO_SPLIT),),
    "products_only": ((READ, NO_READ), (SPLIT, NO_SPLIT)),
    "one_pass": ((READ, NO_READ), (SPLIT, NO_SPLIT), (PRODUCTS, ONE_PASS)),
}


def build(src: str, out_dir: pathlib.Path, name: str) -> dict:
    """Compile one form of the kernel source with the port's flags; bind it
    as the port's declaration of the fp32 library binds the real one."""
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    so = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True)
    return _build.bind(ctypes.CDLL(str(so)), **tgl._LIB.entries)


def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn) -> dict[str, float]:
    """Device ms of the synthesis and the analysis launches in one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"synth_ms": 0.0, "analysis_ms": 0.0}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and "gl_tf32_kernel" in ev.name:
            key = "synth_ms" if "<true>" in ev.name else "analysis_ms"
            out[key] += ev.device_time / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--t", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gl_fp32_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    source = (_build.CSRC / "griffin_lim.cu").read_text()
    with tempfile.TemporaryDirectory(prefix="gl_ablation_") as tmp:
        libs = {"full": build(source, pathlib.Path(tmp), "full")}
        for name, edits in ABLATIONS.items():
            src = source
            for old, new in edits:
                if src.count(old) != 1:
                    raise RuntimeError(f"{name}: the kernel source no longer has {old!r}")
                src = src.replace(old, new)
            libs[name] = build(src, pathlib.Path(tmp), name)

        b, t = args.b, args.t
        wav = torch.tensor(synthetic_speech(b + t, b * t * 256), device="cuda")
        mel = sp.waveform_to_r9y9_melspec(wav)[: b * t].reshape(b, t, 80)
        mag = sp.r9y9_melspec_to_magspec(mel)[..., :512].contiguous()
        call = lambda: tgl.griffin_lim_kernel(mag, 30, 0.99)  # noqa: E731
        real_fns = tgl._LIB._fns
        result: dict[str, dict[str, float]] = {name: {"ms": []} for name in libs}
        try:
            order = list(libs) + list(libs)[::-1]
            for name in order:
                tgl._LIB._fns = libs[name]
                result[name]["ms"].append(cuda_ms(call))
            for name in libs:
                tgl._LIB._fns = libs[name]
                result[name].update(launch_ms(call))
        finally:
            tgl._LIB._fns = real_fns
    print(json.dumps({"device": smi, "shape": [b, t, 512], "n_iters": 30, "forms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
