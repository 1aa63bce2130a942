#!/usr/bin/env python
"""Client for the streaming vocoder server, on the PyTorch port: stream a
file, write a WAV.

The port's copy of ``scripts/vocode_client.py``, with the same flags and
result line. Featurizes an input WAV (or a synthetic fixture utterance) to
mels on ``--device``, pushes them chunk by chunk over TCP to a running
``python -m advoc_tpu_torch.serve`` (through
``advoc_tpu_torch.serve.client``; either package's server speaks the same
protocol), drops the stream-start pre-roll and look-ahead per the server's
CONFIG contract, and writes the vocoded waveform. Prints ONE
machine-readable JSON line (``VOCODE_CLIENT_RESULT {...}``) with latency
and (optional) fidelity. Featurizes on the card; ``--device cpu`` on the
CPU.

    python scripts/vocode_client_torch.py --port 9700 --input in.wav --output out.wav
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    """Returns the result line's dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--input", default=None,
                   help="input wav; default = synthetic fixture utterance")
    p.add_argument("--output", default=None, help="output wav path")
    p.add_argument("--seconds", type=float, default=4.0,
                   help="synthetic-input duration when --input is omitted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fidelity", action="store_true",
                   help="report re-extracted mel L1 vs the input mels")
    p.add_argument("--device", default="cuda",
                   help="device of the featurizer (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.serve.client import VocodeClient
    from advoc_tpu_torch.train.harness import train_device

    dev = train_device(args.device)

    def melspec(wav) -> np.ndarray:
        x = torch.tensor(np.asarray(wav, np.float32), device=dev)
        return spectral.waveform_to_r9y9_melspec(x, P).cpu().numpy()

    if args.input:
        wav = audioio.decode_audio(args.input, P.sample_rate)
    else:
        wav = synthetic_speech(args.seed, int(args.seconds * P.sample_rate))
    mel = melspec(wav)

    with VocodeClient(args.host, args.port) as c:
        cfg = c.config
        ch = cfg["chunk_frames"]
        n_chunks = -(-mel.shape[0] // ch)  # pad the tail chunk with silence
        mel_pad = np.zeros((n_chunks * ch, cfg["n_mels"]), np.float32)
        mel_pad[: mel.shape[0]] = mel
        lat_ms, pcm = [], []
        for k in range(n_chunks):
            t0 = time.perf_counter()
            pcm.append(c.vocode(mel_pad[k * ch : (k + 1) * ch]))
            lat_ms.append((time.perf_counter() - t0) * 1000.0)
        # End-of-utterance drain: the engine's pending look-ahead/overlap
        # tail, lost otherwise whenever the tail-chunk pad is shorter than
        # the engine's latency.
        pcm.append(c.flush())

    out = np.concatenate(pcm).astype(np.float32)
    if cfg["emit_dtype"] == "int16":
        out = out / 32767.0
    # Stream-start latency contract: drop the one-time pre-roll plus the
    # engine's look-ahead delay, then trim to the input length.
    out = out[cfg["preroll_samples"] + cfg["latency_frames"] * cfg["hop_length"]:]
    out = out[: mel.shape[0] * cfg["hop_length"]]
    if args.output:
        audioio.save_as_wav(out, args.output, cfg["sample_rate"])

    lat = np.asarray(lat_ms[1:]) if len(lat_ms) > 1 else np.asarray(lat_ms)
    result = {
        "chunks": n_chunks,
        "engine": cfg["phase_engine"],
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "seconds_out": round(len(out) / cfg["sample_rate"], 2),
        "output": args.output,
    }
    if args.fidelity:
        m2 = melspec(out)
        n_fr = min(m2.shape[0], mel.shape[0])
        result["mel_l1"] = round(float(np.abs(m2[:n_fr] - mel[:n_fr]).mean()), 5)
    print("VOCODE_CLIENT_RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
