"""The plain reference agrees with the port at a tiny size on the CPU: the
generator and the offline call."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import traffic
import weights
from reference import audio as ra, unet, vocoder as rv

A = ra.Audio()


def port_generator(**kw):
    from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator

    cfg = AdvocConfig(dtype="float32", width=8, **kw)
    g = AdvocGenerator(cfg)
    sd = weights.make({k: v.shape for k, v in g.state_dict().items()}, 3, "cpu")
    g.load_state_dict(sd)
    return g.eval(), sd, dataclasses.asdict(cfg)


@pytest.mark.parametrize("kw", [{}, {"fast_head": True, "n_frames": 64}])
def test_generator(kw):
    g, sd, m = port_generator(**kw)
    x = torch.rand(2, 64, 513)
    with torch.no_grad():
        a, b = g(x), unet.generator(x, sd, m)
    assert float((a - b).abs().max()) < 1e-5


def test_mel_and_estimate():
    from advoc_tpu_torch.ops import spectral

    wav = traffic.speech([8192], torch.Generator().manual_seed(0), "cpu", 22050)[0]
    mel = spectral.waveform_to_r9y9_melspec(wav)
    assert float((ra.wav_to_norm_mel(wav, A) - mel).abs().max()) < 1e-4
    mag = spectral.r9y9_melspec_to_magspec(mel)
    assert float((ra.pinv_estimate(mel, A) - mag).abs().max()) < 1e-4
    projected = spectral.mel_consistency_project(mag, mel)
    assert float((ra.project(mag, mel, A) - projected).abs().max()) < 1e-4


@pytest.mark.parametrize("frames", [256, 512])
def test_offline_call(frames):
    """The Vocoder's G-L kernel (its plain version here) at "highest" against
    the reference's G-L: the same function to rounding; the generator's
    output window by window."""
    from advoc_tpu_torch.infer import Vocoder

    g, sd, m = port_generator()
    calls = traffic.offline_calls({"kind": "fixed_batch", "pool": 1, "batch": 2,
                                   "frames": frames}, 1, "cpu", A)
    mel = calls[0]["mel"]
    kept = {}

    def keep(x):
        kept["g"] = g(x)
        return kept["g"]

    voc = Vocoder(g, gl_iters=4, phase_impl="kernel", gl_precision="highest", device="cpu")
    voc.generator = keep
    out = voc(mel)
    v = {"chunk_frames": 256, "overlap_frames": 32, "gl_iters": 4, "momentum": 0.99,
         "mel_projection": 1.0}
    rep, wav, _ = rv.vocode(torch.as_tensor(mel), sd, m, v, A)
    assert float((kept["g"] - rep).abs().max()) < 1e-3  # dB values in [0, 1]
    assert float((out - wav).abs().max()) < 2e-3 * float(wav.abs().max())
