"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from advoc_tpu_torch.data.synthetic import synthetic_speech
from advoc_tpu_torch.infer import Vocoder
from advoc_tpu_torch.ops import spectral as sp
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl
from advoc_tpu_torch.ops.reference import AudioParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mel_mag(dev, b, t, n_bins):
    wav = torch.tensor(synthetic_speech(0, b * t * 256), device=dev)
    mel = sp.waveform_to_r9y9_melspec(wav)[: b * t].reshape(b, t, 80)
    return mel, sp.r9y9_melspec_to_magspec(mel)[..., :n_bins].contiguous()


@pytest.mark.parametrize("t,n_bins", [(64, 512), (64, 513), (300, 513)])
def test_griffin_lim_kernel_matches_plain(dev, t, n_bins):
    mel, mag = _mel_mag(dev, 2, t, n_bins)
    before = tgl.griffin_lim_kernel.launches
    y0 = tgl.griffin_lim_kernel(mag, 0, 0.0)
    y1 = tgl.griffin_lim_kernel(mag, 1, 0.0)
    torch.cuda.synchronize()
    assert tgl.griffin_lim_kernel.launches == before + 1 + 3
    # Synthesis alone is a linear fp32 map: 1e-5 × peak. One iteration
    # divides by the rebuilt |u|, ill-conditioned where it is tiny: 1e-3 × peak
    # (chip_smoke.py states the measured margins).
    for n_iters, y, rtol in ((0, y0, 1e-5), (1, y1, 1e-3)):
        want = tgl.griffin_lim_plain(mag, n_iters, 0.0)
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * float(want.abs().max()))
    l1 = [float((sp.waveform_to_r9y9_melspec(f(mag, 30, 0.99))[:, :t] - mel).abs().mean())
          for f in (tgl.griffin_lim_kernel, tgl.griffin_lim_plain)]
    assert abs(l1[0] - l1[1]) < 2e-3, l1


def test_griffin_lim_kernel_init_phase(dev):
    mel, mag = _mel_mag(dev, 2, 64, 512)
    phi = torch.tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape),
                       dtype=torch.float32, device=dev)
    init = (torch.cos(phi), torch.sin(phi))
    y = tgl.griffin_lim_kernel(mag, 2, 0.99, init_phase=init)
    want = tgl.griffin_lim_plain(mag, 2, 0.99, init_phase=init)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-3 * float(want.abs().max()))


@pytest.mark.parametrize("hop,n_bins", [(512, 1024), (512, 1025), (250, 501)])
def test_griffin_lim_kernel_other_hops(dev, hop, n_bins):
    """Any n_fft = 4 · hop: float4 loads where hop % 4 == 0, masked scalar
    loads otherwise."""
    q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    wav = torch.tensor(synthetic_speech(hop, 2 * 64 * hop), device=dev).reshape(2, -1)
    mag = sp.waveform_to_magspec(wav, q)[:, :64, :n_bins].contiguous()
    for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (2, 0.99, 1e-3)):
        y = tgl.griffin_lim_kernel(mag, n_iters, momentum, params=q)
        want = tgl.griffin_lim_plain(mag, n_iters, momentum, params=q)
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * float(want.abs().max()))


def test_vocoder_takes_the_kernel_at_every_length_and_hop(dev):
    """Lengths that are not a multiple of 256 frames, and another hop."""
    for q, t in ((AudioParams(), 320), (AudioParams(n_fft=2048, hop_length=512,
                                                    win_length=2048), 100)):
        wav = torch.tensor(synthetic_speech(1, t * q.hop_length), device=dev)
        mel = sp.waveform_to_r9y9_melspec(wav, q)[:t]
        before = tgl.griffin_lim_kernel.launches
        out = Vocoder(params=q, chunk_frames=64, gl_iters=4, device="cuda")(mel)
        assert tgl.griffin_lim_kernel.launches == before + 2 * 4 + 1
        assert out.shape == (t * q.hop_length,) and bool(torch.isfinite(out).all())


def test_griffin_lim_kernel_rejects_what_it_cannot_take(dev):
    _, mag = _mel_mag(dev, 1, 64, 512)
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag.double(), 1, 0.99)
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag[:, ::2], 1, 0.99)
