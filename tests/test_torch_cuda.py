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
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
from advoc_tpu_torch.models.advoc.model import small_config
from advoc_tpu_torch.ops import spectral as sp
from advoc_tpu_torch.ops.kernels import featurizer as tfeat
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl
from advoc_tpu_torch.ops.kernels import group_norm as tgn
from advoc_tpu_torch.ops.kernels import packed_up as tpu
from advoc_tpu_torch.ops.reference import AudioParams
from advoc_tpu_torch.utils.roofline import group_norm_levels

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
    """Any n_fft = 4 · hop: F and hop padded to multiples of 64."""
    q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    wav = torch.tensor(synthetic_speech(hop, 2 * 64 * hop), device=dev).reshape(2, -1)
    mag = sp.waveform_to_magspec(wav, q)[:, :64, :n_bins].contiguous()
    for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (2, 0.99, 1e-3)):
        y = tgl.griffin_lim_kernel(mag, n_iters, momentum, params=q)
        want = tgl.griffin_lim_plain(mag, n_iters, momentum, params=q)
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("b,t,n_bins,hop", [(3, 50, 513, 256), (1, 20, 501, 250),
                                             (2, 30, 101, 50)])
def test_griffin_lim_fp32_kernel_partial_tiles(dev, b, t, n_bins, hop):
    """The 3xTF32 kernels where B(T+3) rows end inside a 128-row tile (159,
    23, 66 rows), at ragged F (513, 501, 101 padded to 576, 512, 128) and a
    hop_pad of 64 (half a 128-column tile), against the plain version:
    synthesis within 1e-5 × peak, one and two (momentum 0.99) iterations
    within 1e-3 × peak; 2·n_iters + 1 launches."""
    q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    wav = torch.tensor(synthetic_speech(hop, b * t * hop + 4 * hop), device=dev)
    mag = sp.waveform_to_magspec(wav, q)[: b * t, :n_bins].reshape(b, t, n_bins).contiguous()
    for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (1, 0.0, 1e-3), (2, 0.99, 1e-3)):
        before = tgl.griffin_lim_kernel.launches
        y = tgl.griffin_lim_kernel(mag, n_iters, momentum, params=q)
        torch.cuda.synchronize()
        assert tgl.griffin_lim_kernel.launches == before + 2 * n_iters + 1
        want = tgl.griffin_lim_plain(mag, n_iters, momentum, params=q)
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("t,n_bins,hop,with_init", [
    (64, 512, 256, False), (64, 513, 256, False), (300, 513, 256, False),
    (64, 512, 256, True), (64, 1024, 512, False), (64, 501, 250, False),
])
def test_griffin_lim_tc_kernel_matches_plain(dev, t, n_bins, hop, with_init):
    """The tensor-core kernel against the split plain version. Synthesis
    alone rounds the same operands: 1e-5 × peak. After one and two
    iterations the two have summed in other orders, and where y lies on a
    bf16 rounding boundary they round it to neighbouring bf16 values, which
    the projection amplifies where the rebuilt |u| is near zero: isolated
    samples up to 2e-2 (one) and 5e-2 (two, momentum on) × peak, 3e-4 ×
    peak on average (chip_smoke.py states the measured margins)."""
    q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    wav = torch.tensor(synthetic_speech(hop, 2 * t * hop), device=dev).reshape(2, -1)
    mag = sp.waveform_to_magspec(wav, q)[:, :t, :n_bins].contiguous()
    init = None
    if with_init:
        phi = torch.tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape),
                           dtype=torch.float32, device=dev)
        init = (torch.cos(phi), torch.sin(phi))
    split_final = t <= 256 and init is None
    for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (1, 0.0, 2e-2), (2, 0.99, 5e-2)):
        before = (tgl.griffin_lim_kernel.tc_launches, tgl.griffin_lim_kernel.launches)
        y = tgl.griffin_lim_kernel(mag, n_iters, momentum, init, q, precision="default")
        torch.cuda.synchronize()
        assert tgl.griffin_lim_kernel.tc_launches == before[0] + 2 * n_iters + split_final
        assert tgl.griffin_lim_kernel.launches == before[1] + (not split_final)
        want = tgl.griffin_lim_plain(mag, n_iters, momentum, init, q, precision="default")
        peak = float(want.abs().max())
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * peak)
        assert float((y - want).abs().mean()) <= 3e-4 * peak


@pytest.mark.parametrize("mode", ["split", "split_anal", "bfloat16"])
@pytest.mark.parametrize("t,n_bins,hop,with_init", [
    (64, 512, 256, False), (300, 513, 256, False), (64, 512, 256, True), (64, 501, 250, False),
])
def test_griffin_lim_tc_kernel_loop_modes(dev, mode, t, n_bins, hop, with_init):
    """The other bf16 loop modes against their plain versions, at the split
    mode's bounds (the same operands rounded to bf16, other sum orders):
    split and plain synthesis, split and plain analysis, B1's and B2's tails."""
    q = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    wav = torch.tensor(synthetic_speech(hop, 2 * t * hop), device=dev).reshape(2, -1)
    mag = sp.waveform_to_magspec(wav, q)[:, :t, :n_bins].contiguous()
    init = None
    if with_init:
        phi = torch.tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape),
                           dtype=torch.float32, device=dev)
        init = (torch.cos(phi), torch.sin(phi))
    loop_final = t <= 256 and init is None
    for n_iters, momentum, rtol in ((0, 0.0, 1e-5), (1, 0.0, 2e-2), (2, 0.99, 5e-2)):
        before = (tgl.griffin_lim_kernel.tc_launches, tgl.griffin_lim_kernel.launches)
        y = tgl.griffin_lim_kernel(mag, n_iters, momentum, init, q, loop_dtype=mode)
        torch.cuda.synchronize()
        assert tgl.griffin_lim_kernel.tc_launches == before[0] + 2 * n_iters + loop_final
        assert tgl.griffin_lim_kernel.launches == before[1] + (not loop_final)
        want = tgl.griffin_lim_plain(mag, n_iters, momentum, init, q, loop_dtype=mode)
        peak = float(want.abs().max())
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * peak)
        assert float((y - want).abs().mean()) <= 3e-4 * peak


def test_griffin_lim_tc_kernel_rejects_what_it_cannot_take(dev):
    _, mag = _mel_mag(dev, 1, 64, 512)
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag.double(), 1, 0.99, precision="default")
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag[:, ::2], 1, 0.99, precision="default")


def test_vocoder_takes_the_kernel_at_every_length_and_hop(dev):
    """Lengths that are not a multiple of 256 frames, and another hop. The
    default Vocoder takes the tensor-core kernel and no fp32 loop kernel:
    past 256 frames its one fp32 launch is the final synthesis (B2's f32
    tail). gl_precision="highest" takes the fp32 kernels alone."""
    for q, t in ((AudioParams(), 320), (AudioParams(n_fft=2048, hop_length=512,
                                                    win_length=2048), 100)):
        wav = torch.tensor(synthetic_speech(1, t * q.hop_length), device=dev)
        mel = sp.waveform_to_r9y9_melspec(wav, q)[:t]
        tb = -(-t // 64) * 64  # the Vocoder's bucket
        for gl_precision, tc, fp32 in ((None, 2 * 4 + (tb <= 256), int(tb > 256)),
                                       ("highest", 0, 2 * 4 + 1)):
            before = (tgl.griffin_lim_kernel.tc_launches, tgl.griffin_lim_kernel.launches)
            out = Vocoder(params=q, chunk_frames=64, gl_iters=4, device="cuda",
                          gl_precision=gl_precision)(mel)
            assert tgl.griffin_lim_kernel.tc_launches == before[0] + tc
            assert tgl.griffin_lim_kernel.launches == before[1] + fp32
            assert out.shape == (t * q.hop_length,) and bool(torch.isfinite(out).all())


def test_griffin_lim_kernel_rejects_what_it_cannot_take(dev):
    _, mag = _mel_mag(dev, 1, 64, 512)
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag.double(), 1, 0.99)
    with pytest.raises(ValueError, match="contiguous float32"):
        tgl.griffin_lim_kernel(mag[:, ::2], 1, 0.99)


# The kernel against its plain version: 3xTF32 products against fp32
# matmuls. H100 runs measured 2.8e-5 to 4.2e-5 in normalized units; 2e-4
# holds that with a margin and fails a form with one bf16 hi/lo split, which
# misses by 1e-3 on a quiet stretch (test_torch_featurizer.py's emulation).
FEAT_ATOL = 2e-4


@pytest.mark.parametrize("shape", [(2, 300 * 256 + 77), (1, 64 * 256), (3, 1, 5 * 256 + 3),
                                   (1, 1024 * 256), (132, 200 * 256 + 77)])
def test_featurizer_kernel_matches_plain(dev, shape):
    """Ragged tiles, L not a multiple of hop, extra lead dims, one long
    utterance (64-frame tiles), and 132 rows (128-frame tiles, which fill
    the card once). Within FEAT_ATOL of the plain version; 3e-3 against
    the STFT path (tests/test_pallas.py)."""
    n = int(np.prod(shape))
    wav = torch.tensor(synthetic_speech(1, n), device=dev).reshape(shape)
    before = tfeat.fused_melspec_kernel.launches
    got = sp.waveform_to_r9y9_melspec(wav, impl="kernel")
    torch.cuda.synchronize()
    assert tfeat.fused_melspec_kernel.launches == before + 1
    assert got.shape == shape[:-1] + (shape[-1] // 256, 80)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(wav), rtol=0, atol=FEAT_ATOL)
    xla = sp.waveform_to_r9y9_melspec(wav)[..., : got.shape[-2], :]
    torch.testing.assert_close(got, xla, rtol=0, atol=3e-3)


def test_featurizer_kernel_quiet_row(dev):
    """A row with a stretch at 1e-3 amplitude: the quiet bins where reduced
    precision fails (bf16 with one hi/lo split misses the 1e-3 bound there)."""
    wav = torch.tensor(synthetic_speech(2, 2 * 200 * 256), device=dev).reshape(2, -1)
    wav[1, 20 * 256 : 180 * 256] *= 1e-3
    got = tfeat.fused_melspec_kernel(wav)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(wav), rtol=0, atol=FEAT_ATOL)
    xla = sp.waveform_to_r9y9_melspec(wav)[..., : got.shape[-2], :]
    torch.testing.assert_close(got, xla, rtol=0, atol=3e-3)


@pytest.mark.parametrize("kw", [dict(hop_length=200), dict(hop_length=250),
                                dict(hop_length=512, sample_rate=44100),
                                dict(hop_length=600, sample_rate=48000)],
                         ids=lambda kw: f"hop{kw['hop_length']}")
def test_featurizer_kernel_other_hops(dev, kw):
    """Hops the kernel pads to its 16-sample K slice (200 → 208, 250 → 256,
    600 → 608), the 44.1 kHz n_fft 2048 (64-frame tiles) and 48 kHz at hop
    600 (a two-stage ring), with a quiet stretch; within FEAT_ATOL of the
    plain version."""
    hop = kw["hop_length"]
    params = AudioParams(n_fft=4 * hop, win_length=4 * hop, **kw)
    wav = torch.tensor(synthetic_speech(hop, 2 * (300 * hop + 77)), device=dev).reshape(2, -1)
    wav[1, 20 * hop : 200 * hop] *= 1e-3
    got = tfeat.fused_melspec_kernel(wav, params)
    assert got.shape == (2, 300, 80)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(wav, params), rtol=0,
                               atol=FEAT_ATOL)


def test_featurizer_kernel_rejects_what_it_cannot_take(dev):
    wav = torch.zeros((1, 64 * 1024), device=dev)
    # hop 1024: the 64-frame audio window alone would fill shared memory.
    with pytest.raises(RuntimeError, match="fused_melspec failed"):
        tfeat.fused_melspec_kernel(wav, AudioParams(sample_rate=88200, n_fft=4096,
                                                    hop_length=1024, win_length=4096))
    with pytest.raises(ValueError, match="float32"):
        tfeat.fused_melspec_kernel(wav.double())


@pytest.mark.parametrize("b,h,w,cin,f,tm", [
    (2, 32, 16, 16, 8, 8), (1, 64, 72, 24, 72, 16), (2, 32, 64, 128, 64, 16),
    # cin 184 padded to 192, the widest with two x stages per warpgroup
    # (its weights fill 96 KB of shared memory); cin 200 padded to 256, the
    # widest the kernel takes, with one; a ragged 64-channel tile at f = 40.
    (1, 32, 40, 184, 40, 8), (1, 32, 40, 200, 40, 8), (2, 8, 136, 256, 64, 4),
    # W not a multiple of 64 at the real width; cin 24, where the TMA box
    # overhangs the channels; H = 2, one row per chunk (tm 1), so the second
    # warpgroup has no row.
    (2, 16, 72, 192, 64, 8), (2, 8, 72, 24, 40, 4), (2, 2, 80, 64, 64, 1),
])
def test_packed_up_kernel_matches_plain(dev, b, h, w, cin, f, tm):
    """y within 1e-2 × peak (about two bf16 ulps: the two sum in other
    orders before rounding); Σy, Σy² within 1e-3 relative of f32 sums of
    the kernel's own output."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((b, h, w, cin)), dtype=torch.bfloat16, device=dev)
    wt = torch.tensor(0.1 * rng.standard_normal((4, 4, cin, f)), dtype=torch.float32, device=dev)
    bias = torch.tensor(0.1 * rng.standard_normal(f), dtype=torch.float32, device=dev)
    before = tpu.packed_up_kernel.launches
    y, s1, s2 = tpu.packed_up_kernel(x, wt, bias, f=f, tm=tm, with_stats=True)
    y_only = tpu.packed_up_kernel(x, wt, bias, f=f, tm=tm)
    torch.cuda.synchronize()
    assert tpu.packed_up_kernel.launches == before + 2
    want = tpu.packed_up_plain(x, wt, bias, f=f, tm=tm)
    assert y.shape == want.shape == (b, 2 * h, w, 2 * f) and y.dtype == torch.bfloat16
    peak = float(want.float().abs().max())
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=1e-2 * peak)
    torch.testing.assert_close(y_only, y, rtol=0, atol=0)
    yf = y.float()
    torch.testing.assert_close(s1, yf.sum(dim=(1, 2)), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s2, (yf * yf).sum(dim=(1, 2)), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_frames", [64, 16])
def test_packed_tail_generator_takes_b4(dev, n_frames):
    """n_frames 16 gives H // 2 = 4 at the finest level, below the TPU's
    8-row tile: B4 still runs, at tm 4."""
    cfg = AdvocConfig(n_frames=n_frames, width=8, depth=4)
    g = AdvocGenerator(cfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    gp = AdvocGenerator(AdvocConfig(n_frames=n_frames, width=8, depth=4, packed_tail=True))
    gp.load_state_dict(g.state_dict())
    g, gp = g.to(dev), gp.to(dev)
    x = torch.tensor(np.random.default_rng(1).uniform(0, 1, (2, n_frames, 513)),
                     dtype=torch.float32, device=dev)
    before = tpu.packed_up_kernel.launches
    with torch.no_grad():
        got, want = gp(x), g(x)
    assert tpu.packed_up_kernel.launches == before + 1
    # tests/test_models.py's bf16 bound between the packed and default tails.
    torch.testing.assert_close(got, want, rtol=0, atol=4e-2)
    assert float((got - want).abs().mean()) < 5e-3


def test_packed_tail_refuses_gradients_on_the_card(dev):
    """B4 has no backward: under grad the packed tail raises on the card
    (it would silently cut the gradient), and so does building a train step
    with it; under no_grad it runs."""
    from advoc_tpu_torch.models.advoc import PatchDiscriminator
    from advoc_tpu_torch.train import gan

    cfg = AdvocConfig(n_frames=64, width=8, depth=4, packed_tail=True)
    g = AdvocGenerator(cfg).to(dev)
    x = torch.rand((1, 64, 513), device=dev)
    with pytest.raises(NotImplementedError, match="backward"):
        g(x)
    with pytest.raises(NotImplementedError, match="packed_tail"):
        gan.make_advoc_train_step(g, PatchDiscriminator(cfg).to(dev), cfg)
    with torch.no_grad():
        assert g(x).shape == x.shape


def test_train_step_on_the_card(dev):
    """One bf16 train step at a small width: finite metrics on the device,
    every tensor updated. The D update's frozen generator (under no_grad)
    takes the GroupNorm kernel, two launches at each of its 7 levels; the
    G update, under autograd, the plain GroupNorm; no other port kernel."""
    from advoc_tpu_torch.models.advoc import PatchDiscriminator
    from advoc_tpu_torch.train import gan

    cfg = AdvocConfig(n_frames=64, width=8, depth=4, disc_width=8)
    g, d = AdvocGenerator(cfg).to(dev), PatchDiscriminator(cfg).to(dev)
    gs, ds = gan.make_states(g, d, seed=0)
    before = {n: p.detach().clone() for n, p in g.named_parameters()}
    launches = (tgl.griffin_lim_kernel.tc_launches, tpu.packed_up_kernel.launches,
                tgn.group_norm_act_kernel.launches)
    wav = torch.tensor(np.stack([synthetic_speech(i, 64 * 256) for i in range(2)]), device=dev)
    _, _, m = gan.make_advoc_train_step(g, d, cfg)(gs, ds, wav)
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in m.values())
    assert all(not torch.equal(p, before[n]) for n, p in g.named_parameters())
    assert (tgl.griffin_lim_kernel.tc_launches, tpu.packed_up_kernel.launches,
            tgn.group_norm_act_kernel.launches) == (*launches[:2], launches[2] + 2 * 7)


def test_kernels_without_a_backward_refuse_gradients(dev):
    """B3 and the fast-G-L kernels have no backward: under grad, on an input
    that requires it, both wrappers raise on the card (the gradient would
    stop silently); under no_grad, or on an input without it, they run."""
    wav = torch.tensor(synthetic_speech(0, 64 * 256), device=dev)[None].requires_grad_(True)
    mag = torch.rand((1, 16, 513), device=dev, requires_grad=True)
    for fn in (lambda: tfeat.fused_melspec_kernel(wav), lambda: tgl.griffin_lim_kernel(mag, 2),
               lambda: tgl.griffin_lim_kernel(mag, 2, precision="default")):
        with pytest.raises(NotImplementedError, match="no backward"):
            fn()
        with torch.no_grad():
            assert bool(torch.isfinite(fn()).all())
    assert tfeat.fused_melspec_kernel(wav.detach()).shape == (1, 64, 80)


@pytest.mark.parametrize("family", ["wavegan", "cond_wavegan", "melspecgan"])
def test_family_steps_on_the_card(dev, family):
    """One bf16 step of each family at a small width (wgan-gp: cuDNN's
    double backward in bf16): finite metrics on the device, every G tensor
    updated, no port kernel launched (the conditional step featurizes and
    differentiates the STFT path)."""
    from advoc_tpu_torch.models import melspecgan, wavegan
    from advoc_tpu_torch.train import gan

    if family == "melspecgan":
        cfg = melspecgan.MelSpecGANConfig(latent_dim=16, width=16, n_critic=2)
        g, d = melspecgan.MelSpecGANGenerator(cfg), melspecgan.MelSpecGANDiscriminator(cfg)
        make, shape = gan.make_melspecgan_train_step, (2, 2, 64 * 256)
    elif family == "wavegan":
        cfg = wavegan.WaveGANConfig(slice_len=1024, latent_dim=32, width=16, n_critic=2)
        g, d = wavegan.WaveGANGenerator(cfg), wavegan.WaveGANDiscriminator(cfg)
        make, shape = gan.make_wavegan_train_step, (2, 2, 1024)
    else:
        cfg = wavegan.CondWaveGANConfig(n_frames=16, width=8, gan_type="wgan-gp")
        g, d = wavegan.CondWaveGANGenerator(cfg), wavegan.CondWaveGANDiscriminator(cfg)
        make, shape = gan.make_cond_wavegan_train_step, (2, 16 * 256)
    g, d = g.to(dev), d.to(dev)
    gs, ds = gan.make_states(g, d, seed=0)
    before = {n: p.detach().clone() for n, p in g.named_parameters()}
    launches = (tgl.griffin_lim_kernel.tc_launches, tfeat.fused_melspec_kernel.launches)
    wav = torch.tensor(synthetic_speech(1, int(np.prod(shape))), device=dev).reshape(shape)
    _, _, m = make(g, d, cfg)(gs, ds, wav, torch.Generator(device=dev).manual_seed(0))
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in m.values())
    assert all(not torch.equal(p, before[n]) for n, p in g.named_parameters())
    assert (tgl.griffin_lim_kernel.tc_launches, tfeat.fused_melspec_kernel.launches) == launches


def test_packed_up_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros((1, 16, 8, 12), dtype=torch.bfloat16, device=dev)
    wt, bias = torch.zeros((4, 4, 12, 8), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="cin % 8"):
        tpu.packed_up_kernel(x, wt, bias, f=8, tm=8)
    with pytest.raises(ValueError, match="bfloat16"):
        tpu.packed_up_kernel(x.float(), wt, bias, f=8, tm=8)
    # A cin above 256, whose weights would not fit in a CTA's shared memory
    # beside the rings: the library's own error.
    x = torch.zeros((1, 16, 8, 512), dtype=torch.bfloat16, device=dev)
    wt = torch.zeros((4, 4, 512, 8), device=dev)
    with pytest.raises(RuntimeError, match="packed_up failed"):
        tpu.packed_up_kernel(x, wt, bias, f=8, tm=8)


# -- GroupNorm + activation on the card -------------------------------------------


def _ulp_excess(got: torch.Tensor, want: torch.Tensor, act: str) -> float:
    """The largest of |got − want| − (k·ulp(want) + 1e-5) over two bf16
    tensors, k = 1, or 2 on LeakyReLU's negative side; ≤ 0 where every
    element is within its bound."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
    k = torch.where(w < 0, 2.0 if act == "leaky_relu" else 1.0, 1.0)
    return float(((got.float() - w).abs() - (k * ulp + 1e-5)).max())


def _gn_launch(x, weight, bias, act):
    """The kernel at 8 groups: (y, its (mean, inv) statistics (B, 8, 2))."""
    y, scratch = tgn._launch(x, weight, bias, 8, act)
    return y, scratch[: 2 * x.shape[0] * 8].view(x.shape[0], 8, 2)


def _gn_inputs(dev, shape, seed, nchw=False):
    """bf16 x with a mean and a scale of its own in each channel, in the
    convolutions' channels-last layout (or contiguous NCHW); f32 weight and
    bias around 1 and 0."""
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * (0.5 + torch.rand(
        (1, c, 1, 1), generator=g, device=dev)) + torch.randn((1, c, 1, 1), generator=g,
                                                               device=dev)).to(torch.bfloat16)
    x = x.contiguous() if nchw else x.contiguous(memory_format=torch.channels_last)
    weight = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
    return x, weight, 0.1 * torch.randn(c, generator=g, device=dev)


_GN_LEVELS = [(name, shape) for cfg in (AdvocConfig(), small_config())
              for name, _, shape in group_norm_levels(cfg, 2)]


@pytest.mark.parametrize("name,shape", _GN_LEVELS,
                         ids=[f"{'full' if i < 11 else 'small'}-{n}"
                              for i, (n, _) in enumerate(_GN_LEVELS)])
def test_group_norm_act_kernel_matches_plain(dev, name, shape):
    """Every normalised level of AdvocConfig() and small_config() at B = 2,
    channels-last and NCHW, LeakyReLU and ReLU: the kernel's statistics
    within 1e-5 relative of the plain ones; its output bit-equal to the
    plain formula applied with its own statistics (the same ops, each
    rounded); x's layout kept. Against the plain version end to end the two
    differ only by the order of the sums: within one bf16 ulp (two on
    LeakyReLU's negative side: a one-ulp difference before the activation,
    times 0.2 and rounded again) and 1e-5, which covers values near 0,
    where the statistics' last bits (≈ 1e-7 of the mean) are many ulps."""
    for nchw in (False, True):
        x, weight, bias = _gn_inputs(dev, shape, seed=sum(shape), nchw=nchw)
        mean, inv = tgn.group_norm_stats_plain(x, 8)
        for act in tgn.ACTS:
            before = tgn.group_norm_act_kernel.launches
            y, stats = _gn_launch(x, weight, bias, act)
            torch.cuda.synchronize()
            assert tgn.group_norm_act_kernel.launches == before + 2
            assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.stride() == x.stride()
            torch.testing.assert_close(stats[..., 0], mean, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(stats[..., 1], inv, rtol=1e-5, atol=0)
            same = tgn.group_norm_apply_plain(x, stats[..., 0], stats[..., 1], weight, bias, act)
            assert torch.equal(y, same), f"{name} nchw={nchw} {act}"
            excess = _ulp_excess(y, tgn.group_norm_act_plain(x, weight, bias, 8, act), act)
            assert excess <= 0, (name, nchw, act, excess)
            torch.testing.assert_close(tgn.group_norm_act_kernel(x, weight, bias, 8, act), y,
                                       rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_group_norm_act_kernel_in_every_compute_dtype(dev, dtype):
    """The generator's other compute dtypes take the same kernel: at the
    full width's largest level and the small width's (3 channels a group),
    both layouts and both activations, the statistics within 1e-5 relative
    of the plain ones, the output in x's dtype and layout and bit-equal to
    the plain formula applied with the kernel's own statistics."""
    for shape in ((2, 64, 256, 256), (2, 24, 128, 128)):
        for nchw in (False, True):
            x, weight, bias = _gn_inputs(dev, shape, seed=sum(shape), nchw=nchw)
            x = x.to(dtype)
            mean, inv = tgn.group_norm_stats_plain(x, 8)
            for act in tgn.ACTS:
                y, stats = _gn_launch(x, weight, bias, act)
                assert y.dtype == dtype and y.stride() == x.stride()
                torch.testing.assert_close(stats[..., 0], mean, rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(stats[..., 1], inv, rtol=1e-5, atol=0)
                same = tgn.group_norm_apply_plain(x, stats[..., 0], stats[..., 1], weight, bias,
                                                  act)
                assert torch.equal(y, same), (shape, nchw, act)


def test_float32_generator_takes_the_group_norm_kernel(dev):
    """A float32 generator on the card (the data-parallel check's "tiny"
    config) without autograd launches the kernel pair at each of its 7
    levels and stays within f32 rounding of the same generator under
    autograd, which takes the plain GroupNorm. TF32 convolutions off: a
    statistic's last bit may flip an input's TF32 rounding (2^-11), which
    the convolutions carry to the output (1.7e-3 seen)."""
    g = AdvocGenerator(AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32")).to(dev)
    g.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand((2, 64, 513), device=dev)
    before = tgn.group_norm_act_kernel.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with torch.inference_mode():
            got = g(x)
        torch.cuda.synchronize()
        assert tgn.group_norm_act_kernel.launches == before + 2 * 7
        assert got.dtype == torch.float32
        want = g(x)
    assert tgn.group_norm_act_kernel.launches == before + 2 * 7 and want.requires_grad
    torch.testing.assert_close(got, want.detach(), rtol=1e-4, atol=1e-4)


def test_group_norm_act_kernel_constant_group(dev):
    """A group whose values are all one number: var 0 (E[x²] − E[x]² exact
    here, clamped at 0 as any negative rounding would be), inv =
    rsqrt(1e-6), so the group's output is act(bf16(bias)) exactly, as the
    plain version's."""
    for nchw in (False, True):
        x, weight, bias = _gn_inputs(dev, (2, 64, 16, 32), seed=5, nchw=nchw)
        x[:, 8:16] = 1.5
        y, stats = _gn_launch(x, weight, bias, "relu")
        assert float(stats[0, 1, 0]) == 1.5 and abs(float(stats[1, 1, 1]) - 1e3) <= 1e-3
        want = torch.relu(bias[8:16].to(torch.bfloat16))[None, :, None, None].expand(2, 8, 16, 32)
        assert torch.equal(y[:, 8:16], want)
        assert torch.equal(tgn.group_norm_act_plain(x, weight, bias, 8, "relu")[:, 8:16], want)


def test_generator_takes_the_group_norm_kernel(dev):
    """The full-width generator without autograd launches the kernel pair at
    each of its 11 normalised levels, and stays within the bf16 bound that
    holds the packed tail to the default one (tests/test_models.py's) of the
    same generator under autograd, which takes the plain GroupNorm."""
    g = AdvocGenerator(AdvocConfig()).to(dev)
    g.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand((2, 256, 513), device=dev)
    before = tgn.group_norm_act_kernel.launches
    with torch.inference_mode():
        got = g(x)
    torch.cuda.synchronize()
    assert tgn.group_norm_act_kernel.launches == before + 2 * 11
    want = g(x)  # grad on, parameters require it: the plain path
    assert tgn.group_norm_act_kernel.launches == before + 2 * 11 and want.requires_grad
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=4e-2)
    assert float((got - want.detach()).abs().mean()) < 5e-3


def test_group_norm_act_kernel_rejects_what_it_cannot_take(dev):
    x, weight, bias = _gn_inputs(dev, (2, 64, 8, 8), seed=0)
    with pytest.raises(ValueError, match="C % 8"):
        tgn.group_norm_act_kernel(x[:, :60], weight[:60], bias[:60], 4, "relu")
    with pytest.raises(ValueError, match="C % 8"):
        tgn.group_norm_act_kernel(x, weight, bias, 7, "relu")
    with pytest.raises(ValueError, match="float16 or float32"):
        tgn.group_norm_act_kernel(x.double(), weight, bias, 8, "relu")
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        tgn.group_norm_act_kernel(x.transpose(2, 3), weight, bias, 8, "relu")
    with pytest.raises(ValueError, match="act"):
        tgn.group_norm_act_kernel(x, weight, bias, 8, "gelu")
    with pytest.raises(NotImplementedError, match="no backward"):
        tgn.group_norm_act_kernel(x, weight.requires_grad_(True), bias, 8, "relu")


# -- The streaming engine on the card --------------------------------------------


def _stream_chunks(n_streams: int, n_chunks: int, chunk: int = 64) -> np.ndarray:
    """(n_chunks, n_streams, chunk, 80) mels of synthetic speech."""
    rows = []
    for s in range(n_streams):
        wav = torch.tensor(synthetic_speech(10 + s, n_chunks * chunk * 256))
        rows.append(sp.waveform_to_r9y9_melspec(wav)[: n_chunks * chunk].numpy())
    return np.stack(rows).reshape(n_streams, n_chunks, chunk, 80).transpose(1, 0, 2, 3)


def _small_generator():
    g = AdvocGenerator(small_config())
    g.reset_parameters(torch.Generator().manual_seed(0))
    return g


def test_streaming_masked_rows_are_bit_exact(dev):
    """One-hot masked pushes (what the server sends for one slot) equal the
    slot's row of all-active pushes bit for bit: the same batch shape takes
    the same cuBLAS and cuDNN algorithms, whose rows do not read each other."""
    from advoc_tpu_torch.infer import StreamingVocoder

    g = _small_generator()
    chunks = _stream_chunks(4, 3)
    batched = StreamingVocoder(g, n_streams=4, device=dev)
    rows = [batched.push(c) for c in chunks]
    for slot in (0, 3):
        sv = StreamingVocoder(g, n_streams=4, device=dev)
        onehot = np.arange(4) == slot
        for k, c in enumerate(chunks):
            x = np.zeros_like(c)
            x[slot] = c[slot]
            np.testing.assert_array_equal(sv.push(x, active=onehot)[slot], rows[k][slot])
    tail = batched.flush(active=np.arange(4) == 1)
    np.testing.assert_array_equal(tail[0], 0)


def test_streaming_card_against_cpu(dev):
    """The card's push against the same engine on the CPU. The heuristic
    engine's first push at 2 iterations (fp32 products on both): within
    2e-3 × peak, the bound between two float32 programs of
    tests/test_torch_streaming.py. With the bf16 small generator, whole
    streams at 16 iterations (G-L is chaotic): re-extracted mel L1 within
    10%."""
    from advoc_tpu_torch.infer import StreamingVocoder

    g = _small_generator()
    chunks = _stream_chunks(2, 6)
    card = StreamingVocoder(n_streams=2, gl_iters=2, device=dev)
    want = StreamingVocoder(n_streams=2, gl_iters=2, device="cpu").push(chunks[0])
    np.testing.assert_allclose(card.push(chunks[0]), want, atol=2e-3 * np.abs(want).max())
    l1 = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        sv = StreamingVocoder(g, n_streams=2, gl_iters=16, device=d)
        sig = np.concatenate([sv.push(c) for c in chunks] + [sv.flush()], axis=1)
        sig = sig[:, sv.flush_samples :]
        assert sig.shape == (2, 6 * 64 * 256)
        mel = torch.tensor(chunks.transpose(1, 0, 2, 3).reshape(2, -1, 80))
        got = sp.waveform_to_r9y9_melspec(torch.tensor(sig))[:, : mel.shape[1]]
        l1[name] = float((got - mel).abs().mean())
    assert abs(l1["card"] - l1["cpu"]) < 0.1 * l1["cpu"], l1


def test_streaming_int16_emit_on_the_card(dev):
    """The int16 emit, converted on the card, equals the float emit of an
    identical engine through save_as_wav's rounding, bit for bit."""
    from advoc_tpu_torch.infer import StreamingVocoder

    g = _small_generator()
    chunks = _stream_chunks(2, 2)
    f = StreamingVocoder(g, n_streams=2, device=dev)
    q = StreamingVocoder(g, n_streams=2, device=dev, emit_dtype="int16")
    for c in chunks:
        emit = q.push(c, readback=False)
        assert emit.is_cuda and emit.dtype == torch.int16
        ref = f.push(c)
        np.testing.assert_array_equal(
            emit.cpu().numpy(), np.round(np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16))
    np.testing.assert_array_equal(
        q.flush(), np.round(np.clip(f.flush(), -1.0, 1.0) * 32767.0).astype(np.int16))


def test_vocode_cli_takes_the_tensor_core_kernel(dev, tmp_path):
    """The offline CLI on the card runs the tensor-core G-L kernel."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.infer import vocode_cli

    (tmp_path / "in").mkdir()
    for i, n in enumerate((100 * 256 + 37, 300 * 256)):
        audioio.save_as_wav(synthetic_speech(i, n), tmp_path / "in" / f"{i}.wav")
    before = tgl.griffin_lim_kernel.tc_launches
    vocode_cli.main(["--input", str(tmp_path / "in"), "--out_dir", str(tmp_path / "out"),
                     "--gl_iters", "4", "--batch", "2"])
    assert tgl.griffin_lim_kernel.tc_launches > before
    assert len(list((tmp_path / "out").glob("*.wav"))) == 2


@pytest.mark.parametrize("packed_tail", [False, True])
def test_exported_vocoder_takes_the_kernels_on_the_card(dev, tmp_path, packed_tail):
    """An artifact of a Vocoder on the card records the registered kernels
    (advoc::griffin_lim, advoc::group_norm_act at each normalised level but
    the packed tail's, and advoc::packed_up under the packed tail); served,
    it launches them (2·4 + 1 tensor-core G-L launches, two GroupNorm
    launches a level, one B4 call) and equals the live call bit for bit
    (the same operators on the same weights)."""
    from advoc_tpu_torch.infer.export import ExportedVocoder, export_vocoder
    from advoc_tpu_torch.ops.kernels import registered

    cfg = AdvocConfig(n_frames=64, width=16, depth=4, packed_tail=packed_tail)
    g = AdvocGenerator(cfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    voc = Vocoder(g, chunk_frames=64, overlap_frames=8, gl_iters=4, device="cuda")
    mel, _ = _mel_mag(dev, 2, 128, 512)
    export_vocoder(voc, [(2, 128)], tmp_path, allow_custom_calls=True)
    program = torch.export.load(tmp_path / "voc_b2_t128.pt2")
    n_norms = 3 + 4 - packed_tail  # down1-3, up0-3 (the packed tail's norm is its own)
    want_ops = (["advoc::packed_up"] * packed_tail + ["advoc::griffin_lim"]
                + ["advoc::group_norm_act"] * n_norms)
    assert sorted(registered.recorded(program.graph_module)) == sorted(want_ops)
    served = ExportedVocoder(tmp_path)
    served(mel)
    before = (tgl.griffin_lim_kernel.tc_launches, tpu.packed_up_kernel.launches,
              tgn.group_norm_act_kernel.launches)
    got = served(mel)
    torch.cuda.synchronize()
    assert tgl.griffin_lim_kernel.tc_launches - before[0] == 2 * 4 + 1
    assert tpu.packed_up_kernel.launches - before[1] == (1 if packed_tail else 0)
    assert tgn.group_norm_act_kernel.launches - before[2] == 2 * n_norms
    torch.testing.assert_close(got, voc(mel), rtol=0, atol=0)


def test_xla_export_on_the_card_is_plain_aten(dev, tmp_path):
    """Without allow_custom_calls a phase_impl="xla" Vocoder on the card
    exports plain aten: its U-Net levels are traced as the plain GroupNorm
    and no advoc operator is recorded. Served, it launches no GroupNorm
    kernel and vocodes as the live call (which launches it at each of 7
    levels) does, up to the order of the statistics' sums: mel L1 within
    1e-3."""
    from advoc_tpu_torch.infer.export import ExportedVocoder, export_vocoder
    from advoc_tpu_torch.ops.kernels import registered

    g = AdvocGenerator(AdvocConfig(n_frames=64, width=16, depth=4))
    g.reset_parameters(torch.Generator().manual_seed(0))
    voc = Vocoder(g, chunk_frames=64, overlap_frames=8, gl_iters=4, device="cuda",
                  phase_impl="xla")
    mel, _ = _mel_mag(dev, 2, 128, 512)
    export_vocoder(voc, [(2, 128)], tmp_path)
    assert registered.recorded(torch.export.load(tmp_path / "voc_b2_t128.pt2").graph_module) == []
    served = ExportedVocoder(tmp_path)
    before = tgn.group_norm_act_kernel.launches
    got = served(mel)
    torch.cuda.synchronize()
    assert tgn.group_norm_act_kernel.launches == before
    live = voc(mel)
    torch.cuda.synchronize()
    assert tgn.group_norm_act_kernel.launches == before + 2 * 7

    def mel_l1(wav):
        return float((sp.waveform_to_r9y9_melspec(wav)[:, : mel.shape[1]] - mel).abs().mean())

    assert abs(mel_l1(got) - mel_l1(live)) <= 1e-3


def test_registered_operators_on_the_card(dev):
    """Each advoc:: operator's CUDA implementation is its kernel: the fake
    implementation's shapes and dtypes, counted launches, the plain version
    within the eager checks' bounds."""
    from advoc_tpu_torch.ops.kernels import registered
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS

    p = registered.params_list(DEFAULT_PARAMS)
    _, mag = _mel_mag(dev, 2, 64, 512)
    for mode in ("float32", "split_synth", "split", "split_anal", "bfloat16"):
        y = registered.griffin_lim_op(mag, None, None, 0, 0.0, mode, p)
        want = tgl.griffin_lim_plain(mag, 0, 0.0, loop_dtype=mode)
        torch.testing.assert_close(y, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    wav = torch.tensor(synthetic_speech(1, 2 * 64 * 256), device=dev).reshape(2, -1)
    before = tfeat.fused_melspec_kernel.launches
    mel = registered.fused_melspec_op(wav, p)
    assert tfeat.fused_melspec_kernel.launches == before + 1 and mel.shape == (2, 64, 80)
    torch.testing.assert_close(mel, tfeat.fused_melspec_plain(wav), rtol=0, atol=2e-4)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 16, 64, 64), generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn((4, 4, 64, 32), generator=g, device=dev) / 32.0
    bias = torch.zeros(32, device=dev)
    y, s1, s2 = registered.packed_up_op(x, wt, bias, 32, 8, True)
    assert s1.data_ptr() != s2.data_ptr() and y.shape == (1, 32, 64, 64)
    want = tpu.packed_up_plain(x, wt, bias, f=32, tm=8).float()
    torch.testing.assert_close(y.float(), want, rtol=0, atol=1e-2 * float(want.abs().max()))
    x, weight, bias = _gn_inputs(dev, (2, 64, 16, 32), seed=3)
    before = tgn.group_norm_act_kernel.launches
    y = registered.group_norm_act_op(x, weight, bias, 8, "leaky_relu")
    assert tgn.group_norm_act_kernel.launches == before + 2 and y.stride() == x.stride()
    assert torch.equal(y, tgn.group_norm_act_kernel(x, weight, bias, 8, "leaky_relu"))


# -- LWS and the matmul G-L's default precision on the card ------------------------


def _lws_mag(t: int = 32, rows: int = 2) -> torch.Tensor:
    """(rows, t, 513) magnitudes of synthetic speech, on the CPU."""
    wav = torch.tensor(synthetic_speech(3, rows * t * 256)).reshape(rows, -1)
    return sp.waveform_to_magspec(wav)[:, :t].contiguous()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


def test_lws_on_the_card_matches_cpu(dev):
    """Batch LWS (sequential and chromatic) and block pushes: the card's fp32
    GEMMs sum in another order than the CPU's, ≤ 1e-4 relative."""
    mag = _lws_mag()
    for colors in (1, 4):
        assert _rel(sp.lws(mag.to(dev), n_sweeps=3, colors=colors),
                    sp.lws(mag, n_sweeps=3, colors=colors)) < 1e-4
    got, want = [], []
    for m, carry, out in ((mag.to(dev), sp.lws_online_init(2, device=dev), got),
                          (mag, sp.lws_online_init(2), want)):
        for c0 in range(0, 32, 8):
            (er, ei), carry = sp.lws_block_push(m[:, c0 : c0 + 8], carry)
            out.append(torch.complex(er, ei).cpu())
    assert _rel(torch.cat(got, 1), torch.cat(want, 1)) < 1e-4


def test_lws_online_push_chunk_invariance_on_the_card(dev):
    """Chunks of 8, 4 and 1 emit the same bits on the card; against the CPU
    within the online bound of test_torch_lws.py, 2e-3."""
    mag = _lws_mag(24).to(dev)

    def run(cs, m=mag):
        carry, ems = sp.lws_online_init(2, device=m.device), []
        for c0 in range(0, 24, cs):
            (er, ei), carry = sp.lws_online_push(m[:, c0 : c0 + cs], carry)
            ems.append(torch.complex(er, ei))
        return torch.cat(ems, 1)

    em8 = run(8)
    assert em8.is_cuda
    for cs in (4, 1):
        assert torch.equal(run(cs), em8)
    assert _rel(em8, run(8, mag.cpu())) < 2e-3


@pytest.mark.parametrize("engine", ["lws_online", "lws_block"])
def test_lws_streaming_masked_rows_are_bit_exact(dev, engine):
    """One-hot masked pushes and flush equal the batched rows on the card."""
    from advoc_tpu_torch.infer import StreamingVocoder

    chunks = _stream_chunks(3, 2)
    kw = dict(n_streams=3, phase_engine=engine, lws_look_ahead=1, lws_sweeps=1, device=dev)
    batched = StreamingVocoder(**kw)
    rows = [batched.push(c) for c in chunks] + [batched.flush()]
    for slot in (0, 2):
        sv = StreamingVocoder(**kw)
        onehot = np.arange(3) == slot
        for k, c in enumerate(chunks):
            x = np.zeros_like(c)
            x[slot] = c[slot]
            np.testing.assert_array_equal(sv.push(x, active=onehot)[slot], rows[k][slot])
        np.testing.assert_array_equal(sv.flush(active=onehot)[slot], rows[-1][slot])


def test_matmul_default_precision_on_the_card(dev):
    """precision="default" of the matmul G-L: on the card one bf16 GEMM with
    an fp32 result, against the CPU's fp32 products of the same rounded
    operands (exact products, sums in another order): 1e-5 × peak. And the
    quality gate: mel L1 within 2e-3 of "highest" at 16 iterations."""
    x = torch.tensor(np.random.default_rng(0).standard_normal((64, 513)), dtype=torch.float32)
    got = sp._dft_matmul(x.to(dev), sp.DEFAULT_PARAMS, "inv_re", "default")
    assert got.dtype == torch.float32
    want = sp._dft_matmul(x, sp.DEFAULT_PARAMS, "inv_re", "default")
    assert _rel(got, want) < 1e-5
    mel, mag = _mel_mag(dev, 2, 128, 513)
    l1 = {prec: float((sp.waveform_to_r9y9_melspec(
        sp.griffin_lim(mag, n_iters=16, momentum=0.99, precision=prec))[:, :128] - mel).abs().mean())
        for prec in ("highest", "default")}
    assert abs(l1["default"] - l1["highest"]) < 2e-3, l1


@pytest.fixture
def second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def test_each_kernel_launches_on_its_tensors_card(second_card):
    """With cuda:0 current, each kernel on a tensor on cuda:1 equals its
    plain version there: the wrappers make the tensor's card current, where
    the launchers set their shared-memory attribute and launch."""
    dev = second_card
    torch.cuda.set_device(0)
    mel, mag = _mel_mag(dev, 2, 64, 512)
    for precision, rtol in (("highest", 1e-3), ("default", 2e-2)):
        y = tgl.griffin_lim_kernel(mag, 1, 0.0, precision=precision)
        want = tgl.griffin_lim_plain(mag, 1, 0.0, precision=precision)
        assert y.device == dev
        torch.testing.assert_close(y, want, rtol=0, atol=rtol * float(want.abs().max()))
    wav = torch.tensor(synthetic_speech(1, 2 * 64 * 256), device=dev).reshape(2, -1)
    torch.testing.assert_close(tfeat.fused_melspec_kernel(wav), tfeat.fused_melspec_plain(wav),
                               rtol=0, atol=2e-4)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 32, 72, 24), generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn((4, 4, 24, 40), generator=g, device=dev) / (16 * 24) ** 0.5
    bias = 0.1 * torch.randn(40, generator=g, device=dev)
    y = tpu.packed_up_kernel(x, wt, bias, f=40, tm=8).float()
    want = tpu.packed_up_plain(x, wt, bias, f=40, tm=8).float()
    torch.testing.assert_close(y, want, rtol=0, atol=1e-2 * float(want.abs().max()))
    x, weight, bias = _gn_inputs(dev, (2, 64, 16, 32), seed=4)
    y, stats = _gn_launch(x, weight, bias, "relu")
    assert y.device == dev and torch.equal(
        y, tgn.group_norm_apply_plain(x, stats[..., 0], stats[..., 1], weight, bias, "relu"))
    assert torch.cuda.current_device() == 0


def test_spans_time_the_card(dev):
    """Under a profiler on the card every range of a Vocoder call holds the
    kernels it launched: each child's time within its parent's, and the
    U-Net's convolutions and normalisations within the U-Net's."""
    from advoc_tpu_torch.utils import profiling

    g = AdvocGenerator(AdvocConfig(width=16))
    g.reset_parameters(torch.Generator().manual_seed(0))
    voc = Vocoder(g, device=dev)
    mel = torch.rand(4, 512, 80, device=dev)
    voc(mel)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            voc(mel)
        torch.cuda.synchronize()
    ms = profiling.device_ms(prof.profiler.kineto_results.events())
    assert ms and all(v > 0 for v in ms.values()), ms
    assert ms["advoc.conv"] + ms["advoc.norm"] <= ms["advoc.unet"] <= ms["advoc.windows"]
    parts = sum(ms["advoc." + n] for n in ("estimate", "windows", "project", "gl"))
    assert parts <= ms["advoc.vocode"] * (1 + 1e-6)
