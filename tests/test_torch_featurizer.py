"""The port's fused featurizer (B3) against the JAX package's Pallas kernel.

The plain version is what the CUDA kernel is held to on the card; here it is
held to JAX ``fused_melspec`` run in interpret mode on the CPU, on the same
numpy audio. Both are float32 throughout (the JAX kernel at
Precision.HIGHEST), so they agree to float32 rounding of the DFT sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.pallas import featurizer as jfeat
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P, AudioParams as JAudioParams
from advoc_tpu_torch.ops import spectral as tsp
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import featurizer as tfeat
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as TP, AudioParams

HOP = P.hop_length
# Both sides are fp32 sums over 1024 samples in different orders: 1.5e-7 in
# normalized-dB units on these inputs. The log amplifies a relative error
# where a mel band is quiet, hence the margin.
ATOL = 1e-4


def test_kernel_consts_equal_jax():
    for got, want in zip(tfeat._kernel_consts(TP), jfeat._kernel_consts(P)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (tfeat.F_KEPT, tfeat.MEL_PAD) == (jfeat.F_KEPT, jfeat.MEL_PAD)


@pytest.mark.parametrize("shape,t_blk", [
    ((256 * HOP,), 256),             # exactly one JAX tile
    ((300 * HOP,), 128),             # several tiles, the last cropped
    ((2, 128 * HOP), 128),           # batched
    ((2, 1, 40 * HOP + 77), 256),    # extra lead dim; L not a multiple of hop
])
def test_plain_matches_jax_fused_melspec(shape, t_blk):
    n = int(np.prod(shape))
    wav = loader.synthetic_speech(len(shape), n).reshape(shape).astype(np.float32)
    want = np.asarray(jfeat.fused_melspec(jnp.asarray(wav), P, t_blk=t_blk, interpret=True))
    got = tfeat.fused_melspec_plain(torch.tensor(wav), TP).numpy()
    assert got.shape == want.shape == shape[:-1] + (shape[-1] // HOP, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_impl_kernel_on_cpu_gives_l_over_hop_frames():
    wav = loader.synthetic_speech(3, 100 * HOP + 5)
    got = tsp.waveform_to_r9y9_melspec(torch.tensor(wav), TP, impl="kernel")
    assert got.shape == (100, 80)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(torch.tensor(wav)), rtol=0, atol=0)
    xla = tsp.waveform_to_r9y9_melspec(torch.tensor(wav), TP)
    assert xla.shape == (101, 80)
    # tests/test_pallas.py's bound between the fused and the STFT paths.
    np.testing.assert_allclose(got.numpy(), xla[:100].numpy(), rtol=0, atol=3e-3)


def test_rejects_what_the_tpu_kernel_rejects():
    with pytest.raises(ValueError, match="n_fft"):
        tfeat.fused_melspec_kernel(torch.zeros(4096), AudioParams(n_fft=1024, hop_length=200))
    with pytest.raises(ValueError, match="reflect"):
        tfeat.fused_melspec_kernel(torch.zeros(512), TP)
    assert tfeat.fused_melspec_kernel(torch.zeros(513), TP).shape == (2, 80)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    before = _build.launches["fused_melspec"]
    wav = torch.tensor(loader.synthetic_speech(4, 8 * HOP))
    got = tfeat.fused_melspec_kernel(wav, TP)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(wav, TP), rtol=0, atol=0)
    assert _build.launches["fused_melspec"] == before


def test_plain_matches_jax_stft_path():
    """Against the JAX package's default featurizer (its STFT path) on the
    first L//hop frames, within tests/test_pallas.py's 3e-3."""
    wav = loader.synthetic_speech(5, 64 * HOP)
    want = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[:64]
    got = tfeat.fused_melspec_plain(torch.tensor(wav), TP).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32 keeps 10 mantissa bits
    a = np.array([one, one + ulp, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4], np.float32)
    want = np.array([one, one + ulp, one + ulp, -(one + ulp), one, one + ulp], np.float32)
    np.testing.assert_array_equal(tfeat._tf32_rna(a), want)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    big, small = tfeat._tf32_split(x)
    assert (big.view(np.uint32) & 0x1FFF == 0).all() and (small.view(np.uint32) & 0x1FFF == 0).all()
    np.testing.assert_allclose(big.astype(np.float64) + small, x, rtol=2.0**-21, atol=0)


def _bf16_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """a ≈ hi + lo, both bf16 (as float32): the one-split bf16 form."""
    hi = torch.tensor(a).to(torch.bfloat16).float()
    return hi.numpy(), (torch.tensor(a) - hi).to(torch.bfloat16).float().numpy()


def _emulate_tensor_core_featurizer(wav: np.ndarray, split=tfeat._tf32_split,
                                    params=TP) -> np.ndarray:
    """The CUDA kernel's arithmetic on the CPU: hop blocks of the
    reflect-padded audio, each zero-padded to the kernel's block width hb,
    and the kernel's K-major chunked maps, both split into TF32 big and
    small parts; big·big + big·small + small·big per band (hb columns of
    the maps), summed in float64; |X|; the mel fold as the same split
    product against the kernel's reordered filterbank; dB, normalize and
    clip. ``split`` gives the form: TF32 big and small parts (the
    kernel's), or bf16."""
    hop, pad = params.hop_length, params.n_fft // 2
    hb = tfeat.block_width(hop)
    n = wav.shape[-1] // hop
    xp = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    xp = np.pad(xp, ((0, 0), (0, max(0, (n + 3) * hop - xp.shape[1]))))[:, : (n + 3) * hop]
    blocks = np.pad(xp.reshape(-1, n + 3, hop), ((0, 0), (0, 0), (0, hb - hop)))
    maps, fbank = tfeat._tc_operands(params)
    a_big, a_small = split(blocks)
    w_big, w_small = split(maps)
    acc = np.zeros((wav.shape[0], n, 2 * tfeat.F_KEPT))
    for k in range(4):
        ab, as_ = (a[:, k : k + n].astype(np.float64) for a in (a_big, a_small))
        wb, ws = (w[:, k * hb : (k + 1) * hb].astype(np.float64) for w in (w_big, w_small))
        acc += ab @ wb.T + ab @ ws.T + as_ @ wb.T
    acc = acc.reshape(wav.shape[0], n, tfeat.F_KEPT // 64, 2, 64)  # chunk, (re, im), bin
    mag = np.sqrt(acc[..., 0, :] ** 2 + acc[..., 1, :] ** 2).reshape(wav.shape[0], n, -1)
    # The fold: |X| in the filterbank's K order (each 8-bin group reordered),
    # split, against the split and reordered filterbank.
    order = (np.arange(tfeat.F_KEPT) // 8) * 8 + np.tile(tfeat.MEL_K_ORDER, tfeat.F_KEPT // 8)
    m_big, m_small = (a.astype(np.float64) for a in split(mag[..., order].astype(np.float32)))
    f_big, f_small = (a.astype(np.float64).T for a in split(fbank))
    mel = (m_big @ f_big + m_big @ f_small + m_small @ f_big)[..., : params.n_mels]
    db = 20.0 * np.log10(np.maximum(params.amp_floor, mel)) - params.ref_level_db
    return np.clip((db - params.min_level_db) / -params.min_level_db, 0.0, 1.0)


def _quiet_row_wav(hop: int = HOP) -> np.ndarray:
    """Loud speech and a row with a stretch at 1e-3 amplitude, ragged L."""
    length = 64 * hop + 77
    wav = loader.synthetic_speech(7, 2 * length).reshape(2, length).astype(np.float32)
    wav[1, 10 * hop : 40 * hop] *= 1e-3
    return wav


def test_tensor_core_operand_layout():
    """The split audio and maps, in the layouts the kernel reads, give the
    featurizer's function to 1e-4: against the plain version and the JAX
    kernel, on loud speech and on a row with a stretch at 1e-3 amplitude
    (the quiet bins where reduced precision fails), at a ragged L."""
    wav = _quiet_row_wav()
    got = _emulate_tensor_core_featurizer(wav)
    plain = tfeat.fused_melspec_plain(torch.tensor(wav), TP).numpy()
    jax_ = np.asarray(jfeat.fused_melspec(jnp.asarray(wav), P, t_blk=128, interpret=True))
    assert got.shape == plain.shape == jax_.shape == (2, 64, 80)
    assert plain[1, 12:38].max() < 0.5 * plain[0].max()  # the stretch is quiet
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jax_, rtol=0, atol=ATOL)


# Hops whose blocks the kernel pads (200 → 208, 250 → 256, 600 → 608), the
# 44.1 kHz n_fft 2048 (whose mel support ends at the same bin as the
# default's) and 48 kHz at hop 600.
OTHER_HOPS = [dict(hop_length=200), dict(hop_length=250),
              dict(hop_length=512, sample_rate=44100), dict(hop_length=600, sample_rate=48000)]


@pytest.mark.parametrize("kw", OTHER_HOPS, ids=lambda kw: f"hop{kw['hop_length']}")
def test_tensor_core_operand_layout_other_hops(kw):
    """As test_tensor_core_operand_layout at hops that are not a multiple of
    the kernel's 16-sample K slice, and at n_fft 2048."""
    kw = dict(kw, n_fft=4 * kw["hop_length"], win_length=4 * kw["hop_length"])
    params, jparams = AudioParams(**kw), JAudioParams(**kw)
    wav = _quiet_row_wav(kw["hop_length"])
    got = _emulate_tensor_core_featurizer(wav, params=params)
    plain = tfeat.fused_melspec_plain(torch.tensor(wav), params).numpy()
    jax_ = np.asarray(jfeat.fused_melspec(jnp.asarray(wav), jparams, t_blk=128, interpret=True))
    assert got.shape == plain.shape == jax_.shape == (2, 64, 80)
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jax_, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hop", [200, 250])
def test_tc_operands_pad_each_band_with_zeros(hop):
    params = AudioParams(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    w_cos, w_sin, _ = tfeat._kernel_consts(params)
    maps, _ = tfeat._tc_operands(params)
    hb = tfeat.block_width(hop)
    assert hb % 16 == 0 and 0 < hb - hop < 16
    assert maps.shape == (2 * tfeat.F_KEPT, 4 * hb)
    bands = maps.reshape(tfeat.F_KEPT // 64, 2, 64, 4, hb)
    assert not bands[..., hop:].any()
    for c in range(tfeat.F_KEPT // 64):
        bins = slice(64 * c, 64 * (c + 1))
        for k in range(4):
            rows = slice(k * hop, (k + 1) * hop)
            np.testing.assert_array_equal(bands[c, 0, :, k, :hop], w_cos[rows, bins].T)
            np.testing.assert_array_equal(bands[c, 1, :, k, :hop], w_sin[rows, bins].T)


def test_tc_consts_are_the_chunked_maps_and_ordered_filterbank():
    w_cos, w_sin, mel_t = tfeat._kernel_consts(TP)
    big, small, f_big, f_small = tfeat._tc_consts(TP)
    for part, whole in zip(((big, small), (f_big, f_small)), tfeat._tc_operands(TP)):
        for got, want in zip(part, tfeat._tf32_split(whole)):
            np.testing.assert_array_equal(got, want)
    assert big.shape == small.shape == (2 * tfeat.F_KEPT, P.n_fft)
    assert f_big.shape == f_small.shape == (80, tfeat.F_KEPT)
    fb = f_big.astype(np.float64) + f_small
    for g in range(tfeat.F_KEPT // 8):
        for k, src in enumerate(tfeat.MEL_K_ORDER):
            np.testing.assert_allclose(fb[:, 8 * g + k], mel_t[8 * g + src, :80], rtol=2.0**-20)
    full = big.astype(np.float64) + small
    for c in range(tfeat.F_KEPT // 64):
        bins = slice(64 * c, 64 * (c + 1))
        np.testing.assert_allclose(full[128 * c : 128 * c + 64], w_cos[:, bins].T, rtol=0, atol=1e-7)
        np.testing.assert_allclose(full[128 * c + 64 : 128 * (c + 1)], w_sin[:, bins].T,
                                   rtol=0, atol=1e-7)


def test_bf16_hi_lo_split_is_not_enough():
    """Why the kernel splits into TF32 parts: the same three products on a
    bf16 hi/lo split miss the layout bound by an order of magnitude on the
    quiet row and reach the card's 1e-3 gate, where 3xTF32 stays within
    a fifth of the bound."""
    wav = _quiet_row_wav()
    plain = tfeat.fused_melspec_plain(torch.tensor(wav), TP).numpy()
    err_tf32 = np.abs(_emulate_tensor_core_featurizer(wav) - plain).max()
    err_bf16 = np.abs(_emulate_tensor_core_featurizer(wav, split=_bf16_split) - plain).max()
    assert err_tf32 < 0.2 * ATOL and err_bf16 > 5e-4, (err_tf32, err_bf16)
