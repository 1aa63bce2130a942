"""The fast-G-L kernel module (advoc_tpu_torch.ops.kernels.griffin_lim).

Its plain version is held to the two Pallas kernels it replaces, run as
tests/test_pallas_gl.py runs them on the CPU (interpret mode, float32 maps at
HIGHEST). A zero-phase start leaves bins where the rebuilt |u| ≈ 0, where the
projected phase is ill-conditioned: one float32 iteration differs from
float64 there by up to 2e-4 × peak, so one iteration is held to 5e-4 × peak,
and several iterations at momentum 0.99, which carry that difference
forward, to 1e-3 × peak. The CUDA kernel itself is tested on the card, in
tests/test_torch_cuda.py.

The split mode (precision="default") is held to the same Pallas kernels at
loop_dtype="split_synth", the JAX Vocoder's default. Both round the same
operands to bf16, so they differ only in the order of their f32 sums; where
y lies on a bf16 rounding boundary the two round it to neighbouring bf16
values, and the projection amplifies that where the rebuilt |u| is near
zero. The difference is a few isolated samples: 4.7e-4 × peak after one
iteration and 1.45e-3 × peak after four at B=2 × 64 frames (bounds 1e-3
and 3e-3), and at T=512 up to 8.2e-3 × peak at most but 1e-4 × peak on
average (bounds 1.5e-2 and 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.pallas.griffin_lim import griffin_lim_pallas, griffin_lim_pallas_tiled
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu.ops.reference import AudioParams as JAudioParams
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import featurizer as tfeat
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl
from advoc_tpu_torch.ops.reference import AudioParams

HIGHEST = jax.lax.Precision.HIGHEST


def _mag(b, t, seed):
    wav = loader.synthetic_speech(seed, b * t * P.hop_length)
    mel = jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P)[: b * t].reshape(b, t, P.n_mels)
    return np.asarray(mel), np.asarray(jsp.r9y9_melspec_to_magspec(mel, P))


@pytest.fixture(scope="module")
def short():
    return _mag(2, 64, 0)


@pytest.fixture(scope="module")
def long():
    return _mag(1, 512, 8)


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("n_bins", [512, 513])
    @pytest.mark.parametrize("n_iters,rtol", [(1, 5e-4), (4, 1e-3)])
    def test_single_tile_kernel(self, short, n_bins, n_iters, rtol):
        _, mag = short
        m = np.ascontiguousarray(mag[..., :n_bins])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(m), n_iters=n_iters, momentum=0.99, params=P, interpret=True,
            loop_dtype="float32", precision=HIGHEST))
        got = tgl.griffin_lim_plain(torch.tensor(m), n_iters, 0.99).numpy()
        assert got.shape == want.shape == (2, 64 * P.hop_length)
        _assert_close(got, want, rtol)

    @pytest.mark.parametrize("with_init", [False, True])
    def test_tiled_kernel(self, long, with_init):
        """B2 with halos (tile 256, halo 16, 3 iterations a round) equals the
        whole-utterance iteration, with and without an init phase."""
        _, mag = long
        phi = np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        want = np.asarray(griffin_lim_pallas_tiled(
            jnp.asarray(mag), n_iters=6, momentum=0.99, params=P, interpret=True,
            loop_dtype="float32", precision=HIGHEST, tile=256, halo=16, iters_per_round=3,
            init_phase=(jnp.cos(phi), jnp.sin(phi)) if with_init else None))
        tphi = torch.tensor(phi)
        got = tgl.griffin_lim_plain(
            torch.tensor(mag), 6, 0.99,
            init_phase=(torch.cos(tphi), torch.sin(tphi)) if with_init else None,
        ).numpy()
        assert got.shape == want.shape == (1, 512 * P.hop_length)
        _assert_close(got, want, 1e-3)

    @pytest.mark.parametrize("hop,n_bins", [(128, 256), (128, 257), (50, 101)])
    def test_other_audio_params(self, hop, n_bins):
        """Any n_fft = 4 · hop, as the Pallas kernel takes: hop 128, and hop 50
        (not a multiple of 4, the CUDA kernel's masked scalar path)."""
        kw = dict(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        jq, q = JAudioParams(**kw), AudioParams(**kw)
        wav = loader.synthetic_speech(hop, 2 * 32 * hop).reshape(2, -1)
        mag = np.ascontiguousarray(
            np.asarray(jsp.waveform_to_magspec(jnp.asarray(wav), jq))[:, :32, :n_bins])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(mag), n_iters=2, momentum=0.99, params=jq, interpret=True,
            loop_dtype="float32", precision=HIGHEST))
        got = tgl.griffin_lim_kernel(torch.tensor(mag), 2, 0.99, params=q).numpy()
        assert got.shape == want.shape == (2, 32 * hop)
        _assert_close(got, want, 1e-3)

    def test_quality_matches_xla_scan(self):
        """The uncropped iteration differs from the XLA scan at the edges;
        at test_pallas_gl.py's 256-frame chunks its re-extracted mel L1 stays
        within that file's 10% band."""
        mel, mag = _mag(2, 256, 0)
        y = tgl.griffin_lim_plain(torch.tensor(mag), 8, 0.99).numpy()
        yx = np.asarray(jsp.griffin_lim(jnp.asarray(mag), n_iters=8, momentum=0.99, params=P))
        l1 = lambda w: float(np.abs(  # noqa: E731
            np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(w), P))[:, :256] - mel).mean())
        assert l1(y) < 1.1 * l1(yx) + 1e-4, (l1(y), l1(yx))


class TestSplitAgainstPallas:
    """precision="default" against loop_dtype="split_synth"."""

    @pytest.mark.parametrize("n_bins", [512, 513])
    @pytest.mark.parametrize("n_iters,rtol", [(1, 1e-3), (4, 3e-3)])
    def test_single_tile_kernel(self, short, n_bins, n_iters, rtol):
        _, mag = short
        m = np.ascontiguousarray(mag[..., :n_bins])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(m), n_iters=n_iters, momentum=0.99, params=P, interpret=True,
            loop_dtype="split_synth"))
        got = tgl.griffin_lim_plain(torch.tensor(m), n_iters, 0.99, precision="default").numpy()
        assert got.shape == want.shape == (2, 64 * P.hop_length)
        _assert_close(got, want, rtol)

    @pytest.mark.parametrize("with_init", [False, True])
    def test_tiled_kernel(self, long, with_init):
        """B2 (two rounds on 256-frame tiles with halos) and its f32 final
        synthesis, with and without an init phase."""
        _, mag = long
        phi = np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        want = np.asarray(griffin_lim_pallas_tiled(
            jnp.asarray(mag), n_iters=4, momentum=0.99, params=P, interpret=True,
            loop_dtype="split_synth", tile=256, halo=16, iters_per_round=2,
            init_phase=(jnp.cos(phi), jnp.sin(phi)) if with_init else None))
        tphi = torch.tensor(phi)
        got = tgl.griffin_lim_plain(
            torch.tensor(mag), 4, 0.99, precision="default",
            init_phase=(torch.cos(tphi), torch.sin(tphi)) if with_init else None,
        ).numpy()
        assert got.shape == want.shape == (1, 512 * P.hop_length)
        _assert_close(got, want, 1.5e-2)
        assert np.abs(got - want).mean() <= 3e-4 * np.abs(want).max()

    def test_short_input_with_init_phase_takes_the_f32_tail(self, short):
        """An init phase routes JAX to B2 at any length, so the final
        synthesis is f32 even for T ≤ 256."""
        _, mag = short
        phi = np.random.default_rng(1).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(mag), n_iters=2, momentum=0.99, params=P, interpret=True,
            loop_dtype="split_synth", init_phase=(jnp.cos(phi), jnp.sin(phi))))
        tphi = torch.tensor(phi)
        got = tgl.griffin_lim_plain(torch.tensor(mag), 2, 0.99, precision="default",
                                    init_phase=(torch.cos(tphi), torch.sin(tphi))).numpy()
        _assert_close(got, want, 3e-3)

    def test_padded_hop_50(self):
        """hop 50 and F 101, which the tensor-core kernel pads to 64 and 128."""
        hop = 50
        kw = dict(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        jq, q = JAudioParams(**kw), AudioParams(**kw)
        wav = loader.synthetic_speech(hop, 2 * 32 * hop).reshape(2, -1)
        mag = np.ascontiguousarray(
            np.asarray(jsp.waveform_to_magspec(jnp.asarray(wav), jq))[:, :32, :101])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(mag), n_iters=4, momentum=0.99, params=jq, interpret=True,
            loop_dtype="split_synth"))
        got = tgl.griffin_lim_kernel(torch.tensor(mag), 4, 0.99, params=q,
                                     precision="default").numpy()
        assert got.shape == want.shape == (2, 32 * hop)
        _assert_close(got, want, 3e-3)

    def test_split_maps_match_pallas(self):
        """The split maps equal _gl_maps(loop_dtype="split_synth") without
        its lane padding: bf16 forward maps, (hi, lo) inverse pairs."""
        from advoc_tpu.ops.pallas.griffin_lim import _gl_maps

        fwd_re, fwd_im, inv_re, inv_im = (np.asarray(m, np.float32)
                                          for m in _gl_maps(P, "split_synth", 512))
        got = [m.numpy() for m in tgl._split_maps(AudioParams(), 512, torch.device("cpu"))]
        np.testing.assert_array_equal(got[0], fwd_re[:, :512])
        np.testing.assert_array_equal(got[1], fwd_im[:, :512])
        for (hi, lo), m in (((got[2], got[3]), inv_re), ((got[4], got[5]), inv_im)):
            np.testing.assert_array_equal(hi, m[:512])
            np.testing.assert_array_equal(lo, m[512:1024])


class TestLoopModesAgainstPallas:
    """loop_dtype "split", "split_anal" and "bfloat16" against the Pallas
    kernels at the same loop_dtype: the same operands rounded to bf16 and
    the sums taken in another order, so the split mode's bounds hold
    (1e-3 and 3e-3 × peak after one and four iterations; the tiled kernel
    1.5e-2 × peak at most, 3e-4 × peak on average)."""

    @pytest.mark.parametrize("mode", ["split", "split_anal", "bfloat16"])
    @pytest.mark.parametrize("n_iters,rtol", [(1, 1e-3), (4, 3e-3)])
    def test_single_tile_kernel(self, short, mode, n_iters, rtol):
        _, mag = short
        m = np.ascontiguousarray(mag[..., :512])
        want = np.asarray(griffin_lim_pallas(
            jnp.asarray(m), n_iters=n_iters, momentum=0.99, params=P, interpret=True,
            loop_dtype=mode))
        got = tgl.griffin_lim_plain(torch.tensor(m), n_iters, 0.99, loop_dtype=mode).numpy()
        assert got.shape == want.shape == (2, 64 * P.hop_length)
        _assert_close(got, want, rtol)

    @pytest.mark.parametrize("mode", ["split", "split_anal", "bfloat16"])
    def test_tiled_kernel(self, long, mode):
        """B2 (two rounds of one iteration on 256-frame tiles with halos) and
        its f32 final synthesis, which every bf16 mode shares. Two
        iterations: at four, momentum 0.99 carries the isolated bf16
        rounding spikes on to 2.5e-2 × peak at most in the split mode
        (1.4e-2 split_anal, 1.3e-2 bfloat16, 8.2e-3 split_synth) at a mean
        of 1.7e-4 × peak, the chaotic growth the split_synth test bounds."""
        _, mag = long
        want = np.asarray(griffin_lim_pallas_tiled(
            jnp.asarray(mag), n_iters=2, momentum=0.99, params=P, interpret=True,
            loop_dtype=mode, tile=256, halo=16, iters_per_round=1))
        got = tgl.griffin_lim_plain(torch.tensor(mag), 2, 0.99, loop_dtype=mode).numpy()
        assert got.shape == want.shape == (1, 512 * P.hop_length)
        _assert_close(got, want, 1.5e-2)
        assert np.abs(got - want).mean() <= 3e-4 * np.abs(want).max()

    def test_forward_maps_split_as_pallas(self):
        """The forward maps' (hi, lo) pairs equal _gl_maps(loop_dtype="split")
        without its lane padding."""
        from advoc_tpu.ops.pallas.griffin_lim import _gl_maps

        fwd_re, fwd_im, _, _ = (np.asarray(m, np.float32) for m in _gl_maps(P, "split", 512))
        hi = tgl._split_maps(AudioParams(), 512, torch.device("cpu"))[:2]
        lo = tgl._fwd_lo(AudioParams(), 512, torch.device("cpu"))
        for h, l, m in zip(hi, lo, (fwd_re, fwd_im)):
            np.testing.assert_array_equal(h.numpy(), m[: P.n_fft, :512])
            np.testing.assert_array_equal(l.numpy(), m[P.n_fft :, :512])

    def test_mode_names(self, short):
        """loop_dtype takes JAX's five names and wins over precision; the two
        precisions name float32 and split_synth."""
        assert tgl.loop_mode("highest") == "float32"
        assert tgl.loop_mode("default") == "split_synth"
        assert tgl.loop_mode("default", "bfloat16") == "bfloat16"
        _, mag = short
        m = torch.tensor(mag[..., :512]).contiguous()
        for mode, precision in (("float32", "highest"), ("split_synth", "default")):
            torch.testing.assert_close(tgl.griffin_lim_kernel(m, 1, 0.99, loop_dtype=mode),
                                       tgl.griffin_lim_plain(m, 1, 0.99, precision=precision),
                                       rtol=0, atol=0)
        with pytest.raises(ValueError, match="loop_dtype"):
            tgl.griffin_lim_kernel(m, 2, 0.99, loop_dtype="float16")


def _emulate_tensor_core_layout(mag, n_iters, momentum, params, mode="split_synth"):
    """The tensor-core kernel's products as dense shifted matmuls over its
    padded operands (_tc_maps, _carry, _norm): synthesis reads carry rows
    r + 3 − k, analysis y rows r + k, and the analysis columns come in
    groups of 64 real then 64 imaginary bins. A split product reads the hi
    and lo tiles of a map, a plain one the hi tile alone (ws[:, :, 0], wa)."""
    split_anal, split_synth = tgl._SPLIT[mode]
    b, t, f = mag.shape
    hop = params.hop_length
    fp, hp = tgl._pad64(f), tgl._pad64(hop)
    m_rows = b * (t + 3)
    ws, wa, wa_lo = (w.float() for w in tgl._tc_maps(params, f, mag.device))
    if not split_synth:
        ws = torch.stack([ws[:, :, 0], torch.zeros_like(ws[:, :, 0])], dim=2)
    if split_anal:
        wa = wa + wa_lo  # hi + lo is exact in f32, as each product is
    norm = tgl._norm(params, t, hp, mag.device)
    rows_norm = norm.repeat(b, 1)
    re, im = (tgl._carry(x, b, t, fp, torch.bfloat16).float() for x in tgl._init_carries(mag, None))
    magp = tgl._carry(mag, b, t, fp, torch.float32)
    pre, pim = torch.zeros_like(magp), torch.zeros_like(magp)
    valid = (torch.arange(m_rows) % (t + 3) < t)[:, None]

    def synth():
        acc = torch.zeros((m_rows, hp))
        for k in range(4):
            for part, c in enumerate((re, im)):
                rows = c[3 - k : 3 - k + m_rows]
                acc += rows @ (ws[k, part, 0] + ws[k, part, 1]).T
        return acc * rows_norm

    for i in range(n_iters):
        y = torch.cat([synth().to(torch.bfloat16).float(), torch.zeros((3, hp))])
        acc = sum(y[k : k + m_rows] @ wa[:, :, :, k].reshape(2 * fp, hp).T for k in range(4))
        acc = acc.reshape(m_rows, fp // 64, 2, 64)
        ar, ai = acc[:, :, 0].reshape(m_rows, fp), acc[:, :, 1].reshape(m_rows, fp)
        m = 0.0 if i == 0 else momentum
        ur = ar + m * (ar - pre[3:])
        ui = ai + m * (ai - pim[3:])
        scale = magp[3:] * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        pre[3:] = torch.where(valid, ar, pre[3:])
        pim[3:] = torch.where(valid, ai, pim[3:])
        re[3:] = torch.where(valid, _bf16(ur * scale), re[3:])
        im[3:] = torch.where(valid, _bf16(ui * scale), im[3:])
    out = synth().view(b, t + 3, hp)[:, 2 : 2 + t, :hop]
    return out.reshape(b, t * hop)


def _bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("hop,n_bins,t", [(256, 513, 40), (50, 101, 30), (250, 501, 20)])
def test_tensor_core_operand_layout(hop, n_bins, t):
    """The padded carry, map and norm layouts the tensor-core kernel reads
    compute the plain version's function (synthesis alone to 1e-5 × peak;
    two iterations to 2e-3 × peak, the sums taken in another order), for
    split_synth (split synthesis, plain analysis) and split_anal (plain
    synthesis, split analysis): every operand layout of the four bf16
    modes. The emulation adds a split analysis's hi and lo maps before one
    product, which is exact in f32 up to the product's rounding: within the
    same bound."""
    kw = dict(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    q = AudioParams(**kw)
    wav = loader.synthetic_speech(hop, 2 * t * hop).reshape(2, -1)
    mag = torch.tensor(np.asarray(jsp.waveform_to_magspec(
        jnp.asarray(wav), JAudioParams(**kw)))[:, :t, :n_bins]).contiguous()
    for mode in ("split_synth", "split_anal"):
        for n_iters, rtol in ((0, 1e-5), (2, 2e-3)):
            got = _emulate_tensor_core_layout(mag, n_iters, 0.99, q, mode)
            want = tgl.griffin_lim_plain(mag, n_iters, 0.99, params=q, loop_dtype=mode)
            _assert_close(got.numpy(), want.numpy(), rtol)


def _emulate_tf32_layout(mag, n_iters, momentum, params):
    """The fp32 kernel's products as dense shifted matmuls over its padded
    f32 operands (_tf32_maps, _carry, _norm), in 3xTF32: each A row split
    into TF32 big and small halves by bit arithmetic (cvt.rna's rounding,
    featurizer._tf32_split), small·big + big·small + big·big summed in f32
    (each product of two TF32 values is exact in f32). Synthesis reads carry
    rows r + 3 − k, analysis y rows r + k and the analysis columns come in
    groups of 64 real then 64 imaginary bins, as in the tensor-core layout."""
    b, t, f = mag.shape
    hop = params.hop_length
    fp, hp = tgl._pad64(f), tgl._pad64(hop)
    m_rows = b * (t + 3)
    ws, wa = tgl._tf32_maps(params, f, mag.device)
    wa = wa.reshape(2, 2 * fp, 4, hp)  # (big|small, 128-row tiles, k, s)
    rows_norm = tgl._norm(params, t, hp, mag.device).repeat(b, 1)
    re, im = (tgl._carry(x, b, t, fp, torch.float32) for x in tgl._init_carries(mag, None))
    magp = tgl._carry(mag, b, t, fp, torch.float32)
    pre, pim = torch.zeros_like(magp), torch.zeros_like(magp)
    valid = (torch.arange(m_rows) % (t + 3) < t)[:, None]

    def product(a, big, small):  # a (M, K); the map's halves K-major (N, K)
        ab, a_s = (torch.from_numpy(x) for x in tfeat._tf32_split(a.numpy()))
        return a_s @ big.T + ab @ small.T + ab @ big.T

    def synth():
        acc = torch.zeros((m_rows, hp))
        for k in range(4):
            for part, c in enumerate((re, im)):
                acc += product(c[3 - k : 3 - k + m_rows], ws[k, part, 0], ws[k, part, 1])
        return acc * rows_norm

    for i in range(n_iters):
        y = torch.cat([synth(), torch.zeros((3, hp))])
        acc = sum(product(y[k : k + m_rows], wa[0, :, k], wa[1, :, k]) for k in range(4))
        acc = acc.reshape(m_rows, fp // 64, 2, 64)
        ar, ai = acc[:, :, 0].reshape(m_rows, fp), acc[:, :, 1].reshape(m_rows, fp)
        m = 0.0 if i == 0 else momentum
        ur = ar + m * (ar - pre[3:])
        ui = ai + m * (ai - pim[3:])
        scale = magp[3:] * torch.rsqrt(ur * ur + ui * ui + 1e-12)
        pre[3:] = torch.where(valid, ar, pre[3:])
        pim[3:] = torch.where(valid, ai, pim[3:])
        re[3:] = torch.where(valid, ur * scale, re[3:])
        im[3:] = torch.where(valid, ui * scale, im[3:])
    return tgl._blocks(synth(), b, t, params)


@pytest.mark.parametrize("hop,n_bins,t", [(256, 513, 40), (50, 101, 30), (250, 501, 20)])
def test_tf32_operand_layout(hop, n_bins, t):
    """The padded f32 carry, split map and norm layouts the fp32 (3xTF32)
    kernel reads compute the float32 plain version's function: synthesis
    alone within 1e-5 × peak, two iterations at momentum 0.99 within 1e-3 ×
    peak (chip_smoke.py's gates for the kernel); the maps' halves are TF32
    values that sum to the maps."""
    kw = dict(n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
    q = AudioParams(**kw)
    ws, wa = tgl._tf32_maps(q, n_bins, torch.device("cpu"))
    for halves in (ws.unbind(2), wa.unbind(0)):
        assert all(int((h.view(torch.int32) & 0x1FFF).abs().max()) == 0 for h in halves)
    inv_re = tgl._maps(q, n_bins, torch.device("cpu"))[2]
    np.testing.assert_allclose((ws[:, 0, 0] + ws[:, 0, 1])[..., :hop, :n_bins].numpy(),
                               inv_re.reshape(n_bins, 4, hop).permute(1, 2, 0).numpy(),
                               rtol=2**-21, atol=1e-12)
    wav = loader.synthetic_speech(hop, 2 * t * hop).reshape(2, -1)
    mag = torch.tensor(np.asarray(jsp.waveform_to_magspec(
        jnp.asarray(wav), JAudioParams(**kw)))[:, :t, :n_bins]).contiguous()
    for n_iters, rtol in ((0, 1e-5), (2, 1e-3)):
        got = _emulate_tf32_layout(mag, n_iters, 0.99, q)
        want = tgl.griffin_lim_plain(mag, n_iters, 0.99, params=q, loop_dtype="float32")
        _assert_close(got.numpy(), want.numpy(), rtol)


class TestWrapper:
    def test_cpu_tensor_runs_plain_and_counts_nothing(self, short):
        _, mag = short
        m = torch.tensor(mag[..., :512]).contiguous()
        before = tgl.griffin_lim_kernel.launches
        got = tgl.griffin_lim_kernel(m, 3, 0.99)
        assert tgl.griffin_lim_kernel.launches == before
        torch.testing.assert_close(got, tgl.griffin_lim_plain(m, 3, 0.99), rtol=0, atol=0)

    def test_precision_selects_the_mode(self, short):
        """On a CPU tensor both modes are the plain version; "default" is
        split, "highest" (the default here) fp32, anything else raises."""
        _, mag = short
        m = torch.tensor(mag[..., :512]).contiguous()
        torch.testing.assert_close(
            tgl.griffin_lim_kernel(m, 2, 0.99, precision="default"),
            tgl.griffin_lim_plain(m, 2, 0.99, precision="default"), rtol=0, atol=0)
        torch.testing.assert_close(tgl.griffin_lim_kernel(m, 2, 0.99),
                                   tgl.griffin_lim_plain(m, 2, 0.99, precision="highest"),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="precision"):
            tgl.griffin_lim_kernel(m, 2, 0.99, precision="bf16")

    def test_rejects_bad_shapes(self, short):
        _, mag = short
        with pytest.raises(ValueError, match="B, T, F"):
            tgl.griffin_lim_kernel(torch.tensor(mag[0]), 1, 0.99)
        with pytest.raises(ValueError, match="F must be"):
            tgl.griffin_lim_kernel(torch.tensor(mag[..., :500]), 1, 0.99)

    def test_norm_is_the_uncropped_nola(self):
        """_gl_norm equals the Pallas kernel's _gl_norm without its row padding."""
        from advoc_tpu.ops.pallas.griffin_lim import _gl_norm

        want, _ = _gl_norm(P, 64)
        np.testing.assert_array_equal(tgl._gl_norm(P, 64), want[: 64 + 3])


class TestBuild:
    def test_library_path_is_keyed_by_sources(self):
        path = _build.library_path("griffin_lim")
        assert path.parent == _build.BUILD_DIR and path.name.startswith("libgriffin_lim_")
        assert path == _build.library_path("griffin_lim")

    def test_nvcc_command_targets_sm90a(self):
        cmd = _build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd

    def test_missing_nvcc_raises(self, monkeypatch):
        import shutil

        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()
