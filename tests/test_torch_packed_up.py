"""The port's packed-tail transpose-conv (B4) against the JAX package's kernel.

The plain version is what the CUDA kernel is held to on the card; here it is
held to JAX ``packed_up`` in interpret mode on the CPU at the shapes of
tests/test_pallas.py, fed the converter's torch weight turned back into
flax layout, as the port's packed-tail generator feeds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.ops.pallas.packed_up import packed_up as j_packed_up
from advoc_tpu_torch.models.convert import to_torch_layout as _to_torch
from advoc_tpu_torch.ops.kernels import _build
from advoc_tpu_torch.ops.kernels import packed_up as tpu


def _inputs(b, h, w, cin, f, seed=0, zero_bias=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (0.1 * rng.standard_normal((4, 4, cin, f))).astype(np.float32)
    bias = np.zeros(f, np.float32) if zero_bias else (0.1 * rng.standard_normal(f)).astype(np.float32)
    return x, wt, bias


def _torch_flax_kernel(wt):
    """The converter's ConvTranspose weight (cin, f, 4, 4), flipped, turned
    back into flax layout as the generator does for B4."""
    weight = torch.tensor(np.ascontiguousarray(_to_torch(wt, "conv_transpose")))
    return weight.flip(2, 3).permute(2, 3, 0, 1)


# tests/test_pallas.py's shapes: (B, H, W, cin, f, tm, with_stats, zero bias).
CASES = [
    (2, 32, 16, 12, 8, 8, False, False),
    (2, 64, 16, 12, 8, 8, True, False),
    (1, 64, 8, 6, 4, 16, False, True),
    (1, 64, 8, 6, 4, 16, True, True),
]


@pytest.mark.parametrize("b,h,w,cin,f,tm,with_stats,zero_bias", CASES)
def test_plain_matches_jax_packed_up(b, h, w, cin, f, tm, with_stats, zero_bias):
    x, wt, bias = _inputs(b, h, w, cin, f, zero_bias=zero_bias)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = j_packed_up(xb, jnp.asarray(wt), jnp.asarray(bias), f=f, tm=tm,
                       with_stats=with_stats, interpret=True)
    wt_t = _torch_flax_kernel(wt)
    np.testing.assert_array_equal(wt_t.numpy(), wt)
    got = tpu.packed_up_plain(torch.tensor(x).to(torch.bfloat16), wt_t, torch.tensor(bias),
                              f=f, tm=tm, with_stats=with_stats)
    if not with_stats:
        want, got = (want,), (got,)
    y, yw = got[0], want[0]
    assert y.dtype == torch.bfloat16 and y.shape == (b, 2 * h, w, 2 * f)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yw, np.float32), atol=3e-2)
    for s, sw in zip(got[1:], want[1:]):
        assert s.dtype == torch.float32 and s.shape == (b, 2 * f)
        np.testing.assert_allclose(s.numpy(), np.asarray(sw), rtol=1e-4, atol=1e-3)


def test_plain_is_the_packed_conv_transpose():
    """In f32: packed[b, 2m+p, n, q·f+c] = ConvTranspose(x)[b, 2m+p, 2n+q, c]
    (torch's conv_transpose2d on the converter's flipped weight)."""
    b, h, w, cin, f = 2, 8, 6, 5, 3
    x, wt, bias = _inputs(b, h, w, cin, f, seed=1)
    weight = torch.tensor(np.ascontiguousarray(_to_torch(wt, "conv_transpose")))
    ref = torch.nn.functional.conv_transpose2d(
        torch.tensor(x).permute(0, 3, 1, 2), weight, torch.tensor(bias), stride=2, padding=1)
    want = ref.permute(0, 2, 3, 1).reshape(b, 2 * h, w, 2 * f)
    got, s1, s2 = tpu.packed_up_plain(torch.tensor(x), _torch_flax_kernel(wt), torch.tensor(bias),
                                      f=f, tm=4, with_stats=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(s1, want.sum(dim=(1, 2)), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, (want * want).sum(dim=(1, 2)), rtol=1e-5, atol=1e-5)


def test_class_weights_give_the_kernels_gemm():
    """The weights the CUDA kernel reads, (4, NP, 4·CP): each parity class as
    a GEMM over its four taps reproduces the transpose-conv (f32 emulation)."""
    b, h, w, cin, f = 1, 4, 5, 12, 8
    x, wt, _ = _inputs(b, h, w, cin, f, seed=2)
    wt = torch.tensor(wt).to(torch.bfloat16).float().numpy()  # the kernel reads bf16
    cp = 16
    wq = tpu._class_weights(torch.tensor(wt), f, cp).float()
    assert wq.shape == (4, 64, 4 * cp)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, cp - cin)))  # image padded by one
    got = np.zeros((b, 2 * h, w, 2 * f), np.float32)
    for p in (0, 1):
        for q in (0, 1):
            for m in range(h):
                # A row n: x[m+p-1+u, n+q-1+v, :] for taps (u, v), K = 4·CP.
                a = np.concatenate([xp[0, m + p + u, q + v : q + v + w] for u in (0, 1)
                                    for v in (0, 1)], axis=-1)
                got[0, 2 * m + p, :, q * f : (q + 1) * f] = a @ wq[2 * p + q, :f].numpy().T
    want = tpu.packed_up_plain(torch.tensor(x), torch.tensor(wt), torch.zeros(f), f=f, tm=2)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)


def test_cpu_tensor_takes_the_plain_version_in_bf16():
    x, wt, bias = _inputs(1, 16, 8, 8, 8, seed=3)
    before = _build.launches["packed_up"]
    args = (torch.tensor(wt), torch.tensor(bias))
    got = tpu.packed_up_kernel(torch.tensor(x), *args, f=8, tm=8, with_stats=True)
    want = tpu.packed_up_plain(torch.tensor(x).to(torch.bfloat16), *args, f=8, tm=8,
                               with_stats=True)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    assert got[0].dtype == torch.bfloat16
    assert _build.launches["packed_up"] == before


@pytest.mark.parametrize("kw,match", [
    (dict(tm=3), "multiple of tm"),
    (dict(f=4), "wt must be"),
])
def test_rejects_what_the_tpu_kernel_rejects(kw, match):
    x, wt, bias = _inputs(1, 16, 8, 8, 8)
    args = dict(f=8, tm=8) | kw
    with pytest.raises(ValueError, match=match):
        tpu.packed_up_kernel(torch.tensor(x), torch.tensor(wt), torch.tensor(bias), **args)


def _emulate_tensor_core_packed_up(x, wt, bias, f):
    """The CUDA kernel's tiles on the CPU: per class (p, q), half-resolution
    row m, 128-position tile n0 and 64-channel tile c0, y^T = W x^T summed
    over input rows u, 64-channel K boxes kc and column taps v. Each (u, kc)
    is one TMA box of x, 136 positions from (b, m+p-1+u, n0+q-1, 64 kc),
    zero outside (H, W, cin); tap v reads its rows v .. v + 127 against the
    class weights' (tap 2u+v, kc) tile (CP = cin rounded up to 64). bf16
    products summed in f32; then bf16(bf16(z) + bias), the store clipped to
    W and f, and Σy, Σy² over the stored values."""
    b, h, w, cin = x.shape
    cp, n_pad = -(-cin // 64) * 64, -(-f // 64) * 64
    wq = tpu._class_weights(torch.tensor(wt), f, cp).float().numpy()
    bias_p = np.pad(torch.tensor(bias).to(torch.bfloat16).float().numpy(), (0, n_pad - f))
    xb = torch.tensor(x).to(torch.bfloat16).float().numpy()

    def box(r, n_start, ci0):  # (B, 136 positions, 64 channels), zero fill outside
        out = np.zeros((b, 136, 64), np.float32)
        if 0 <= r < h:
            lo, hi = max(n_start, 0), min(n_start + 136, w)
            if lo < hi:
                blk = xb[:, r, lo:hi, ci0 : ci0 + 64]
                out[:, lo - n_start : hi - n_start, : blk.shape[-1]] = blk
        return out

    def bf16(a):
        return torch.tensor(a).to(torch.bfloat16).float().numpy()

    y = np.zeros((b, 2 * h, w, 2 * f), np.float32)
    for p in (0, 1):
        for q in (0, 1):
            for m in range(h):
                for n0 in range(0, w, 128):
                    for c0 in range(0, n_pad, 64):
                        zt = np.zeros((b, 64, 128), np.float32)  # (channels, positions)
                        for u in (0, 1):
                            for kc in range(cp // 64):
                                a = box(m + p - 1 + u, n0 + q - 1, 64 * kc)
                                for v in (0, 1):
                                    k0 = (2 * u + v) * cp + 64 * kc
                                    wtile = wq[2 * p + q, c0 : c0 + 64, k0 : k0 + 64]
                                    zt += wtile @ a[:, v : v + 128].transpose(0, 2, 1)
                        o = bf16(bf16(zt) + bias_p[c0 : c0 + 64, None]).transpose(0, 2, 1)
                        nn, cc = min(128, w - n0), min(64, f - c0)
                        y[:, 2 * m + p, n0 : n0 + nn, q * f + c0 : q * f + c0 + cc] = o[:, :nn, :cc]
    return y, y.sum(axis=(1, 2)), (y * y).sum(axis=(1, 2))


@pytest.mark.parametrize("w,cin,f", [(72, 24, 40), (72, 192, 64), (136, 64, 64)])
def test_tensor_core_operand_layout(w, cin, f):
    """The kernel's TMA boxes and CP-64 class weights rebuild y and Σ: held
    to the plain version and to JAX's packed_up in interpret mode. y within
    1e-2 × peak (bf16 results of f32 sums taken in other orders), Σy, Σy²
    within 1e-3 relative; W = 72 leaves a ragged position tile (and W = 136
    a second one), cin 24 a box that overhangs the channels, f 40 a ragged
    channel tile."""
    b, h, tm = 2, 8, 4
    x, wt, bias = _inputs(b, h, w, cin, f, seed=4)
    wt = (wt * np.sqrt(8 / cin)).astype(np.float32)  # unit-scale outputs at every cin
    y, s1, s2 = _emulate_tensor_core_packed_up(x, wt, bias, f)
    xb = torch.tensor(x).to(torch.bfloat16)
    plain = tpu.packed_up_plain(xb, torch.tensor(wt), torch.tensor(bias), f=f, tm=tm,
                                with_stats=True)
    jax_ = j_packed_up(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(bias), f=f,
                       tm=tm, with_stats=True, interpret=True)
    for want in ([t.float().numpy() for t in plain], [np.asarray(t, np.float32) for t in jax_]):
        peak = np.abs(want[0]).max()
        np.testing.assert_allclose(y, want[0], rtol=0, atol=1e-2 * peak)
        np.testing.assert_allclose(s1, want[1], rtol=1e-3, atol=1e-3 * np.abs(y).sum(axis=(1, 2)).max())
        np.testing.assert_allclose(s2, want[2], rtol=1e-3, atol=0)
