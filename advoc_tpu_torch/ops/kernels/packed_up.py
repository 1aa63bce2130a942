"""Packed-tail transpose-conv: a CUDA kernel and its plain version.

Replaces ``advoc_tpu/ops/pallas/packed_up.py:packed_up`` (B4), the finest
U-Net decoder level of ``AdvocConfig(packed_tail=True)``: the k4/s2
ConvTranspose computed straight into the packed layout (B, 2H, W, 2f), in
which lane q·f + c of row 2m + p holds output pixel (2m + p, 2n + q),
channel c, so the planar transpose-conv output never exists. It adds the
bias in bf16 and, on request, returns the per-(batch, lane) Σy and Σy²
(f32, of the bf16 output) that GroupNorm needs.

Design on Hopper (``csrc/packed_up.cu``): each CTA owns one parity class
(p, q) and computes it as a GEMM with the minimum work (K = 4 taps × cin)
on the tensor cores with ``wgmma`` (bf16 operands, f32 accumulation),
transposed (y^T = W x^T) so that the instruction's N is 128 positions. The
class's weights, K-major and padded to CP = cin rounded up to 64, are loaded
once by TMA and stay in shared memory; each input row is one TMA load of a
(136 positions, 64 channels) box of ``x`` that serves both column taps,
and its zero fill gives the image border. Two consumer warpgroups, each
with its own producer warp, split the CTA's rows, and each output tile
leaves through a TMA store. The TPU kernel carries the norm sums across
grid steps in a revisited VMEM block; Hopper CTAs run in no order, so each
CTA writes partials and a second small launch reduces them in a fixed
order (no float atomics: the same result on every run). The kernel takes
cin ≤ 256: up to 192 (the widest finest level of the documented configs)
with two x stages per warpgroup, above that with one.

Bound: at the full-width finest level (B=128, H=W=128, cin 192 = 128
channels from the level below + 64 of skip, f 64) the work is
4 taps · cin · 2 = 1536 FLOP per output element, ≈ 825 GFLOP, and the bytes
≈ 1.88 GB (x 805 MB read, y 1.07 GB written): ≈ 0.83 ms at the H100's
989 TFLOP/s dense bf16 rate against ≈ 0.56 ms at 3.35 TB/s, bound by
operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from advoc_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor


def _check(x: Tensor, wt: Tensor, bias: Tensor, f: int, tm: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, cin), got {tuple(x.shape)}")
    cin, h = x.shape[3], x.shape[1]
    if tuple(wt.shape) != (4, 4, cin, f) or tuple(bias.shape) != (f,):
        raise ValueError(
            f"wt must be (4, 4, {cin}, {f}) and bias ({f},), got "
            f"{tuple(wt.shape)} and {tuple(bias.shape)}"
        )
    if tm < 1 or (h // 2) % tm:
        raise ValueError(f"(H // 2) = {h // 2} must be a multiple of tm = {tm}")


def _k3_taps(wt: Tensor, f: int) -> Tensor:
    """The K3 tap map of ``packed_up.py``: (4, 4, cin, f) flax ConvTranspose
    kernel → (2, 3, cin, 4f), z[i, n, (2p+q)f + c] = Σ_{u,vv} xp[i+u, n+vv]
    · K3[u, vv]. q=0 takes window columns {n−1, n} → taps {0, 1}, q=1 takes
    {n, n+1} → taps {1, 2}; the other taps are zero."""
    cin = wt.shape[2]
    w4 = wt.reshape(2, 2, 2, 2, cin, f)  # [u, p, v, q, ci, c]
    k3 = wt.new_zeros((2, 3, cin, 4 * f))
    for p in (0, 1):
        for q in (0, 1):
            blk = slice((2 * p + q) * f, (2 * p + q + 1) * f)
            k3[:, q, :, blk] = w4[:, p, 0, q]
            k3[:, 1 + q, :, blk] = w4[:, p, 1, q]
    return k3


def packed_up_plain(
    x: Tensor, wt: Tensor, bias: Tensor, *, f: int, tm: int = 16, with_stats: bool = False
):
    """The kernel's function in plain PyTorch, in ``x``'s dtype.

    The K3 form of the JAX XLA branch (``model.py:_PackedTailUp``): one
    (2, 3) convolution over the input padded by one, the bias added in the
    compute dtype, then row parity p takes z rows [p, p + H) and lanes
    [2pf, 2(p+1)f), interleaved on the row axis. With ``with_stats`` also
    Σy and Σy² per (batch, lane), reduced in f32 from the output. The CPU
    path of :func:`packed_up_kernel` and the reference the kernel is held
    to (called with bf16 ``x``).
    """
    _check(x, wt, bias, f, tm)
    dt = x.dtype
    b, h, w, _ = x.shape
    k3 = _k3_taps(wt, f).permute(3, 2, 0, 1).to(dt)  # (4f, cin, 2, 3)
    z = F.conv2d(x.permute(0, 3, 1, 2), k3, padding=1)  # (B, 4f, H+1, W)
    z = (z + bias.to(dt).repeat(4)[None, :, None, None]).permute(0, 2, 3, 1)
    rows = [z[:, p : p + h, :, 2 * p * f : 2 * (p + 1) * f] for p in (0, 1)]
    y = torch.stack(rows, dim=2).reshape(b, 2 * h, w, 2 * f)
    if not with_stats:
        return y
    yf = y.to(torch.float32)
    return y, yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))


def _class_weights(wt: Tensor, f: int, cp: int) -> Tensor:
    """(4, 4, cin, f) → (4, NP, 4·cp) bf16: per parity class p·2 + q, row c,
    column (2u + v)·cp + ci holds wt[2u+p, 2v+q, ci, c]; zero-padded to cp
    input and NP = ⌈f/64⌉·64 output channels. The kernel's weight tile
    (tap, kc) is the 64 × 64 box at row c0, column tap·cp + 64·kc."""
    cin = wt.shape[2]
    npad = -(-f // 64) * 64
    w6 = wt.reshape(2, 2, 2, 2, cin, f).permute(1, 3, 5, 0, 2, 4)  # [p, q, c, u, v, ci]
    w6 = F.pad(w6, (0, cp - cin, 0, 0, 0, 0, 0, npad - f))
    return w6.reshape(4, npad, 4 * cp).to(torch.bfloat16).contiguous()


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_up")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.packed_up.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.packed_up.restype = i
    return lib


def packed_up_kernel(
    x: Tensor, wt: Tensor, bias: Tensor, *, f: int, tm: int = 16, with_stats: bool = False
):
    """Fused k4/s2 transpose-conv → packed (B, 2H, W, 2f) bf16 (+ Σy, Σy²).

    x (B, H, W, cin) bf16, wt (4, 4, cin, f) in flax layout, bias (f,);
    the JAX ``packed_up`` signature. On a CUDA tensor: the CUDA kernel, one
    call on x's device and its current stream (the conv launch and, with ``with_stats``,
    the partials' reduction), counted in ``packed_up_kernel.launches``; it
    raises on a tensor the kernel does not take or a failed launch. On a
    CPU tensor: the plain version in bf16, :func:`packed_up_plain`.
    """
    _check(x, wt, bias, f, tm)
    if not x.is_cuda:
        return packed_up_plain(x.to(torch.bfloat16), wt, bias, f=f, tm=tm,
                               with_stats=with_stats)
    b, h, w, cin = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("packed_up_kernel needs a contiguous bfloat16 x")
    if cin % 8 or f % 8 or h % tm:
        raise ValueError(
            f"packed_up_kernel needs cin % 8 == 0, f % 8 == 0 and H % tm == 0 "
            f"(cin {cin}, f {f}, H {h}, tm {tm})"
        )
    cp = -(-cin // 64) * 64  # whole 128-byte K boxes
    lib = _lib()
    dev = x.device
    wq = _class_weights(wt.to(dev), f, cp)
    bias_p = F.pad(bias.to(dev, torch.bfloat16), (0, wq.shape[1] - f)).contiguous()
    y = torch.empty((b, 2 * h, w, 2 * f), dtype=torch.bfloat16, device=dev)
    stats = [None] * 4  # partials p1, p2 (B, n_part, 2f) and sums s1, s2 (B, 2f)
    if with_stats:
        n_part = (h // tm) * -(-w // 128) * 2
        stats = [*torch.empty((2, b, n_part, 2 * f), dtype=torch.float32, device=dev),
                 *torch.empty((2, b, 2 * f), dtype=torch.float32, device=dev)]
    with torch.cuda.device(dev):  # the launcher launches on the current device
        code = lib.packed_up(
            x.data_ptr(), wq.data_ptr(), bias_p.data_ptr(), y.data_ptr(),
            *(None if t is None else t.data_ptr() for t in stats), b, h, w, cin, cp, f, tm,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "packed_up")
    packed_up_kernel.launches += 1
    return (y, stats[2], stats[3]) if with_stats else y


packed_up_kernel.launches = 0
