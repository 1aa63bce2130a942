"""Time-axis sharding of one long waveform, with a halo exchange.

The port of ``advoc_tpu.parallel.halo``. The waveform's time axis is split
over a mesh, each shard is featurized on its device, and the samples a
shard's boundary frames need from its neighbours cross to it: ``pad =
n_fft//2`` samples from the left neighbour and ``n_fft − hop − pad`` from
the right one (512 and 256 at n_fft 1024, hop 256), nothing else. Frame t
covers samples [t·hop − pad, t·hop − pad + n_fft), so a shard that owns
samples [s0, s0 + Lc) owns frames [s0/hop, (s0 + Lc)/hop). The global
edges reflect-pad, as the unsharded STFT does. The sharded STFT has L/hop
frames, one fewer than the unsharded one (its last frame is mostly
padding), as in the JAX package.
"""

from __future__ import annotations

import torch

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS, AudioParams
from advoc_tpu_torch.parallel.mesh import Mesh, shard_batch

Tensor = torch.Tensor


def _send(x: Tensor, device: torch.device) -> Tensor:
    """A halo's trip to the neighbouring shard's device: the only transfer
    between shards."""
    return x.to(device, non_blocking=True)


def sharded_stft_mag(wav, mesh: Mesh, params: AudioParams = DEFAULT_PARAMS) -> list[Tensor]:
    """|STFT| of a (..., L) waveform time-sharded over ``mesh``: a list of
    (..., L/(n·hop), n_freq) magnitudes, shard i's frames on
    ``mesh.devices[i]``; their concatenation has L/hop frames. ``wav`` is
    the whole waveform (split here, one contiguous slice a device) or the
    list of its shards, each already on its device. L must divide by
    n_devices·hop."""
    n, hop, n_fft = mesh.size, params.hop_length, params.n_fft
    shards = list(wav) if isinstance(wav, (list, tuple)) else shard_batch(wav, mesh, axis=-1)
    if len(shards) != n:
        raise ValueError(f"{len(shards)} shards for a mesh of {n}")
    lc = shards[0].shape[-1]
    if lc % hop or any(s.shape[-1] != lc for s in shards):
        raise ValueError(f"shards of {[s.shape[-1] for s in shards]} samples: each must be "
                         f"the same whole number of hops ({hop})")
    left_halo = n_fft // 2
    right_halo = n_fft - hop - left_halo
    if lc <= left_halo:
        raise ValueError(f"a shard of {lc} samples is too short for a {left_halo}-sample halo")
    out = []
    for i, (x, dev) in enumerate(zip(shards, mesh.devices, strict=True)):
        # The global edges reflect (excluding the edge sample), as F.pad's
        # "reflect" does; inner edges take the neighbour's samples.
        left = (x[..., 1 : left_halo + 1].flip(-1) if i == 0
                else _send(shards[i - 1][..., -left_halo:], dev))
        right = (x[..., -right_halo - 1 : -1].flip(-1) if i == n - 1
                 else _send(shards[i + 1][..., :right_halo], dev))
        xp = torch.cat([left, x, right], dim=-1)
        out.append(spectral.frame_local_stft_mag(xp, params, lc // hop))
    return out


def sharded_melspec(wav, mesh: Mesh, params: AudioParams = DEFAULT_PARAMS) -> list[Tensor]:
    """Time-sharded r9y9 mel extraction: (..., L) → a list of (..., L/(n·hop),
    n_mels) shards, as :func:`sharded_stft_mag` lays them out. The mel
    projection is per frame, so it needs no exchange of its own."""
    return [spectral.magspec_to_r9y9_melspec(m, params)
            for m in sharded_stft_mag(wav, mesh, params)]
