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
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.ops import spectral as tsp
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
    before = tfeat.fused_melspec_kernel.launches
    wav = torch.tensor(loader.synthetic_speech(4, 8 * HOP))
    got = tfeat.fused_melspec_kernel(wav, TP)
    torch.testing.assert_close(got, tfeat.fused_melspec_plain(wav, TP), rtol=0, atol=0)
    assert tfeat.fused_melspec_kernel.launches == before


def test_plain_matches_jax_stft_path():
    """Against the JAX package's default featurizer (its STFT path) on the
    first L//hop frames, within tests/test_pallas.py's 3e-3."""
    wav = loader.synthetic_speech(5, 64 * HOP)
    want = np.asarray(jsp.waveform_to_r9y9_melspec(jnp.asarray(wav), P))[:64]
    got = tfeat.fused_melspec_plain(torch.tensor(wav), TP).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)
