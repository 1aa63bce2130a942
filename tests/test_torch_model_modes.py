"""The generator's other modes against the flax generator, same weights.

The decoders (``upsample`` "subpixel", "resize") in bfloat16, subpixel's
identity with the transposed convolution, and the ``truncate_after``
profiling hook, the flax init converted by flax_to_torch_state_dict (each
decoder and an even ``head_kernel`` in float32, and ``fast_head`` with
"resize", are tests/test_torch_model.py's test_unported_modes_raise). Tolerances are tests/test_torch_model.py's:
float32 convolutions summed in another order, 2e-5 of [0, 1]; bfloat16,
where the two frameworks round in other places, 5e-2 at most and 5e-3 on
average. The hook's mean is a float32 sum over up to 2·32·256·8 values in
another order: 1e-5 relative. Each stage's mean is held to flax's own
intermediates (one capture_intermediates pass) and the hook itself to
flax's at the packed tail's last stage.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.models.advoc import model as jmodel
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator, flax_to_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite's workers
    share the cores), restored after it: set at import, the count would
    change every module's sums in each worker that collects this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(t_frames=32, **cfg):
    """(flax generator, its params, the converted port generator, an input)."""
    jcfg = jmodel.AdvocConfig(n_frames=t_frames, width=8, depth=3, **cfg)
    g = jmodel.AdvocGenerator(jcfg)
    params = jax.jit(g.init)(jax.random.PRNGKey(1), jnp.zeros((1, t_frames, 513)))["params"]
    x = np.random.default_rng(1).uniform(0, 1, (2, t_frames, 513)).astype(np.float32)
    tcfg = AdvocConfig(n_frames=t_frames, width=8, depth=3, **cfg)
    tg = AdvocGenerator(tcfg)
    tg.load_state_dict(flax_to_torch_state_dict(jax.tree.map(np.asarray, params), tcfg))
    return g, params, tg, x


def _pair(truncate_after=None, **cfg):
    g, params, tg, x = _models(**cfg)
    apply = jax.jit(functools.partial(g.apply, truncate_after=truncate_after))
    want = np.asarray(apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tg(torch.tensor(x), truncate_after=truncate_after).numpy()
    assert got.shape == want.shape
    return want, got


@pytest.mark.parametrize("upsample", ["subpixel", "resize"])
def test_decoder_bf16(upsample):
    """bfloat16, the default dtype: subpixel's explicitly padded k2 conv and
    resize's SAME conv (pixelshuffle shares resize's; each decoder's float32
    function is tests/test_torch_model.py's test_unported_modes_raise)."""
    want, got = _pair(upsample=upsample, dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=5e-2)
    assert np.abs(got - want).mean() < 5e-3


def test_subpixel_is_the_transposed_convolution():
    """subpixel computes exactly the convtranspose map: the k2 kernel
    K[u, v, ci, (p, q, c)] = w_t[2u + p, 2v + q, ci, c] (the JAX docstring)
    gives the default decoder's output on the same transposed kernel."""
    cfg = AdvocConfig(n_frames=32, width=8, depth=3, dtype="float32")
    g = AdvocGenerator(cfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    gs = AdvocGenerator(AdvocConfig(n_frames=32, width=8, depth=3, dtype="float32",
                                    upsample="subpixel"))
    sd = g.state_dict()
    for i, up in enumerate(g.ups):
        wt = up.conv.weight.detach().flip(2, 3).permute(2, 3, 0, 1)  # flax (4, 4, cin, f)
        cin, f = wt.shape[2], wt.shape[3]
        k = wt.reshape(2, 2, 2, 2, cin, f).permute(0, 2, 4, 1, 3, 5)  # (u, v, ci, p, q, c)
        sd[f"ups.{i}.conv.weight"] = k.reshape(2, 2, cin, 4 * f).permute(3, 2, 0, 1)
        sd[f"ups.{i}.conv.bias"] = up.conv.bias.detach().repeat(4)
    gs.load_state_dict(sd)
    x = torch.tensor(np.random.default_rng(2).uniform(0, 1, (2, 32, 513)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(gs(x), g(x), rtol=0, atol=2e-5)


def test_truncate_after_every_stage():
    """Each stage's mean in float32 against flax's intermediates (the
    bottleneck's after its ReLU, as the hook cuts it); an unknown name runs
    the whole generator, as in flax."""
    g, params, tg, x = _models(dtype="float32")
    whole, state = jax.jit(functools.partial(
        g.apply, capture_intermediates=True, mutable=["intermediates"]))(
            {"params": params}, jnp.asarray(x))
    inter = state["intermediates"]
    want = {name: float(jnp.mean(inter[name]["__call__"][0])) for name in
            ("down0", "down1", "down2", "up0", "up1", "up2")}
    want["bottleneck"] = float(jnp.mean(jax.nn.relu(inter["bottleneck"]["__call__"][0])))
    with torch.no_grad():
        for stage, v in want.items():
            got = tg(torch.tensor(x), truncate_after=stage)
            assert got.shape == () and got.dtype == torch.float32
            np.testing.assert_allclose(float(got), v, rtol=1e-5)
        got = tg(torch.tensor(x), truncate_after="nowhere").numpy()
    np.testing.assert_allclose(got, np.asarray(whole), atol=2e-5)


def test_truncate_after_under_the_packed_tail():
    """The hook itself against flax's, at the packed finest level."""
    want, got = _pair(dtype="float32", packed_tail=True, truncate_after="up2")
    assert got.shape == ()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_unknown_upsample_raises():
    with pytest.raises(ValueError, match="upsample"):
        AdvocGenerator(AdvocConfig(upsample="bicubic"))
