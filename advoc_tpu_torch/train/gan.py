"""GAN losses and the fused advoc train and eval steps, in PyTorch.

The port of ``advoc_tpu.train.gan`` for the advoc family. One train step
runs, in the JAX step's order: featurize the waveform batch (STFT → |X| →
mel → pinv estimate, under ``no_grad``), the generator's fake (detached),
the discriminator's loss on (condition, real) and (condition, fake) plus
the gradient penalty under wgan-gp, one Adam step of D, then the
generator's loss (adversarial + ``l1_weight`` · L1) scored by the
**updated** D, and one Adam step of G. Gradients are taken with
``torch.autograd.grad`` on each model's own parameters, so the G step
never writes a gradient into D. The step runs eagerly; its convolutions,
forward and backward, are cuDNN's (the JAX step ran them as XLA ops, never
Pallas).

The WaveGAN, conditional-WaveGAN and MelSpecGAN steps
(:func:`make_wavegan_train_step`, :func:`make_cond_wavegan_train_step`,
:func:`make_melspecgan_train_step`) run the JAX steps' updates in their
order: the critics' D updates, each against the same G parameters, then
one G update scored by the updated D.

A :class:`TrainState` is the counterpart of flax's: the module (which
holds the parameters), its optimizer and the step count. Randomness (the
latents z, the wgan-gp interpolation weights ε, the phase-shuffle shifts)
comes from an explicit ``torch.Generator`` where JAX splits a
``PRNGKey``; a step's draws can also be passed in whole (``draws=``), so
a test can give it JAX's. ``jit_data_parallel`` is not ported yet
(ROADMAP.md queue A item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from advoc_tpu_torch.ops import spectral
from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS, AudioParams

Tensor = torch.Tensor

# ln(256): the μ-law expansion constant. The encode half lives in
# data.loader._MULAW_LN256; the two must stay equal.
_MULAW_LN256 = math.log(256.0)

# Optimizer settings that choose an implementation, not the update.
_IMPL_FLAGS = ("fused", "foreach", "capturable", "differentiable")


@dataclasses.dataclass
class TrainState:
    """A module, its optimizer and the number of updates applied."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0

    @property
    def params(self) -> list[nn.Parameter]:
        return list(self.model.parameters())

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self, grads) -> None:
        """One optimizer step with ``grads`` (one per parameter, in order)."""
        for p, g in zip(self.params, grads, strict=True):
            # Fused Adam takes each gradient in its parameter's layout; cuDNN
            # may return a weight's gradient in another (channels-last).
            p.grad = g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(), "opt": self.opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Load a :meth:`state_dict`. The optimizer keeps its own
        implementation flags (fused on a CUDA device, not on the CPU), so a
        state saved on one device resumes on another."""
        self.model.load_state_dict(state["params"])
        opt = dict(state["opt"])
        opt["param_groups"] = [
            {**saved, **{k: cur[k] for k in _IMPL_FLAGS if k in cur}}
            for saved, cur in zip(opt["param_groups"], self.opt.param_groups, strict=True)
        ]
        self.opt.load_state_dict(opt)
        self.step = int(state["step"])


class GanLosses(NamedTuple):
    d_loss: Callable[[Tensor, Tensor], Tensor]  # (real_logits, fake_logits) → scalar
    g_loss: Callable[[Tensor], Tensor]  # (fake_logits) → scalar
    needs_gp: bool


def gan_losses(gan_type: str) -> GanLosses:
    """dcgan (sigmoid cross-entropy, non-saturating G), lsgan or wgan-gp."""
    if gan_type == "dcgan":
        def d(real, fake):
            return (F.binary_cross_entropy_with_logits(real, torch.ones_like(real))
                    + F.binary_cross_entropy_with_logits(fake, torch.zeros_like(fake)))

        def g(fake):
            return F.binary_cross_entropy_with_logits(fake, torch.ones_like(fake))

        return GanLosses(d, g, False)
    if gan_type == "lsgan":
        def d(real, fake):
            return 0.5 * (torch.mean((real - 1.0) ** 2) + torch.mean(fake**2))

        def g(fake):
            return 0.5 * torch.mean((fake - 1.0) ** 2)

        return GanLosses(d, g, False)
    if gan_type == "wgan-gp":
        def d(real, fake):
            return torch.mean(fake) - torch.mean(real)

        def g(fake):
            return -torch.mean(fake)

        return GanLosses(d, g, True)
    raise ValueError(f"unknown gan_type {gan_type!r}")


def gradient_penalty(
    d_fn: Callable[[Tensor], Tensor],
    real: Tensor,
    fake: Tensor,
    eps: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tensor:
    """WGAN-GP penalty on interpolates ε·real + (1 − ε)·fake, one ε per row:
    mean((‖∇ₓ Σ d_fn(x)‖ − 1)²), differentiable in d_fn's parameters. ε is
    ``eps`` (shape (B, 1, …)) or drawn uniform from ``generator``."""
    if eps is None:
        if generator is None:
            raise ValueError("gradient_penalty needs eps or a generator")
        eps = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1), generator=generator,
                         device=real.device, dtype=real.dtype)
    interp = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2, dim=-1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def as_waveform(batch: Tensor) -> Tensor:
    """A loader batch as a float32 waveform: int8 is μ-law (expanded, |y|
    clamped to 1), other integers carry round(x·32768), floats pass."""
    if batch.dtype == torch.int8:
        y = torch.clamp(batch.to(torch.float32) * (1.0 / 127.0), -1.0, 1.0)
        return torch.sign(y) * (torch.expm1(torch.abs(y) * _MULAW_LN256) / 255.0)
    if not batch.is_floating_point():
        return batch.to(torch.float32) * (1.0 / 32768.0)
    return batch.to(torch.float32)


@torch.no_grad()
def featurize_advoc(
    wav: Tensor, n_frames: int, params: AudioParams = DEFAULT_PARAMS
) -> tuple[Tensor, Tensor, Tensor]:
    """Waveform batch (B, L) → (mel, est_norm, mag_norm), each (B, n_frames, ·)
    in the [0, 1] normalized-dB domain, through the STFT path: mag_norm is
    the target, est_norm the pinv estimate of the mel."""
    wav = as_waveform(wav)
    mag = spectral.waveform_to_magspec(wav, params)[:, :n_frames, :]
    mag_norm = spectral.normalize_db(spectral.amp_to_db(mag, params) - params.ref_level_db, params)
    mel = spectral.magspec_to_r9y9_melspec(mag, params)
    est = spectral.r9y9_melspec_to_magspec(mel, params)
    est_norm = spectral.normalize_db(spectral.amp_to_db(est, params) - params.ref_level_db, params)
    return mel, est_norm, mag_norm


def make_advoc_train_step(g_model: nn.Module, d_model: nn.Module, cfg,
                          audio_params: AudioParams = DEFAULT_PARAMS):
    """The fused step ``(gstate, dstate, wav, generator) → (gstate, dstate,
    metrics)`` of these two models, for the states :func:`make_states`
    wraps them in (the modules hold the parameters the states update).

    The states are updated in place and returned. ``metrics`` holds
    ``d_loss``, ``g_loss``, ``g_adv``, ``g_l1``, ``d_real_logit`` and
    ``d_fake_logit`` as 0-d tensors on the device. ``generator`` draws the
    wgan-gp ε (other losses draw nothing). Refuses ``packed_tail`` on a CUDA
    device: its kernel has no backward.
    """
    if (cfg.packed_tail and not cfg.fast_head
            and next(g_model.parameters()).device.type == "cuda"):
        raise NotImplementedError(
            "packed_tail=True cannot train on a CUDA device: kernel B4 has no backward "
            "(the JAX Pallas kernel has no custom_vjp); train with packed_tail=False")
    losses = gan_losses(cfg.gan_type)

    def step(gstate: TrainState, dstate: TrainState, wav: Tensor,
             generator: torch.Generator | None = None):
        g, d = g_model, d_model
        mel, est, real = featurize_advoc(wav, cfg.n_frames, audio_params)
        cond = est if cfg.condition_on == "estimate" else mel

        # D update (G frozen).
        with torch.no_grad():
            fake = g(est)
        real_logits, fake_logits = d(cond, real), d(cond, fake)
        d_loss = losses.d_loss(real_logits, fake_logits)
        if losses.needs_gp:
            d_loss = d_loss + cfg.gp_weight * gradient_penalty(
                lambda x: d(cond, x), real, fake, generator=generator)
        dstate.apply_gradients(torch.autograd.grad(d_loss, dstate.params))

        # G update, scored by the updated D; no gradient reaches D.
        fake2 = g(est)
        adv = losses.g_loss(d(cond, fake2))
        l1 = torch.mean(torch.abs(fake2 - real))
        g_loss = adv + cfg.l1_weight * l1
        gstate.apply_gradients(torch.autograd.grad(g_loss, gstate.params))

        metrics = {
            "d_loss": d_loss, "g_loss": g_loss, "g_adv": adv, "g_l1": l1,
            "d_real_logit": real_logits.mean(), "d_fake_logit": fake_logits.mean(),
        }
        return gstate, dstate, {k: v.detach() for k, v in metrics.items()}

    return step


def make_advoc_eval_step(cfg, audio_params: AudioParams = DEFAULT_PARAMS):
    """``(generator, wav) → metrics``: the spectrogram L1 of the repaired and
    of the heuristic magnitude against the real one."""

    @torch.no_grad()
    def step(generator: nn.Module, wav: Tensor) -> dict[str, Tensor]:
        mel, est, real = featurize_advoc(wav, cfg.n_frames, audio_params)
        fake = generator(est)
        return {
            "eval_l1_repaired": torch.mean(torch.abs(fake - real)),
            "eval_l1_heuristic": torch.mean(torch.abs(est - real)),
        }

    return step


def latents(n: int, latent_dim: int, seed: int, device=None) -> Tensor:
    """(n, latent_dim) standard normal latents from a ``torch.Generator``
    seeded ``seed`` on ``device``: the CLIs' repeatable samples."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, latent_dim), generator=generator, device=device)


def _critic_loss(losses: GanLosses, cfg, d_fn, real: Tensor, fake: Tensor,
                 eps: Tensor | None) -> Tensor:
    """The D loss of ``d_fn`` (input → logits) on a real and a fake batch,
    plus the gradient penalty at ``eps`` under wgan-gp."""
    loss = losses.d_loss(d_fn(real), d_fn(fake))
    if losses.needs_gp:
        loss = loss + cfg.gp_weight * gradient_penalty(d_fn, real, fake, eps=eps)
    return loss


def _draws(generator, device, gp: bool, n_d: int, batch: int, like: Tensor,
           latent: int | None = None, d_model: nn.Module | None = None) -> dict[str, Tensor]:
    """A step's random draws: ``z`` (n_d + 1, batch, latent) normal (one per
    D update and one for G), ``eps`` (n_d, batch, 1, …) uniform shaped to
    broadcast over ``like`` (under wgan-gp), ``shifts`` (n_d + 1,
    n_shuffled, batch) for ``d_model``'s phase shuffle."""
    out = {}
    if latent is not None:
        out["z"] = torch.randn((n_d + 1, batch, latent), generator=generator, device=device)
    if gp:
        out["eps"] = torch.rand((n_d, batch) + (1,) * (like.ndim - 1), generator=generator,
                                device=device)
    if d_model is not None:
        out["shifts"] = torch.stack([d_model.draw_shifts(batch, generator, device)
                                     for _ in range(n_d + 1)])
    return out


def make_wavegan_train_step(g_model: nn.Module, d_model: nn.Module, cfg):
    """The WaveGAN step ``(gstate, dstate, wav, generator=None, draws=None)
    → (gstate, dstate, metrics)``, the JAX package's: ``wav`` (n_critic, B,
    T), any loader dtype; for each critic i, one D update on (wav[i], G(z_i))
    against the same G parameters, the real, fake and gradient-penalty
    passes sharing one set of phase-shuffle shifts; then one G update scored
    by the updated D with its own z and shifts. ``draws`` (else drawn from
    ``generator``): ``z`` (n_critic + 1, B, latent), ``eps`` (n_critic, B, 1)
    under wgan-gp, ``shifts`` (n_critic + 1, n_shuffled, B), the last of each
    for G. ``metrics``: ``d_loss`` (the critics' mean) and ``g_loss``."""
    losses = gan_losses(cfg.gan_type)

    def step(gstate: TrainState, dstate: TrainState, wav: Tensor,
             generator: torch.Generator | None = None, draws: dict | None = None):
        if wav.ndim != 3:
            raise ValueError(f"the wavegan step wants (n_critic, B, T), got {tuple(wav.shape)}")
        g, d = g_model, d_model
        wav = as_waveform(wav)
        n, b = wav.shape[:2]
        if draws is None:
            draws = _draws(generator, wav.device, losses.needs_gp, n, b, wav[0],
                           cfg.latent_dim, d)
        d_losses = []
        for i in range(n):
            with torch.no_grad():
                fake = g(draws["z"][i])
            shifts = draws["shifts"][i]
            d_loss = _critic_loss(losses, cfg, lambda x: d(x, shifts), wav[i], fake,
                                  draws["eps"][i] if losses.needs_gp else None)
            dstate.apply_gradients(torch.autograd.grad(d_loss, dstate.params))
            d_losses.append(d_loss.detach())
        g_loss = losses.g_loss(d(g(draws["z"][n]), draws["shifts"][n]))
        gstate.apply_gradients(torch.autograd.grad(g_loss, gstate.params))
        return gstate, dstate, {"d_loss": torch.stack(d_losses).mean(), "g_loss": g_loss.detach()}

    return step


def make_cond_wavegan_train_step(g_model: nn.Module, d_model: nn.Module, cfg,
                                 audio_params: AudioParams = DEFAULT_PARAMS):
    """The conditional-WaveGAN step ``(gstate, dstate, wav, generator=None,
    draws=None) → (gstate, dstate, metrics)``, the JAX package's: mels of
    the real ``wav`` (B, L ≥ slice_len) by the STFT path (``impl="xla"``,
    T = 1 + L//hop, cut to n_frames); one D update on (real, mel) and
    (G(mel), mel) pairs; one G update on the adversarial loss scored by the
    updated D plus ``mel_l1_weight`` · the L1 of the mel re-extracted from
    G's waveform, its gradient taken through the featurizer. ``draws``:
    ``eps`` (1, B, 1) under wgan-gp, ``shifts`` (2, n_shuffled, B), D's then
    G's. ``metrics``: ``d_loss``, ``g_loss``, ``g_adv``, ``g_mel_l1``."""
    losses = gan_losses(cfg.gan_type)

    def featurize(x: Tensor) -> Tensor:
        return spectral.waveform_to_r9y9_melspec(x, audio_params, impl="xla")[:, : cfg.n_frames]

    def step(gstate: TrainState, dstate: TrainState, wav: Tensor,
             generator: torch.Generator | None = None, draws: dict | None = None):
        g, d = g_model, d_model
        wav = as_waveform(wav)
        with torch.no_grad():
            mel = featurize(wav)
            fake = g(mel)
        real = wav[:, : cfg.slice_len]
        if draws is None:
            draws = _draws(generator, wav.device, losses.needs_gp, 1, wav.shape[0], real,
                           d_model=d)
        shifts = draws["shifts"][0]
        d_loss = _critic_loss(losses, cfg, lambda x: d(x, mel, shifts), real, fake,
                              draws["eps"][0] if losses.needs_gp else None)
        dstate.apply_gradients(torch.autograd.grad(d_loss, dstate.params))

        fake2 = g(mel)
        adv = losses.g_loss(d(fake2, mel, draws["shifts"][1]))
        mel_l1 = torch.mean(torch.abs(featurize(fake2) - mel))
        g_loss = adv + cfg.mel_l1_weight * mel_l1
        gstate.apply_gradients(torch.autograd.grad(g_loss, gstate.params))
        metrics = {"d_loss": d_loss, "g_loss": g_loss, "g_adv": adv, "g_mel_l1": mel_l1}
        return gstate, dstate, {k: v.detach() for k, v in metrics.items()}

    return step


def make_melspecgan_train_step(g_model: nn.Module, d_model: nn.Module, cfg,
                               audio_params: AudioParams = DEFAULT_PARAMS):
    """The MelSpecGAN step ``(gstate, dstate, wav, generator=None,
    draws=None) → (gstate, dstate, metrics)``, the JAX package's: ``wav``
    (n_critic, B, L) featurized at once to mels by the STFT path (cut to
    n_frames), then for each critic one D update on (mel[i], G(z_i))
    against the same G parameters, then one G update scored by the updated
    D. ``draws``: ``z`` (n_critic + 1, B, latent), ``eps`` (n_critic, B, 1,
    1) under wgan-gp. ``metrics``: ``d_loss`` (the critics' mean), ``g_loss``."""
    losses = gan_losses(cfg.gan_type)

    def step(gstate: TrainState, dstate: TrainState, wav: Tensor,
             generator: torch.Generator | None = None, draws: dict | None = None):
        if wav.ndim != 3:
            raise ValueError(f"the melspecgan step wants (n_critic, B, L), got {tuple(wav.shape)}")
        g, d = g_model, d_model
        with torch.no_grad():
            mel = spectral.waveform_to_r9y9_melspec(as_waveform(wav), audio_params,
                                                    impl="xla")[..., : cfg.n_frames, :]
        n, b = mel.shape[:2]
        if draws is None:
            draws = _draws(generator, mel.device, losses.needs_gp, n, b, mel[0], cfg.latent_dim)
        d_losses = []
        for i in range(n):
            with torch.no_grad():
                fake = g(draws["z"][i])
            d_loss = _critic_loss(losses, cfg, d, mel[i], fake,
                                  draws["eps"][i] if losses.needs_gp else None)
            dstate.apply_gradients(torch.autograd.grad(d_loss, dstate.params))
            d_losses.append(d_loss.detach())
        g_loss = losses.g_loss(d(g(draws["z"][n])))
        gstate.apply_gradients(torch.autograd.grad(g_loss, gstate.params))
        return gstate, dstate, {"d_loss": torch.stack(d_losses).mean(), "g_loss": g_loss.detach()}

    return step


def adam(lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999):
    """pix2pix-style Adam: a factory ``params → torch.optim.Adam(params, lr,
    (b1, b2), eps=1e-8)``, optax's ``adam`` (ε outside the square root, both
    moments bias-corrected), fused into one launch on a CUDA device."""

    def make(params) -> torch.optim.Optimizer:
        params = list(params)
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                                fused=params[0].device.type == "cuda")

    return make


def make_states(g_model: nn.Module, d_model: nn.Module, seed: int = 0,
                g_tx=None, d_tx=None) -> tuple[TrainState, TrainState]:
    """Initialize both models with flax's initializers from ``seed`` (the
    generator's weights first, then the discriminator's, from one CPU
    ``torch.Generator``, so the weights are the same on every device) and
    wrap each with its optimizer (default :func:`adam`)."""
    rng = torch.Generator().manual_seed(seed)
    g_model.reset_parameters(rng)
    d_model.reset_parameters(rng)
    return (TrainState(g_model, (g_tx or adam())(g_model.parameters())),
            TrainState(d_model, (d_tx or adam())(d_model.parameters())))
