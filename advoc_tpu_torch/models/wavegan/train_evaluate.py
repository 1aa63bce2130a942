"""WaveGAN train/eval/infer CLI of the port.

  python -m advoc_tpu_torch.models.wavegan.train_evaluate --mode train \\
      --train_dir runs/wavegan --data_dir /path/to/wavs

  python -m advoc_tpu_torch.models.wavegan.train_evaluate --mode eval \\
      --train_dir runs/wavegan --data_dir ... [--eval_once]

  python -m advoc_tpu_torch.models.wavegan.train_evaluate --mode infer \\
      --train_dir runs/wavegan --n_samples 8 --infer_dir out/

The end-to-end waveform GAN, z → waveform with no phase recovery; infer
samples latents and writes wavs. ``--conditional`` takes the mel-conditioned
variant (a neural mel → waveform vocoder): training extracts the mels on the
device and infer vocodes ``--infer_input`` (a wav or a .npy of mels) in
n_frames chunks. The argparse surface of
``advoc_tpu.models.wavegan.train_evaluate`` plus ``--device`` (default cuda;
``--device cpu`` runs on the CPU). Without ``--data_dir`` a synthetic fixture
set is written into the train_dir. Latents come from ``torch.Generator``\\ s
seeded from ``--seed`` (infer) or fixed seeds (eval), so samples are
repeatable but are not the JAX CLI's. Training is single-process on one
device: ``--n_devices`` > 1 and multi-process runs raise (ROADMAP.md queue A
item 4, DDP).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["train", "eval", "infer"], required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--data_dir", default=None, help="directory of wavs or a .txt file list")
    p.add_argument("--model_overrides", default=None,
                   help="comma-separated key=value config overrides")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel device count: only 1 is ported (ROADMAP.md queue A)")
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--eval_once", action="store_true")
    p.add_argument("--conditional", action="store_true",
                   help="mel-conditioned variant (neural mel→waveform)")
    p.add_argument("--infer_input", default=None,
                   help="conditional infer: wav to re-vocode or .npy mels")
    p.add_argument("--infer_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--h2d_dtype", choices=["int16", "float32", "mulaw8"], default="int16",
                   help="wire dtype of train batches; int16 halves the host-to-device "
                        "bytes, the step normalizes on device")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): the first NaN of a "
                        "backward names its op (slow, for debugging)")
    p.add_argument("--d_lr", type=float, default=None,
                   help="discriminator learning rate of the conditional variant (default "
                        "2e-4, G's; a lower one stabilizes an overpowered D)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def make_config(args):
    from advoc_tpu_torch.models.wavegan import CondWaveGANConfig, WaveGANConfig
    from advoc_tpu_torch.utils import apply_overrides

    base = CondWaveGANConfig() if args.conditional else WaveGANConfig()
    return apply_overrides(base, args.model_overrides)


def _models_and_states(cfg, seed: int, device, conditional: bool, d_lr: float | None = None):
    """The JAX CLI's models and Adams: (1e-4, 0.5, 0.9) for both WaveGAN
    nets; 2e-4 for the conditional G and ``d_lr`` (default 2e-4) for its D."""
    from advoc_tpu_torch.models import wavegan
    from advoc_tpu_torch.train import gan

    if conditional:
        g = wavegan.CondWaveGANGenerator(cfg).to(device)
        d = wavegan.CondWaveGANDiscriminator(cfg).to(device)
        g_tx, d_tx = gan.adam(2e-4), gan.adam(d_lr or 2e-4)
    else:
        g = wavegan.WaveGANGenerator(cfg).to(device)
        d = wavegan.WaveGANDiscriminator(cfg).to(device)
        g_tx = d_tx = gan.adam(1e-4, 0.5, 0.9)
    gstate, dstate = gan.make_states(g, d, seed=seed, g_tx=g_tx, d_tx=d_tx)
    return g, d, gstate, dstate


def train(args):
    """Returns the train loop's (gstate, dstate, final_step)."""
    from advoc_tpu_torch.data import loader
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan, harness
    from advoc_tpu_torch.utils import ensure_dataset

    dev = harness.train_device(args.device, args.n_devices)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = make_config(args)
    fps = ensure_dataset(args.data_dir, f"{args.train_dir}/synthetic_data")
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev, args.conditional, args.d_lr)
    if args.conditional:
        print(f"[train] conditional wavegan (mel→waveform) on {dev}", flush=True)
        step = gan.make_cond_wavegan_train_step(g, d, cfg, P)
        it = loader.decode_extract_and_batch(
            fps, batch_size=args.batch_size, slice_len=cfg.slice_len, seed=args.seed,
            sample_rate=P.sample_rate, out_dtype=args.h2d_dtype)
    else:
        print(f"[train] wavegan on {dev}, n_critic={cfg.n_critic}", flush=True)
        step = gan.make_wavegan_train_step(g, d, cfg)
        flat = loader.decode_extract_and_batch(
            fps, batch_size=args.batch_size * cfg.n_critic, slice_len=cfg.slice_len,
            seed=args.seed, out_dtype=args.h2d_dtype)
        # Each (n_critic·B, T) batch as (n_critic, B, T): one per critic.
        it = (b.reshape(cfg.n_critic, args.batch_size, cfg.slice_len) for b in flat)
    return harness.train_loop(
        step, gstate, dstate, loader.device_prefetch(it, dev, depth=2), args.train_dir,
        max_steps=args.max_steps, ckpt_every=args.ckpt_every, log_every=args.log_every,
        seed=args.seed, config=dataclasses.asdict(cfg),
    )


@torch.no_grad()
def infer(args) -> list[pathlib.Path]:
    """Writes sampled wavs (vocoded ones with ``--conditional``) with the
    latest checkpoint's generator (random init without one); returns their
    paths."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.train.gan import latents
    from advoc_tpu_torch.train.harness import restore_latest, train_device

    dev = train_device(args.device, args.n_devices)
    cfg = make_config(args)
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev, args.conditional)
    restore_latest(args.train_dir, {"g": gstate, "d": dstate})
    g.eval()
    out_dir = pathlib.Path(args.infer_dir or f"{args.train_dir}/infer")
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.conditional:
        named = [(f"neural_vocoded_{i}.wav", _vocode(g, cfg, mel))
                 for i, mel in enumerate(_infer_mels(args, cfg, dev))]
    else:
        wavs = g(latents(args.n_samples, cfg.latent_dim, args.seed, dev))
        named = [(f"generated_{i}.wav", w) for i, w in enumerate(wavs)]
    paths = []
    for name, wav in named:
        path = out_dir / name
        audioio.save_as_wav(wav.cpu().numpy(), path, cfg.sample_rate)
        print(f"[infer] wrote {path} ({wav.shape[-1]} samples)", flush=True)
        paths.append(path)
    return paths


def _infer_mels(args, cfg, device) -> list[torch.Tensor]:
    """The conditional infer's mels: a .npy of (T, n_mels) or (B, T, n_mels),
    else the mel of a wav (decoded at the config's rate; default a 2 s
    synthetic fixture)."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P

    if args.infer_input and args.infer_input.endswith(".npy"):
        mels = np.load(args.infer_input)
        mels = mels[None] if mels.ndim == 2 else mels
        return list(torch.tensor(np.asarray(mels, np.float32), device=device))
    wav = (audioio.decode_audio(args.infer_input, cfg.sample_rate) if args.infer_input
           else synthetic_speech(0, cfg.sample_rate * 2))
    return [spectral.waveform_to_r9y9_melspec(torch.tensor(wav, device=device), P)]


def _vocode(g, cfg, mel: torch.Tensor) -> torch.Tensor:
    """One (T, n_mels) mel through the conditional G in n_frames chunks (cut
    to whole chunks, or zero-padded to one): (T'·hop,) samples."""
    t = max((mel.shape[0] // cfg.n_frames) * cfg.n_frames, cfg.n_frames)
    m = mel.new_zeros((t, cfg.n_mels))
    m[: min(t, mel.shape[0])] = mel[:t]
    return g(m.reshape(-1, cfg.n_frames, cfg.n_mels)).reshape(-1)


def evaluate(args):
    """Polls the checkpoints: the generated audio's RMS and peak, or
    (conditional) the mel L1 of the vocoded eval audio against its mel;
    one sample as an audio summary. Returns the last step evaluated."""
    from advoc_tpu_torch.data import loader
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan, harness
    from advoc_tpu_torch.utils import ensure_dataset

    dev = harness.train_device(args.device, args.n_devices)
    cfg = make_config(args)
    fps = ensure_dataset(args.data_dir, f"{args.train_dir}/synthetic_data")

    def data_fn():
        return loader.decode_extract_and_batch(
            fps, batch_size=args.batch_size, slice_len=cfg.slice_len, repeat=False,
            drop_remainder=False, sample_rate=P.sample_rate if args.conditional else None)

    def mel_of(wav: torch.Tensor) -> torch.Tensor:
        return spectral.waveform_to_r9y9_melspec(wav, P)[:, : cfg.n_frames]

    if args.conditional:
        @torch.no_grad()
        def eval_fn(generator, batch):
            mel = mel_of(gan.as_waveform(torch.as_tensor(batch, device=dev)))
            return {"eval_mel_l1": torch.mean(torch.abs(mel_of(generator(mel)) - mel))}

        @torch.no_grad()
        def audio_fn(generator):
            wav = torch.tensor(synthetic_speech(123, cfg.slice_len), device=dev)
            out = generator(mel_of(wav[None]))
            return [("neural_vocoded", out[0].cpu().numpy(), cfg.sample_rate)]
    else:
        @torch.no_grad()
        def eval_fn(generator, batch):
            fake = generator(gan.latents(len(batch), cfg.latent_dim, 0, dev))
            return {"eval_gen_rms": torch.sqrt(torch.mean(fake**2)),
                    "eval_gen_peak": torch.max(torch.abs(fake))}

        @torch.no_grad()
        def audio_fn(generator):
            out = generator(gan.latents(1, cfg.latent_dim, 7, dev))
            return [("generated", out[0].cpu().numpy(), cfg.sample_rate)]

    return harness.eval_loop(
        eval_fn, lambda: _models_and_states(cfg, args.seed, dev, args.conditional)[2:],
        data_fn, args.train_dir, once=args.eval_once, audio_fn=audio_fn,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"train": train, "eval": evaluate, "infer": infer}[args.mode](args)


if __name__ == "__main__":
    main()
