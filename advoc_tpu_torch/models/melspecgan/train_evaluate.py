"""MelSpecGAN train/eval/infer CLI of the port.

  python -m advoc_tpu_torch.models.melspecgan.train_evaluate --mode train \\
      --train_dir runs/melspecgan --data_dir /path/to/wavs

  python -m advoc_tpu_torch.models.melspecgan.train_evaluate --mode eval \\
      --train_dir runs/melspecgan --data_dir ... [--eval_once]

  python -m advoc_tpu_torch.models.melspecgan.train_evaluate --mode infer \\
      --train_dir runs/melspecgan --vocode [--advoc_ckpt runs/advoc]

The unconditional mel-spectrogram GAN. infer samples mels into
``mels.npy`` and, with ``--vocode``, turns them into wavs through the
port's ``Vocoder``: the heuristic pipeline in 64-frame chunks, or with
``--advoc_ckpt`` the ``AdvocGenerator`` of a port advoc training run (its
latest checkpoint, its config from the run's ``config.json`` unless
``--advoc_model_size``/``--advoc_overrides`` say otherwise), the paper's
melspecgan → advoc unconditional-speech pipeline; on the card G-L runs the
tensor-core kernel. It prints the mel L1 of each vocoded wav's re-extracted
mel against its sampled mel. eval scores the samples' distribution
(``melspec_moment_panel``) and the trained D's logit gap, real − fake.

The argparse surface of ``advoc_tpu.models.melspecgan.train_evaluate`` plus
``--device`` (default cuda; ``--device cpu`` runs on the CPU). Latents come
from ``torch.Generator``\\ s, so samples are repeatable but are not the JAX
CLI's. ``--n_devices`` > 1 and multi-process runs raise (ROADMAP.md queue A
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
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel device count: only 1 is ported (ROADMAP.md queue A)")
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--eval_once", action="store_true")
    p.add_argument("--vocode", action="store_true",
                   help="also vocode the sampled mels to wavs (heuristic, or through a "
                        "trained advoc generator with --advoc_ckpt)")
    p.add_argument("--advoc_ckpt", default=None,
                   help="train_dir of a port advoc training run whose generator vocodes "
                        "the sampled mels")
    p.add_argument("--advoc_model_size", choices=["full", "small"], default=None,
                   help="the advoc generator's size (default: the run's config.json, "
                        "else full)")
    p.add_argument("--advoc_overrides", default=None,
                   help="config overrides of the advoc generator (default: the run's "
                        "config.json)")
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--infer_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--h2d_dtype", choices=["int16", "float32", "mulaw8"], default="int16",
                   help="wire dtype of train batches; int16 halves the host-to-device "
                        "bytes, the step normalizes on device")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): the first NaN of a "
                        "backward names its op (slow, for debugging)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def make_config(args):
    from advoc_tpu_torch.models.melspecgan import MelSpecGANConfig
    from advoc_tpu_torch.utils import apply_overrides

    return apply_overrides(MelSpecGANConfig(), args.model_overrides)


def _models_and_states(cfg, seed: int, device):
    """The JAX CLI's models and Adams, (1e-4, 0.5, 0.9) for both."""
    from advoc_tpu_torch.models.melspecgan import MelSpecGANDiscriminator, MelSpecGANGenerator
    from advoc_tpu_torch.train import gan

    g = MelSpecGANGenerator(cfg).to(device)
    d = MelSpecGANDiscriminator(cfg).to(device)
    gstate, dstate = gan.make_states(g, d, seed=seed, g_tx=gan.adam(1e-4, 0.5, 0.9),
                                     d_tx=gan.adam(1e-4, 0.5, 0.9))
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
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev)
    print(f"[train] melspecgan on {dev}, n_critic={cfg.n_critic}", flush=True)
    step = gan.make_melspecgan_train_step(g, d, cfg, P)
    fps = ensure_dataset(args.data_dir, f"{args.train_dir}/synthetic_data")
    slice_len = cfg.n_frames * P.hop_length
    flat = loader.decode_extract_and_batch(
        fps, batch_size=args.batch_size * cfg.n_critic, slice_len=slice_len, seed=args.seed,
        sample_rate=P.sample_rate, out_dtype=args.h2d_dtype)
    # Each (n_critic·B, L) batch as (n_critic, B, L): one per critic.
    it = (b.reshape(cfg.n_critic, args.batch_size, slice_len) for b in flat)
    return harness.train_loop(
        step, gstate, dstate, loader.device_prefetch(it, dev, depth=2), args.train_dir,
        max_steps=args.max_steps, ckpt_every=args.ckpt_every, log_every=args.log_every,
        seed=args.seed, config=dataclasses.asdict(cfg),
    )


def make_vocoder(args, device):
    """(the ``--vocode`` Vocoder on ``device``, its description): heuristic
    in the config's n_frames chunks, or the ``--advoc_ckpt`` run's latest
    generator in its own chunks. Raises ``FileNotFoundError`` when that run
    has no checkpoint."""
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.checkpoint import load_train_generator

    if args.advoc_ckpt is None:
        return (Vocoder(params=P, chunk_frames=make_config(args).n_frames,
                        gl_iters=args.gl_iters, device=device), "heuristic")
    gen, step = load_train_generator(args.advoc_ckpt, args.advoc_model_size,
                                     args.advoc_overrides)
    voc = Vocoder(gen, params=P, chunk_frames=gen.cfg.n_frames, gl_iters=args.gl_iters,
                  device=device)
    return voc, f"advoc step {step}"


@torch.no_grad()
def infer(args) -> dict:
    """Samples ``--n_samples`` mels into ``mels.npy`` and, with ``--vocode``,
    vocodes them. Returns {"mels": path, "wavs": paths, "mel_l1": the
    per-sample re-extracted mel L1s} (no wavs nor L1s without ``--vocode``)."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.gan import latents
    from advoc_tpu_torch.train.harness import restore_latest, train_device

    dev = train_device(args.device, args.n_devices)
    cfg = make_config(args)
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev)
    restore_latest(args.train_dir, {"g": gstate, "d": dstate})
    mels = g.eval()(latents(args.n_samples, cfg.latent_dim, args.seed, dev))
    out_dir = pathlib.Path(args.infer_dir or f"{args.train_dir}/infer")
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {"mels": out_dir / "mels.npy", "wavs": [], "mel_l1": []}
    np.save(out["mels"], mels.cpu().numpy())
    print(f"[infer] wrote {out['mels']} {tuple(mels.shape)}", flush=True)
    if not args.vocode:
        return out
    voc, desc = make_vocoder(args, dev)
    wavs = voc(mels)
    # Quality: the vocoded audio's re-extracted mel against the sampled mel.
    re_mel = spectral.waveform_to_r9y9_melspec(wavs, P)
    t = min(re_mel.shape[1], mels.shape[1])
    per_sample = torch.mean(torch.abs(re_mel[:, :t] - mels[:, :t]), dim=(1, 2)).cpu().numpy()
    out["mel_l1"] = per_sample.tolist()
    print(f"[infer] vocoder: {desc}; re-extracted mel L1 mean={per_sample.mean():.4f} "
          f"per-sample={[round(float(v), 4) for v in per_sample]}", flush=True)
    for i, w in enumerate(wavs.cpu().numpy()):
        path = out_dir / f"unconditional_{i}.wav"
        audioio.save_as_wav(w, path, P.sample_rate)
        print(f"[infer] wrote {path}", flush=True)
        out["wavs"].append(path)
    return out


def evaluate(args):
    """Polls the checkpoints: the moment panel of generated against real
    mels and the trained D's scores of both (``eval_d_margin`` = mean
    D(real) − mean D(fake)); one sampled mel as an image summary. Returns
    the last step evaluated."""
    from advoc_tpu_torch.data import loader
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan, harness
    from advoc_tpu_torch.train.eval_metrics import melspec_moment_panel
    from advoc_tpu_torch.utils import ensure_dataset

    dev = harness.train_device(args.device, args.n_devices)
    cfg = make_config(args)
    fps = ensure_dataset(args.data_dir, f"{args.train_dir}/synthetic_data")

    def data_fn():
        return loader.decode_extract_and_batch(
            fps, batch_size=args.batch_size, slice_len=cfg.n_frames * P.hop_length,
            repeat=False, drop_remainder=False, sample_rate=P.sample_rate)

    @torch.no_grad()
    def eval_fn(bundle, batch):
        g, d = bundle["g"].model.eval(), bundle["d"].model
        wav = gan.as_waveform(torch.as_tensor(batch, device=dev))
        real = spectral.waveform_to_r9y9_melspec(wav, P)[:, : cfg.n_frames]
        fake = g(gan.latents(len(batch), cfg.latent_dim, 0, dev))
        m = melspec_moment_panel(real, fake)
        m["eval_d_real"], m["eval_d_fake"] = d(real).mean(), d(fake).mean()
        m["eval_d_margin"] = m["eval_d_real"] - m["eval_d_fake"]
        return m

    @torch.no_grad()
    def image_fn(generator):
        mel = generator(gan.latents(1, cfg.latent_dim, 7, dev))
        return [("generated_mel", mel[0].cpu().numpy().T[::-1])]

    return harness.eval_loop(
        eval_fn, lambda: _models_and_states(cfg, args.seed, dev)[2:], data_fn, args.train_dir,
        once=args.eval_once, image_fn=image_fn, eval_takes_bundle=True,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"train": train, "eval": evaluate, "infer": infer}[args.mode](args)


if __name__ == "__main__":
    main()
