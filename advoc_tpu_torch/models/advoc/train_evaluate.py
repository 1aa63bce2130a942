"""advoc train/eval/infer CLI of the port.

  python -m advoc_tpu_torch.models.advoc.train_evaluate --mode train \\
      --train_dir runs/advoc --data_dir /path/to/LJSpeech/wavs

  python -m advoc_tpu_torch.models.advoc.train_evaluate --mode eval \\
      --train_dir runs/advoc --data_dir ... [--eval_once]

  python -m advoc_tpu_torch.models.advoc.train_evaluate --mode infer \\
      --train_dir runs/advoc --infer_input mels.npy --infer_dir out/

The argparse surface of ``advoc_tpu.models.advoc.train_evaluate`` plus
``--device`` (default cuda; ``--device cpu`` runs on the CPU). Without
``--data_dir`` a synthetic fixture set is written into the train_dir.
``--data_placement hbm`` stages the corpus in the card's memory as int16
and gathers random crops on the device (the host sends 4 bytes a clip a
step); ``wire`` streams host-decoded batches (``--h2d_dtype``) copied
ahead from pinned memory; ``auto`` takes hbm when the corpus fits
``--hbm_budget_mb`` (default half the device's memory, as the JAX CLI's
8 GB of a 16 GB TPU).

Training is data-parallel over ``--n_devices`` ranks, one process a card
(default: every visible card that divides ``--batch_size``; one card is
one process), spawned by the CLI; ``--device cpu --n_devices N`` runs N
gloo ranks on the CPU; under torchrun each process joins as its rank.
``--batch_size`` is the global batch. Each rank stages the whole corpus
(hbm, refused when the ranks span hosts) or decodes only its rows of each
batch (wire). ``eval`` and ``infer`` run as one process.
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
    p.add_argument("--data_dir", default=None,
                   help="directory of wavs, or a .txt file list from scripts/prepare_dataset.py")
    p.add_argument("--model_size", choices=["full", "small"], default="full")
    p.add_argument("--model_overrides", default=None,
                   help="comma-separated key=value config overrides")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel device count (default: all that divide the batch)")
    p.add_argument("--eval_once", action="store_true")
    p.add_argument("--eval_timeout_s", type=float, default=3600.0,
                   help="eval mode: exit after this long without a new checkpoint")
    p.add_argument("--infer_input", default=None,
                   help=".npy of (T,80) or (B,T,80) mels, or a wav to re-vocode; "
                        "default: a synthetic fixture")
    p.add_argument("--infer_dir", default=None)
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--h2d_dtype", choices=["int16", "float32", "mulaw8"], default="int16",
                   help="wire dtype of train batches; int16 halves the host-to-device "
                        "bytes (lossless for PCM16 sources), the step normalizes on device")
    p.add_argument("--data_placement", choices=["auto", "hbm", "wire"], default="auto",
                   help="'hbm' stages the corpus in device memory as int16 and samples "
                        "crops on the device (batches equal to the int16 wire's at the "
                        "same seed); 'auto' takes hbm when it fits --hbm_budget_mb")
    p.add_argument("--hbm_budget_mb", type=int, default=None,
                   help="most corpus bytes to stage in device memory (default half "
                        "the device's memory; 8192 on the CPU)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): the first NaN of a "
                        "backward names its op (slow, for debugging)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def make_config(args):
    from advoc_tpu_torch.models.advoc.model import AdvocConfig, small_config
    from advoc_tpu_torch.utils import apply_overrides

    cfg = small_config() if args.model_size == "small" else AdvocConfig()
    return apply_overrides(cfg, args.model_overrides)


def _device(args) -> torch.device:
    from advoc_tpu_torch.train.harness import train_device

    return train_device(args.device)


def _models_and_states(cfg, seed: int, device: torch.device, group=None):
    from advoc_tpu_torch.models.advoc import AdvocGenerator, PatchDiscriminator
    from advoc_tpu_torch.train import gan

    g = AdvocGenerator(cfg).to(device)
    d = PatchDiscriminator(cfg).to(device)
    gstate, dstate = gan.make_states(g, d, seed=seed, group=group)
    return g, d, gstate, dstate


def _hbm_budget_bytes(args, device: torch.device) -> int:
    if args.hbm_budget_mb is not None:
        return args.hbm_budget_mb * 2**20
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return 8192 * 2**20


def train(args):
    """Returns the train loop's (gstate, dstate, final_step); with spawned
    data-parallel ranks, each rank's (gstate.step, dstate.step,
    final_step) (``harness.launch_training``)."""
    from advoc_tpu_torch.train import harness

    return harness.launch_training(_train, args)


def _train(args, group):
    """One rank's training (``group``: its data-parallel process group, or
    None alone)."""
    from advoc_tpu_torch.data import loader
    from advoc_tpu_torch.data.audioio import wav_num_frames
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.parallel import distributed
    from advoc_tpu_torch.train import gan, harness
    from advoc_tpu_torch.utils import ensure_dataset

    dev = _device(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = make_config(args)
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev, group)
    n_params = sum(p.numel() for p in g.parameters())
    n_ranks, main = distributed.world_size(), distributed.is_main()
    if main:
        print(f"[train] advoc {args.model_size}: G={n_params / 1e6:.2f}M params on {dev}"
              + (f", {n_ranks} data-parallel ranks" if n_ranks > 1 else ""), flush=True)
    step = gan.make_advoc_train_step(g, d, cfg, P)

    fps = distributed.main_first(ensure_dataset, args.data_dir,
                                 f"{args.train_dir}/synthetic_data")
    slice_len = cfg.n_frames * P.hop_length
    placement = args.data_placement
    if placement != "wire":
        est_bytes = sum(max(wav_num_frames(fp)[0], slice_len) * 2 for fp in fps)
        budget = _hbm_budget_bytes(args, dev)
        multi_host = distributed.spans_hosts()
        fits = est_bytes <= budget and not multi_host
        if placement == "hbm" and not fits:
            raise ValueError(
                f"--data_placement hbm: the corpus is {est_bytes / 2**20:.0f} MB (budget "
                f"{budget / 2**20:.0f} MB) or the run spans hosts; use wire or raise "
                "--hbm_budget_mb")
        placement = "hbm" if fits else "wire"
        if args.data_placement == "auto" and main:
            why = ("fits" if fits else "the run spans hosts" if multi_host
                   else f"{est_bytes / 2**20:.0f} MB > {budget / 2**20:.0f} MB budget")
            print(f"[train] data_placement auto → {placement} ({why})", flush=True)

    if placement == "hbm":
        # Every rank stages the whole corpus and draws the global starts;
        # data_parallel cuts them to the rank's rows.
        corpus = loader.DeviceCorpus(fps, slice_len, sample_rate=P.sample_rate, device=dev)
        if main:
            print(f"[train] corpus staged in device memory: {len(fps)} files, "
                  f"{corpus.nbytes / 2**20:.0f} MB int16", flush=True)
        step = loader.hbm_data_step(step, corpus)
        it = corpus.starts(args.batch_size, seed=args.seed)
        step = gan.data_parallel(step)
    else:
        it = loader.decode_extract_and_batch(  # each rank decodes only its rows
            fps, batch_size=args.batch_size, slice_len=slice_len, seed=args.seed,
            sample_rate=P.sample_rate, out_dtype=args.h2d_dtype,
            rows=harness.rank_rows(args.batch_size))
        it = loader.device_prefetch(it, dev, depth=2)
        step = gan.data_parallel(step, batch_axis=None)
    return harness.train_loop(
        step, gstate, dstate, it, args.train_dir, max_steps=args.max_steps,
        ckpt_every=args.ckpt_every, log_every=args.log_every, seed=args.seed,
        config=dataclasses.asdict(cfg),
    )


def evaluate(args):
    """Returns the last checkpoint step evaluated, or None."""
    from advoc_tpu_torch.data import loader
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train import gan, harness
    from advoc_tpu_torch.utils import ensure_dataset

    dev = _device(args)
    cfg = make_config(args)
    eval_step = gan.make_advoc_eval_step(cfg, P)
    fps = ensure_dataset(args.data_dir, f"{args.train_dir}/synthetic_data")
    slice_len = cfg.n_frames * P.hop_length
    fixture = torch.tensor(synthetic_speech(123, slice_len), device=dev)

    def data_fn():
        # drop_remainder=False: a small eval set still yields its last batch.
        return loader.decode_extract_and_batch(
            fps, batch_size=args.batch_size, slice_len=slice_len, repeat=False,
            drop_remainder=False, sample_rate=P.sample_rate)

    def audio_fn(generator):
        voc = Vocoder(generator, params=P, chunk_frames=cfg.n_frames, gl_iters=args.gl_iters,
                      device=dev)
        out = voc(spectral.waveform_to_r9y9_melspec(fixture, P))
        return [("vocoded", out.cpu().numpy(), P.sample_rate)]

    @torch.no_grad()
    def image_fn(generator):
        # Heuristic estimate / repaired / real, stacked (3·F, T), low bins at
        # the bottom of each band.
        _, est, real = gan.featurize_advoc(fixture[None], cfg.n_frames, P)
        fake = generator(est)
        img = np.concatenate([x[0].cpu().numpy().T[::-1] for x in (est, fake, real)], axis=0)
        return [("est_repaired_real", img)]

    return harness.eval_loop(
        lambda generator, batch: eval_step(generator, torch.as_tensor(batch, device=dev)),
        lambda: _models_and_states(cfg, args.seed, dev)[2:],
        data_fn, args.train_dir, once=args.eval_once, timeout_s=args.eval_timeout_s,
        audio_fn=audio_fn, image_fn=image_fn,
    )


def infer(args) -> list[pathlib.Path]:
    """Vocodes with the latest checkpoint's generator (random init without
    one); returns the wav paths written."""
    from advoc_tpu_torch.data import audioio
    from advoc_tpu_torch.data.synthetic import synthetic_speech
    from advoc_tpu_torch.infer import Vocoder
    from advoc_tpu_torch.ops import spectral
    from advoc_tpu_torch.ops.reference import DEFAULT_PARAMS as P
    from advoc_tpu_torch.train.checkpoint import CheckpointManager

    dev = _device(args)
    cfg = make_config(args)
    g, d, gstate, dstate = _models_and_states(cfg, args.seed, dev)
    mgr = CheckpointManager(args.train_dir)
    step = mgr.latest_step()
    if step is not None:
        mgr.restore(step, template={"g": gstate, "d": dstate})
        print(f"[infer] restored checkpoint step {step}", flush=True)
    else:
        print("[infer] no checkpoint found — using random init", flush=True)
    mgr.close()

    if args.infer_input and args.infer_input.endswith(".npy"):
        mels = np.load(args.infer_input)
        if mels.ndim == 2:
            mels = mels[None]
        mels = torch.tensor(np.asarray(mels, np.float32), device=dev)
    else:
        wav = (audioio.decode_audio(args.infer_input, P.sample_rate) if args.infer_input
               else synthetic_speech(0, P.sample_rate * 4))
        mels = spectral.waveform_to_r9y9_melspec(torch.tensor(wav, device=dev), P)[None]

    voc = Vocoder(g, params=P, chunk_frames=cfg.n_frames, gl_iters=args.gl_iters, device=dev)
    out_dir = pathlib.Path(args.infer_dir or f"{args.train_dir}/infer")
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, mel in enumerate(mels):
        wav_out = voc(mel).cpu().numpy()
        path = out_dir / f"vocoded_{i}.wav"
        audioio.save_as_wav(wav_out, path, P.sample_rate)
        print(f"[infer] wrote {path} ({len(wav_out)} samples)", flush=True)
        paths.append(path)
    return paths


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"train": train, "eval": evaluate, "infer": infer}[args.mode](args)


if __name__ == "__main__":
    main()
