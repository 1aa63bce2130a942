"""``python -m advoc_tpu_torch``: the port's overview and entry points."""

import textwrap


def main() -> None:
    import torch

    import advoc_tpu_torch

    if torch.cuda.is_available():
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                   for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu (no CUDA device: the entry points need --device cpu)"]
    print(textwrap.dedent(f"""\
        advoc_tpu_torch {advoc_tpu_torch.__version__}: advoc in PyTorch for NVIDIA Hopper
        torch {torch.__version__}, CUDA {torch.version.cuda}
        devices: {devices}

        Entry points (each runs on the card unless given --device cpu):
          python -m advoc_tpu_torch.models.advoc.train_evaluate      --mode train|eval|infer
          python -m advoc_tpu_torch.models.wavegan.train_evaluate    --mode train|eval|infer [--conditional]
          python -m advoc_tpu_torch.models.melspecgan.train_evaluate --mode train|eval|infer [--vocode]
          python -m advoc_tpu_torch.infer.vocode_cli                 --input mels.npy --out_dir out/
                                                         [--aot_export DIR | --aot DIR]
          python -m advoc_tpu_torch.serve                            [--selftest N | --soak SECONDS]
          python -m advoc_tpu_torch.parallel.mp_check                [--num_processes N]
          python chip_smoke.py                                       (every kernel and path, one card)

        Library: advoc_tpu_torch.ops.spectral (featurize, invert, recover phase),
        advoc_tpu_torch.Vocoder / StreamingVocoder, advoc_tpu_torch.infer.export
        (AOT artifacts), advoc_tpu_torch.train.eval_metrics, advoc_tpu_torch.utils
        (profiling, roofline). Kernels: advoc_tpu_torch/csrc (CUDA, built on first
        use). Docs: README.md, PERF.md."""))


if __name__ == "__main__":
    main()
