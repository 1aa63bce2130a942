"""Hand-written CUDA kernels (sources in ``advoc_tpu_torch/csrc``), each
beside its plain PyTorch version."""
