"""advoc in PyTorch for NVIDIA Hopper: the port of the JAX package ``advoc_tpu``.

The offline vocoder (:class:`advoc_tpu_torch.infer.Vocoder`) runs the pinv
heuristic estimate, the U-Net repair, the mel-consistency projection and
fast Griffin-Lim through a hand-written CUDA kernel. The package imports
torch and numpy only, never JAX or ``advoc_tpu``.
"""
