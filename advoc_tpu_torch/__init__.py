"""advoc in PyTorch for NVIDIA Hopper: the port of the JAX package ``advoc_tpu``.

The offline vocoder (:class:`advoc_tpu_torch.infer.Vocoder`) runs the pinv
heuristic estimate, the U-Net repair, the mel-consistency projection and
fast Griffin-Lim through a hand-written CUDA kernel. The streaming engine
(:class:`advoc_tpu_torch.infer.StreamingVocoder`) serves many streams per
push behind a TCP server (``python -m advoc_tpu_torch.serve``); the offline
CLI is ``python -m advoc_tpu_torch.infer.vocode_cli``. The advoc GAN trains
with ``python -m advoc_tpu_torch.models.advoc.train_evaluate``; the WaveGAN
(and its mel-conditioned variant) and MelSpecGAN families with
``python -m advoc_tpu_torch.models.{wavegan,melspecgan}.train_evaluate``,
whose melspecgan infer vocodes its samples through an advoc run. Each
CLI trains data-parallel over ``--n_devices`` ranks, and both vocoders
split their batch over a device mesh (:mod:`advoc_tpu_torch.parallel`).
The package imports torch, numpy and scipy only, never JAX or
``advoc_tpu``.
"""
