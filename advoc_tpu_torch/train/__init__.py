"""Training of the port: the GAN steps of every family (:mod:`.gan`),
checkpoints and inference bundles (:mod:`.checkpoint`), summaries
(:mod:`.metrics`), evaluation metrics (:mod:`.eval_metrics`) and the train
and eval loops (:mod:`.harness`)."""

from advoc_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_inference_bundle,
    load_inference_bundle,
)

__all__ = ["CheckpointManager", "export_inference_bundle", "load_inference_bundle"]
