"""Training-side modules of the port; so far the inference bundles."""

from advoc_tpu_torch.train.checkpoint import export_inference_bundle, load_inference_bundle

__all__ = ["export_inference_bundle", "load_inference_bundle"]
