"""The A/B and ablation tools over the port's kernels (mirrors the JAX
package's ``tools/`` harnesses of K5 and K6); each runs as
``python -m pixelwiseregression_tpu_torch.tools.<name>``."""
