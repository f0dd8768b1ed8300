"""The port's tools (each runs as ``python -m pixelwiseregression_tpu_torch.tools.<name>``):
the A/B and ablation tools over the port's kernels (mirrors of the JAX
package's ``tools/`` harnesses of K5 and K6) and ``export_model``, which
freezes a checkpoint into a serving artifact."""
