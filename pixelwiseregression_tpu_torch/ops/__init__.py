"""Image, heatmap and decoder ops (mirrors ``pixelwiseregression_tpu.ops``)."""
