"""Camera geometry (mirrors ``pixelwiseregression_tpu.core``)."""
