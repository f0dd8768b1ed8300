"""Models (mirrors ``pixelwiseregression_tpu.models``)."""
