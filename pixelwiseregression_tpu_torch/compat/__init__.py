"""Weight interchange (mirrors ``pixelwiseregression_tpu.compat``)."""
