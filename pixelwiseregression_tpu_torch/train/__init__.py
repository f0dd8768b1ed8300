"""Training and evaluation steps (mirrors ``pixelwiseregression_tpu.train``)."""
