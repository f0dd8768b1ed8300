"""Utilities (mirrors ``pixelwiseregression_tpu.utils``)."""
