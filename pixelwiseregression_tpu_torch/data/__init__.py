"""Host records, batching and on-device preprocessing (mirrors ``pixelwiseregression_tpu.data``)."""
