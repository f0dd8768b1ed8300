"""Command-line entry points (mirrors ``pixelwiseregression_tpu/cli`` and the
JAX package's root scripts): ``python -m pixelwiseregression_tpu_torch.cli.<name>``
with ``check_dataset``, ``train``, ``train_msra``, ``test`` and ``test_msra``."""
