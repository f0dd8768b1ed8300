"""Command-line entry points (mirrors ``pixelwiseregression_tpu/cli`` and the
JAX package's root scripts): ``python -m pixelwiseregression_tpu_torch.cli.<name>``
with ``check_dataset``, ``train``, ``train_msra``, ``train_fullregression``,
``test``, ``test_msra``, ``test_fullregression``, and the viewers
``check_samples``, ``test_samples`` and ``get_sfr``."""
