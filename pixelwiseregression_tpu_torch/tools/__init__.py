"""The port's tools (each runs as ``python -m pixelwiseregression_tpu_torch.tools.<name>``):
the A/B and ablation tools over the port's kernels (mirrors of the JAX
package's ``tools/`` harnesses of K5 and K6), ``export_model``, which
freezes a checkpoint into a serving artifact, and the ports of the JAX
package's other tools: the profile tools (device time by model component
and direction, or by kernel, on ``profile_common``), the train-step and
forward A/Bs, ``headconv_bwd_split``, ``stage2_amplification``,
``check_data_layout`` and ``bench_http``."""
