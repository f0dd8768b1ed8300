"""Whole-model A/B of the paired-heads inference path, in one process (the
port of the JAX package's ``tools/bench_paired_model.py``).

Each variant is the full-width model's inference forward (NYU: 14 joints,
128 features, level 4, ``instance_anchored`` with calibrated anchors,
bf16, K1 a stage) on ``bench.py``'s inputs at batch 256, built as a model
of its own from one state dict: ``off`` (the plain heads) and the four
paired forms ``mid/final`` (``models/paired_heads.py``):

  off            the two heads, each its own four convs
  sep/separate   conv_0 merged (2C outputs, one norm), conv_1..3 per head
  sep/blockdiag  ... and conv_3 as one block-diagonal conv
  grp/blockdiag  conv_1/2 as groups=2 convs, conv_3 block-diagonal
  grp/separate   conv_1/2 grouped, conv_3 per head

for stage 1 and stage 2 (``--stages`` restricts to one). The variants of a
stage count are timed in turns by ``tools/ab_common.py`` (CUDA events, the
median of the samples, ``spread_pct``), each beside the bound of its convs'
operations, with K1's launches checked. The JAX tool's in-jit ``lax.scan``
delta and ``--twice`` (a guard against window drift on a TPU) have no
counterpart: the turns already interleave the variants.

The JAX docstring's verdict is a v5e measurement; this tool gives the
card's answer to the same question.

Run: python -m pixelwiseregression_tpu_torch.tools.bench_paired_model
         [--batch 256] [--iters 4] [--rounds 3] [--stages 1|2] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant, conv_flops, make_inputs

VARIANTS = {"off": None, "sep/separate": ("separate", "separate"),
            "sep/blockdiag": ("separate", "blockdiag"), "grp/blockdiag": ("grouped", "blockdiag"),
            "grp/separate": ("grouped", "separate")}


def build_variants(batch: int, stages: int, device: torch.device, joints: int = 14,
                   features: int = 128, level: int = 4, seed: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The variants at ``stages``: one state dict from ``seed`` whose anchors
    are calibrated by one train-mode forward on the inputs (a trained
    model's anchors are calibrated), loaded into each variant's model."""
    inputs = make_inputs(batch, seed, device)
    kw = dict(stage=stages, features=features, level=level, norm_method="instance_anchored",
              decoder="cuda", dtype=dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        base = PixelwiseRegression(joints, **kw).to(device)
    with torch.no_grad():
        base.train()(*inputs)
    state = base.state_dict()
    flops = conv_flops(base) * batch
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    out = {}
    for name, pairing in VARIANTS.items():
        extra = {} if pairing is None else dict(paired_heads=True, paired_mid=pairing[0],
                                                paired_final=pairing[1])
        model = PixelwiseRegression(joints, **kw, **extra).to(device)
        model.load_state_dict(state)
        model.eval()
        assert all(b.use_paired() == (pairing is not None) for b in model.stages), name

        def forward(model=model):
            with torch.inference_mode():
                return model(*inputs)[-1][2]

        # the block-diagonal conv_3 multiplies its zero blocks too
        extra_flops = 0.0
        if pairing is not None and pairing[1] == "blockdiag":
            conv3 = model.stages[0].plane_regression.conv[9]
            extra_flops = (2 * 9 * conv3.in_channels * conv3.out_channels
                           * inputs[1].shape[-1] ** 2 * batch * stages)
        out[name] = Variant(forward, launches={"K1": stages},
                            bound_s=ab_common.bound_seconds(flops + extra_flops, 0, kind))
    return out


def main(argv=None) -> dict:
    ap = ab_common.parser(__doc__, batch=256, iters=4, rounds=3)
    ap.add_argument("--stages", type=int, choices=(1, 2), default=None,
                    help="one stage count (default: 1 and 2)")
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--level", type=int, default=4)
    args = ap.parse_args(argv)
    device = ab_common.pick_device(args.device)
    out = {}
    for stages in ([args.stages] if args.stages else [1, 2]):
        print(f"paired heads A/B, stage {stages}, [{args.batch},1,128,128] bf16 "
              f"instance_anchored, features {args.features}, level {args.level}:", flush=True)
        variants = build_variants(args.batch, stages, device, features=args.features,
                                  level=args.level)
        res = ab_common.run(variants, device, args.iters, args.rounds, args.batch)
        res["fps"] = {name: args.batch / (ms / 1e3) for name, ms in res["ms"].items()}
        for name, fps in res["fps"].items():
            print(f"  stage {stages} {name:14s} {fps:10.1f} frames/s "
                  f"({(res['ms']['off'] - res['ms'][name]) / res['ms']['off'] * 100:+.1f}% "
                  "vs off)", flush=True)
        del variants
        out[stages] = res
    return out


if __name__ == "__main__":
    main()
