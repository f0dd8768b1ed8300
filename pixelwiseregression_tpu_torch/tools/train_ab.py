"""The train step under each norm form, timed in turns in one process (the
port of the JAX package's ``tools/train_ab.py``).

Each form is a first-class model config (``--norms``, the JAX tool's
``instance,instance_fast,batch``) in the JAX tool's step
(``ab_common.train_step_call``: raw 480x640 frames, augmentation, the
2-stage model in bf16, AdamW), one state each, sampled in turns by
``tools/ab_common.py`` (CUDA events; the JAX tool's scan-N minus scan-1
delta has no counterpart). With the kernel decoder each step launches K1
and K2 once a stage, which ``ab_common.run`` checks. ``--batches`` sweeps
batch sizes (each a run of its own), ``--decoders`` the decoders. Each
variant's bound is the step's conv operations (three times the forward's,
``ab_common.conv_flops``) over the bf16 peak.

Run: python -m pixelwiseregression_tpu_torch.tools.train_ab
         [--batch 128] [--batches 96,128] [--norms instance,instance_fast,batch]
         [--iters 6] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

from pixelwiseregression_tpu_torch.cli.common import DECODERS
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.tools.ab_common import Variant


def step_variant(device, batch: int, args, norm: str, decoder: str, remat: bool = False):
    """One train step of its own state as a ``Variant``: K1 and K2 a stage
    with the kernel decoder (K1 twice under remat: the recompute runs it),
    bounded by three times the forward's conv operations."""
    call, model = ab_common.train_step_call(device, batch, args.joints, args.stages,
                                            args.features, args.level, norm, "bf16", decoder,
                                            remat=remat)
    k = args.stages if DECODERS[decoder] == "cuda" else 0
    return Variant(call, launches={"K1": k * (2 if remat else 1), "K2": k, "K2_kernels": k},
                   bound_s=ab_common.bound_seconds(3 * ab_common.conv_flops(model) * batch, 0))


def parse_args(argv=None):
    ap = ab_common.parser(__doc__, batch=128, iters=6, rounds=3)
    ap.add_argument("--batches", type=str, default=None,
                    help="comma list of batch sizes, each a run of its own")
    ap.add_argument("--decoders", type=str, default=None, help="comma list, e.g. cuda,torch")
    ap.add_argument("--norms", type=str, default="instance,instance_fast,batch")
    ab_common.model_args(ap, None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = ab_common.pick_device(args.device)
    batches = [int(b) for b in args.batches.split(",")] if args.batches else [args.batch]
    decoders = args.decoders.split(",") if args.decoders else [args.decoder]
    out = {}
    for b in batches:
        variants = {f"{dec}/{norm}": step_variant(device, b, args, norm, dec)
                    for dec in decoders for norm in args.norms.split(",")}
        print(f"train step A/B, batch {b}, stages {args.stages}, bf16:", flush=True)
        res = ab_common.run(variants, device, args.iters, args.rounds, b)
        for name, ms in res["ms"].items():
            dec, norm = name.split("/")
            print(f"  batch={b:4d} decoder={dec:7s} {norm:16s} {ms:7.1f} ms/step  "
                  f"{b / ms * 1e3:7.1f} frames/s", flush=True)
        out[b] = res
        del variants
    return out


if __name__ == "__main__":
    main()
