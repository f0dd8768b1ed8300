"""Export a trained checkpoint as a self-contained serving artifact
(``serve_artifact.py``; counterpart of the root ``tools/export_model.py``).

    python -m pixelwiseregression_tpu_torch.tools.export_model \\
        --ckpt Model/NYU_default_final.pt --dataset NYU --output nyu.pwrsrv --batch_size 32

The artifact holds the weights and the whole on-device serving function
(preprocess + model + the K1 decoder operator + uvd recovery) as a
``torch.export`` program, traced on ``--device`` (the card by default;
``--device cpu`` without one). Load it with ``ServingArtifact.load`` or
serve it with ``python -m pixelwiseregression_tpu_torch.serve_http
--artifact``: no model code and no checkpoint are needed there.
``--quant int8_static[...]`` calibrates the scales on ``--calib_npz``'s
frames before the freeze.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="port or reference .pt, or JAX .ckpt")
    p.add_argument("--dataset", required=True, choices=["MSRA", "ICVL", "NYU", "HAND17"])
    p.add_argument("--output", required=True, help="artifact path (.pwrsrv)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="trace and place the program on the card (default) or the CPU; "
                        "ServingArtifact.load can move it to the other")
    p.add_argument("--poly_batch", action="store_true",
                   help="symbolic batch dimension: any request size, no padding")
    p.add_argument("--quant", default="none",
                   help="int8[_static][_all|_heads]; a static mode needs --calib_npz")
    p.add_argument("--calib_npz",
                   help="npz with frames[N,H,W], coms[N,3] (and optional cubes[N]) run "
                        "through predict() to calibrate static int8 scales before export")
    # architecture flags; a checkpoint's model_param overrides them
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--level", type=int, default=4)
    p.add_argument("--label_size", type=int, default=64)
    p.add_argument("--norm_method", default="instance")
    p.add_argument("--fullregression", action="store_true",
                   help="--ckpt is a FullRegression checkpoint (no decoder: the program "
                        "calls no kernel)")
    args = p.parse_args(argv)
    static = "static" in args.quant
    if static and not args.calib_npz:
        p.error("--quant int8_static needs --calib_npz calibration data")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is visible (pass --device cpu to export on "
                "the CPU)")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")

    from pixelwiseregression_tpu_torch.serve import Predictor
    from pixelwiseregression_tpu_torch.serve_artifact import export_artifact

    pred = Predictor.from_checkpoint(
        args.ckpt, args.dataset, device, batch_size=args.batch_size, stages=args.stages,
        features=args.features, level=args.level, label_size=args.label_size,
        norm_method=args.norm_method, quant=None if args.quant == "none" else args.quant,
        fullregression=args.fullregression)
    if static:
        d = np.load(args.calib_npz)
        frames, coms = d["frames"], d["coms"]
        cubes = d["cubes"] if "cubes" in d else None
        if len(frames) == 0:
            p.error(f"--calib_npz {args.calib_npz} holds zero frames: refusing to bake "
                    "uncalibrated (all-zero) int8 scales")
        bs = args.batch_size
        for i in range(0, len(frames), bs):
            if pred.calib_left <= 0:
                break
            pred.predict(frames[i:i + bs], coms[i:i + bs],
                         None if cubes is None else cubes[i:i + bs])
        pred.calib_left = 0  # freeze whatever the data calibrated

    header = export_artifact(pred, args.output, poly_batch=args.poly_batch)
    size = os.path.getsize(args.output)
    print(f"wrote {args.output} ({size / 1e6:.1f} MB) device={header['device']} "
          f"dataset={header['dataset']} batch={header['batch_size']} format={header['format']}")


if __name__ == "__main__":
    main()
