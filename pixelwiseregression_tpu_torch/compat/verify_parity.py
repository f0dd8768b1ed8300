"""Checkpoint-parity gate: the reference torch model vs the port's model
(counterpart of ``pixelwiseregression_tpu/compat/verify_parity.py``, with the
port in place of the flax model).

A released reference ``.pt`` must give per-joint outputs within 0.1 mm of
the reference model's. This tool loads the same ``.pt`` into the reference
model (imported from the reference checkout, ``--reference``) and into the
port's ``PixelwiseRegression`` (which carries the reference's state-dict
names, so the file loads natively), runs both on the CPU in f32 on the same
inputs and reports the worst per-joint delta in millimetres.

    python -m pixelwiseregression_tpu_torch.compat.verify_parity \\
        --ckpt Model/NYU_default_final.pt --dataset NYU --reference DIR \\
        [--data_path DIR]

With ``--data_path`` the inputs are real test samples (the port's
``Loader`` and on-device preprocessing, on the CPU); otherwise synthetic
crops, as the JAX tool makes them. uv deltas convert to mm through the
sample's box size and the camera's focal length at the hand's depth, depth
deltas through the cube size. Exit code 0 passes the gate, 1 fails it, 2
when no ``--reference`` is given or its model cannot be imported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pixelwiseregression_tpu_torch.core.precision import tf32_off

def _last_uvd(out) -> np.ndarray:
    """The last stage's uvd of a model's output list (a (heatmaps, depthmaps,
    uvd) tuple, or the uvd itself), as f32 numpy."""
    last = out[-1]
    uvd = last[2] if isinstance(last, (tuple, list)) else last
    if isinstance(uvd, torch.Tensor):
        uvd = uvd.detach().cpu().float().numpy()
    return np.asarray(uvd, np.float32)


def compare(reference, port_model, img, label, mask):
    """Run the ``reference`` callable and ``port_model`` on the same NCHW f32
    tensors; returns ``(port - reference, reference uvd, port uvd)`` of the
    last stage, in normalized units (``to_mm`` converts)."""
    with torch.no_grad():
        ref = _last_uvd(reference(img, label, mask))
        got = _last_uvd(port_model(img, label, mask))
    return got - ref, ref, got


def to_mm(d, box, depth, cube, fx: float, fy: float):
    """Normalized uvd deltas ``[N, J, 3]`` -> per-joint |du|, |dv|, |dd| in mm:
    uv * (box - 1) px * depth / focal, d * cube (the JAX tool's arithmetic)."""
    du = np.abs(d[:, :, 0]) * (box[:, None] - 1) * depth[:, None] / float(fx)
    dv = np.abs(d[:, :, 1]) * (box[:, None] - 1) * depth[:, None] / float(fy)
    dd = np.abs(d[:, :, 2]) * cube[:, None]
    return du, dv, dd


def _inputs(args, spec):
    """NCHW f32 img, label and mask and each sample's box, cube and depth."""
    ims, n = args.label_size * 2, args.samples
    if args.data_path:
        from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
        from pixelwiseregression_tpu_torch.data.preprocess import (
            PreprocessConfig,
            preprocess_batch,
        )
        from pixelwiseregression_tpu_torch.data.sources import get_source

        src = get_source(args.dataset, path=args.data_path, dataset="test", test_only=True)
        batch = next(iter(Loader(src, batch_size=n, num_workers=4)))
        batch.pop("count")
        batch.pop("weight", None)
        cam = spec.camera
        cfg = PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                               image_size=ims, label_size=args.label_size)
        with torch.no_grad():
            data = preprocess_batch(to_device(batch, "cpu"), cfg, test_only=True)
        img, label, mask = (data[k][..., 0].unsqueeze(1).float()
                            for k in ("img", "label_img", "mask"))
        box, cube = data["box_size"].numpy(), data["cube"].numpy()
        depth = data["com"][:, 2].numpy()
        return img, label, mask, box, cube, depth
    # synthetic full-variance inputs (the JAX tool's): low-variance inputs
    # through an untrained net leave the instance norms nearly degenerate
    rng = np.random.RandomState(0)
    img = rng.randn(n, ims, ims, 1).astype(np.float32) * 0.3
    label = img[:, ::2, ::2]
    mask = (rng.rand(n, ims // 2, ims // 2, 1) > 0.4).astype(np.float32)
    nchw = [torch.from_numpy(np.ascontiguousarray(a[..., 0])).unsqueeze(1)
            for a in (img, label, mask)]
    return (*nchw, np.full(n, 180.0), np.full(n, float(spec.cube_size)), np.full(n, 600.0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    p.add_argument("--dataset", default="NYU", help="MSRA, ICVL, NYU, HAND17")
    p.add_argument("--data_path", default=None)
    p.add_argument("--reference", required=True,
                   help="the reference checkout, whose model.py defines the torch model")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--level", type=int, default=4)
    p.add_argument("--label_size", type=int, default=64)
    p.add_argument("--norm_method", default="instance")
    p.add_argument("--heatmap_method", default="softmax")
    p.add_argument("--filter_size", type=int, default=3)
    p.add_argument("--threshold_mm", type=float, default=0.1)
    args = p.parse_args(argv)

    sys.path.insert(0, args.reference)
    try:
        import model as ref_model
    except ImportError:
        print(f"reference torch implementation not importable from {args.reference}; aborting")
        return 2

    from pixelwiseregression_tpu_torch.data.sources import SPECS
    from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression

    spec = SPECS[args.dataset]
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    for ours, ref in [("stages", "stage"), ("features", "features"), ("level", "level"),
                      ("label_size", "label_size"), ("norm_method", "norm_method"),
                      ("heatmap_method", "heatmap_method"), ("filter_size", "kernel_size")]:
        if ref in (ckpt.get("model_param") or {}):
            setattr(args, ours, ckpt["model_param"][ref])

    tf32_off()
    tm = ref_model.PixelwiseRegression(
        spec.joint_number, stage=args.stages, label_size=args.label_size,
        features=args.features, level=args.level, norm_method=args.norm_method,
        heatmap_method=args.heatmap_method, kernel_size=args.filter_size)
    tm.load_state_dict(ckpt["state_dict"])
    tm.eval()
    pm = PixelwiseRegression(spec.joint_number, stage=args.stages, features=args.features,
                             level=args.level, kernel_size=args.filter_size,
                             norm_method=args.norm_method, heatmap_method=args.heatmap_method,
                             decoder="torch")
    # the reference's plane head also stores its constant COM filter
    pm.load_state_dict({k: v for k, v in ckpt["state_dict"].items() if not k.endswith(".filter")})
    pm.eval()

    img, label, mask, box, cube, depth = _inputs(args, spec)
    d, _, _ = compare(tm, pm, img, label, mask)
    du, dv, dd = to_mm(d, box, depth, cube, spec.camera.fx, spec.camera.fy)
    worst = max(du.max(), dv.max(), dd.max())
    print(f"samples: {len(d)}   per-joint deltas (mm): "
          f"u max {du.max():.5f}  v max {dv.max():.5f}  d max {dd.max():.5f}")
    print(f"worst per-joint delta: {worst:.5f} mm  "
          f"({'PASS' if worst <= args.threshold_mm else 'FAIL'} vs {args.threshold_mm} mm gate)")
    return 0 if worst <= args.threshold_mm else 1


if __name__ == "__main__":
    raise SystemExit(main())
