"""Viewer of ground-truth against predicted skeletons from a checkpoint
(the port of the JAX package's root ``test_samples.py``; reference CLI:
test_samples.py).

``predictions`` loads ``Model/<dataset>_<suffix>_<seed>`` (a port ``.pt``,
or a JAX ``.ckpt``), runs the port's ``Loader`` (batch 1, shuffled), the
on-device preprocess and the model's inference forward (K1 a stage under
``--decoder cuda``) and yields each sample's preprocessed arrays with the
predicted normalized uvd; ``main`` draws ground truth | prediction side by
side with OpenCV, imported where it draws: a window ('q' quits, 's' saves
into ``--save_dir``), or with ``--headless`` every canvas saved there.

    python -m pixelwiseregression_tpu_torch.cli.test_samples --dataset NYU --data_path DIR \\
        --suffix default [--headless --max_samples 4 --save_dir Samples] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pixelwiseregression_tpu_torch.cli.common import model_kwargs_from_args, resolve_device
from pixelwiseregression_tpu_torch.cli.test_main import _find_model_file
from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint
from pixelwiseregression_tpu_torch.train.loop import model_inputs


def add_model_args(p: argparse.ArgumentParser):
    """The viewers' model flags (the JAX scripts' defaults) and the port's
    ``--device`` and ``--decoder``."""
    p.add_argument("--label_size", type=int, default=64)
    p.add_argument("--kernel_size", type=int, default=7)
    p.add_argument("--sigmoid", type=float, default=1.5)
    p.add_argument("--norm_method", type=str, default="instance")
    p.add_argument("--heatmap_method", type=str, default="softmax")
    p.add_argument("--filter_size", type=int, default=3)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--level", type=int, default=4)
    p.add_argument("--seed", type=str, default="final")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--decoder", type=str, default="cuda",
                   choices=["cuda", "torch", "pallas", "xla"])


def load_model(args, joints: int, path: str, device) -> PixelwiseRegression:
    """The flags' model (f32) with the checkpoint's weights, in eval mode on
    ``device``; TF32 off, as the test CLI runs."""
    tf32_off()
    model = PixelwiseRegression(**model_kwargs_from_args(args, joints))
    model.load_state_dict(load_checkpoint(path)["state_dict"])
    return model.to(device).eval()


def preprocess_config(spec, args) -> PreprocessConfig:
    cam = spec.camera
    return PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                            image_size=args.label_size * 2, label_size=args.label_size,
                            kernel_size=args.kernel_size, sigma=args.sigmoid)


def predictions(args):
    """Yield ``(source, data, uvd)``: a sample's preprocessed arrays (numpy,
    batch 1: ``img``, ``label_img``, ``mask``, ``uvd`` ...) and the model's
    last-stage normalized uvd ``[1, J, 3]``, at most ``--max_samples``."""
    device = resolve_device(args)
    kw = dict(path=args.data_path, dataset=args.set, test_only=False)
    if args.subject is not None:
        kw["subject"] = args.subject
    source = get_source(args.dataset, **kw)
    suffix = args.suffix if args.subject is None else f"{args.suffix}_subject{args.subject}"
    path = _find_model_file("Model", f"{args.dataset}_{suffix}_{args.seed}")
    model = load_model(args, source.joint_number, path, device)
    cfg = preprocess_config(source.spec, args)
    n = 0
    for batch in Loader(source, batch_size=1, shuffle=True, num_workers=1):
        batch.pop("count")
        with torch.inference_mode():
            data = preprocess_batch(to_device(batch, device), cfg)
            uvd = model(*model_inputs(data))[-1][2].float()
        yield source, {k: v.cpu().numpy() for k, v in data.items()}, uvd.cpu().numpy()
        n += 1
        if args.max_samples is not None and n >= args.max_samples:
            break


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--suffix", type=str, default="default")
    p.add_argument("--dataset", type=str, default="NYU", help="choose from MSRA, ICVL, NYU, HAND17")
    p.add_argument("--set", type=str, default="test", help="choose from train, val and test")
    p.add_argument("--subject", type=int, default=None)
    p.add_argument("--save_dir", type=str, default="Samples")
    p.add_argument("--max_samples", type=int, default=None, help="stop after N samples")
    p.add_argument("--headless", action="store_true",
                   help="no interactive window: save every sample canvas to --save_dir instead")
    add_model_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import cv2

    from pixelwiseregression_tpu_torch.utils.viz import draw_skeleton_normalized

    os.makedirs(args.save_dir, exist_ok=True)
    for idx, (source, data, uvd) in enumerate(predictions(args)):
        img = data["img"][0, :, :, 0]
        canvas = np.concatenate([draw_skeleton_normalized(img, data["uvd"][0], source.config),
                                 draw_skeleton_normalized(img, uvd[0], source.config)], axis=1)
        out = os.path.join(args.save_dir, f"sample_{idx}.png")
        if args.headless:
            cv2.imwrite(out, (canvas[:, :, ::-1] * 255).astype(np.uint8))
            continue
        cv2.imshow("gt | prediction (q quit, s save)", canvas[:, :, ::-1])
        k = cv2.waitKey(0) & 0xFF
        if k == ord("q"):
            break
        if k == ord("s"):
            cv2.imwrite(out, (canvas[:, :, ::-1] * 255).astype(np.uint8))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
