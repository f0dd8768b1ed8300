"""Viewer of processed samples, their masks and skeletons (the port of the
JAX package's root ``check_samples.py``; reference CLI: check_samples.py).

``samples`` runs the port's ``Loader`` (batch 1, shuffled) and the
on-device preprocess (augmented by the ``--using_*`` flags on the train
set, from a generator seeded with 0) and yields each sample's crop, mask
and normalized uvd as numpy arrays; ``main`` shows them with matplotlib,
imported where it draws (under the Agg backend ``plt.show()`` returns at
once). ``--max_samples`` stops after N samples.

    python -m pixelwiseregression_tpu_torch.cli.check_samples --dataset NYU --data_path DIR \\
        [--set train|test] [--using_rotation] [--max_samples 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from pixelwiseregression_tpu_torch.cli.common import resolve_device
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", type=str, default="MSRA",
                   help="choose from MSRA, ICVL, NYU, HAND17")
    p.add_argument("--set", type=str, default="train", help="choose from train and test")
    p.add_argument("--using_rotation", action="store_true")
    p.add_argument("--using_scale", action="store_true")
    p.add_argument("--using_shift", action="store_true")
    p.add_argument("--using_flip", action="store_true")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--max_samples", type=int, default=None,
                   help="stop after N samples (headless smoke runs)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def samples(args):
    """Yield ``(source, {"img": [S, S], "mask": [L, L], "uvd": [J, 3] or
    None})`` for each sample (numpy; uvd normalized, None on the test set),
    at most ``--max_samples``."""
    device = resolve_device(args)
    test_only = args.set == "test"
    source = get_source(args.dataset, path=args.data_path, dataset=args.set, test_only=test_only)
    cam = source.spec.camera
    cfg = PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                           using_rotation=args.using_rotation, using_scale=args.using_scale,
                           using_shift=args.using_shift, using_flip=args.using_flip)
    gen = torch.Generator(device=device).manual_seed(0)
    shown = 0
    for batch in Loader(source, batch_size=1, shuffle=True, num_workers=1):
        batch.pop("count")
        out = preprocess_batch(to_device(batch, device), cfg, test_only=test_only,
                               augment=not test_only, generator=gen)
        yield source, {"img": out["img"][0, :, :, 0].cpu().numpy(),
                       "mask": out["mask"][0, :, :, 0].cpu().numpy(),
                       "uvd": None if test_only else out["uvd"][0].cpu().numpy()}
        shown += 1
        if args.max_samples is not None and shown >= args.max_samples:
            break


def main(argv=None) -> int:
    import matplotlib.pyplot as plt

    from pixelwiseregression_tpu_torch.utils.viz import draw_skeleton_normalized

    args = parse_args(argv)
    for source, s in samples(args):
        if s["uvd"] is not None:
            _, ax = plt.subplots()
            ax.imshow(draw_skeleton_normalized(s["img"], s["uvd"], source.config))
        _, ax = plt.subplots()
        ax.imshow(s["img"])
        _, ax = plt.subplots()
        ax.imshow(s["mask"])
        plt.show()
        plt.close("all")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
