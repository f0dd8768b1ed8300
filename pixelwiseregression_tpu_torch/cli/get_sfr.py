"""The paper's figure of heatmaps and depth maps from checkpoint variants
(the port of the JAX package's root ``get_sfr.py``; reference CLI:
get_sfr.py, which sets alpha=0 / 0.5 / 1 NYU checkpoints side by side).

``maps`` preprocesses ``--num_samples`` test samples once (the port's
``Loader``, shuffled; the on-device preprocess) and runs, for each suffix
of ``--suffixes`` whose ``Model/<dataset>_<suffix>_<seed>`` (``.pt`` or
JAX ``.ckpt``) exists, the model's inference forward (K1 a stage under
``--decoder cuda``); a missing one is skipped with the JAX script's
message, and none at all stops the run. ``main`` draws the joints of
``--joints_to_show`` with matplotlib (Agg, imported where it draws) into
``--out``.

    python -m pixelwiseregression_tpu_torch.cli.get_sfr --data_path DIR \\
        [--suffixes detection mix regression] [--out Result/sfr.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from pixelwiseregression_tpu_torch.cli.common import resolve_device
from pixelwiseregression_tpu_torch.cli.test_samples import (add_model_args, load_model,
                                                             preprocess_config)
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source
from pixelwiseregression_tpu_torch.train.loop import model_inputs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", type=str, default="NYU")
    p.add_argument("--suffixes", type=str, nargs="+", default=["detection", "mix", "regression"],
                   help="checkpoint suffixes to compare")
    p.add_argument("--joints_to_show", type=int, nargs="+", default=[0, 3, 9])
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--out", type=str, default="Result/sfr.png")
    add_model_args(p)
    return p.parse_args(argv)


def _checkpoint(base: str):
    return next((os.path.join("Model", base + ext) for ext in (".pt", ".ckpt")
                 if os.path.exists(os.path.join("Model", base + ext))), None)


def maps(args):
    """``(data, rows)``: the preprocessed batch (numpy: ``img``,
    ``label_img``, ``mask`` NHWC ...) and, for each suffix found,
    ``(suffix, heatmaps, depthmaps)``, the last stage's maps as numpy
    ``[N, S, S, J]``. Raises ``SystemExit`` when no suffix has a
    checkpoint."""
    device = resolve_device(args)
    source = get_source(args.dataset, path=args.data_path, dataset="test", test_only=True)
    batch = next(iter(Loader(source, batch_size=args.num_samples, shuffle=True, num_workers=2)))
    batch.pop("count")
    data = preprocess_batch(to_device(batch, device), preprocess_config(source.spec, args),
                            test_only=True)
    rows = []
    for suffix in args.suffixes:
        base = f"{args.dataset}_{suffix}_{args.seed}"
        path = _checkpoint(base)
        if path is None:
            print(f"skipping {suffix}: no checkpoint {base}")
            continue
        model = load_model(args, source.joint_number, path, device)
        with torch.inference_mode():
            hm, dm, _ = model(*model_inputs(data))[-1]
        rows.append((suffix, *(t.float().permute(0, 2, 3, 1).cpu().numpy() for t in (hm, dm))))
    if not rows:
        raise SystemExit("no checkpoints found for any suffix")
    return {k: v.cpu().numpy() for k, v in data.items()}, rows


def main(argv=None) -> int:
    args = parse_args(argv)
    _, rows = maps(args)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_j = len(args.joints_to_show)
    fig, axes = plt.subplots(len(rows) * 2, args.num_samples * n_j,
                             figsize=(2 * args.num_samples * n_j, 4 * len(rows)), squeeze=False)
    for r, (suffix, hm, dm) in enumerate(rows):
        for s in range(args.num_samples):
            for k, j in enumerate(args.joints_to_show):
                col = s * n_j + k
                for row, (m, what) in enumerate(((hm, "hm"), (dm, "dm"))):
                    ax = axes[2 * r + row][col]
                    ax.imshow(m[s, :, :, j], cmap="jet")
                    ax.set_title(f"{suffix} {what} j{j}", fontsize=6)
                    ax.axis("off")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
